"""Host spans, counters and device marks recorded inside the port, on one
clock (the profiler family's recorder that needs no CUPTI: a replayed CUDA
graph runs as it does untraced).

    with profiler.spans(device) as rec:
        train_niti(...)               # or any loop of compiled steps
    rec.write_chrome("trace.json")   # Perfetto / chrome://tracing

The program opens :func:`span` and calls :func:`count` where its work
happens (data/loader.py, data/native.py, train/step_graph.py). Recording is
off by default: a span site then costs one check of a module global and
returns a shared no-op context, and a counter site the same check; no
allocation, no device work, no lock.

While :func:`spans` is open, each span records its name, thread, start and
end (`time.perf_counter_ns`), its parent (the span open on the same thread
when it opened) and the step id (the count of ``step.call`` spans opened so
far). A span's `device()` block marks its device work: a timing CUDA
event on the current stream when its first such block begins and another
when its last one ends. The call site puts the block around the device
operations alone, so host work inside the span (pinning a batch) does not
count as device time.

The clock: on entry and on exit, :func:`spans` synchronises the device,
records an anchor event, spins until it completes and reads the host
clock. A device mark resolves to host nanoseconds by the linear map between
the two anchors (`_ClockMap`), so a drift between the two clocks over the
recording is taken out; the record keeps that drift.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

STEP = "step.call"


class Span(NamedTuple):
    id: int
    name: str
    thread: str
    parent: Optional[int]
    step: int
    start_ns: int
    end_ns: int


class Interval(NamedTuple):
    """The device time of span `span` (`name`): from its first device mark
    to its last, on the host clock."""

    span: int
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Record:
    """What one :func:`spans` recording saw, filled when it closes. Times
    are `time.perf_counter_ns` nanoseconds of this process.

    `lead_ns` is the most by which a device mark resolved before the host
    began the call that recorded it (negative when every mark resolved
    after: the device cannot start work before it is enqueued, so a large
    positive lead is an error of the clock map). `drift_ns` is the host's
    time between the two anchors less the device's; `anchors_ns` their host
    times. Without a CUDA device there are no intervals, no lead and no
    drift."""

    spans: List[Span] = field(default_factory=list)
    intervals: List[Interval] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    steps: int = 0
    anchors_ns: Optional[Tuple[int, int]] = None
    drift_ns: Optional[float] = None
    lead_ns: Optional[float] = None

    def write_chrome(self, path: str) -> None:
        """A Chrome trace at `path`: the host spans one track a thread, the
        device intervals one track ("device"), on one timeline from the
        first anchor (or the first span); the counters, steps and drift in
        its `otherData`."""
        t0 = (self.anchors_ns[0] if self.anchors_ns else
              min((s.start_ns for s in self.spans), default=0))
        threads = {name: i for i, name in enumerate(dict.fromkeys(s.thread for s in self.spans))}
        events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "host"}},
                  {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "device"}}]
        events += [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": name}} for name, tid in threads.items()]
        events += [{"ph": "X", "name": s.name, "pid": 0, "tid": threads[s.thread],
                    "ts": (s.start_ns - t0) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "step": s.step}}
                   for s in self.spans]
        events += [{"ph": "X", "name": i.name, "pid": 1, "tid": 0,
                    "ts": (i.start_ns - t0) / 1e3, "dur": (i.end_ns - i.start_ns) / 1e3,
                    "args": {"span": i.span}} for i in self.intervals]
        other = {"counters": self.counters, "steps": self.steps, "drift_ns": self.drift_ns,
                 "lead_ns": self.lead_ns}
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}, f)


class _Off:
    """The span of every site while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return None

    def device(self):
        return self


_OFF = _Off()
_REC: Optional["_Recorder"] = None


def span(name: str):
    """A context for the work inside, named `name`; its `device()` blocks
    mark the device work inside on the current stream (see the module
    docstring)."""
    rec = _REC
    if rec is None:
        return _OFF
    return _OnSpan(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to counter `name` while a recording is open."""
    rec = _REC
    if rec is not None:
        rec.count(name, n)


def _event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Mark(NamedTuple):
    called_ns: int  # host time at which the record call began
    event: object


class _Recorder:
    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans: List[Span] = []
        self.marks: List[Tuple[int, str, _Mark, _Mark]] = []
        self.counters: Dict[str, int] = collections.Counter()
        self.steps = 0
        self.ids = itertools.count()
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] += n

    def mark(self) -> _Mark:
        t = time.perf_counter_ns()
        return _Mark(t, _event(torch.cuda.current_stream(self.device)))


class _OnSpan:
    __slots__ = ("rec", "name", "id", "parent", "step", "t0", "first", "last")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name
        self.first = self.last = None

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        if self.name == STEP:
            with rec.lock:
                rec.steps += 1
        self.id = next(rec.ids)
        self.parent = stack[-1].id if stack else None
        self.step = rec.steps
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec.stack().pop()
        rec.spans.append(Span(self.id, self.name, threading.current_thread().name, self.parent,
                              self.step, self.t0, t1))
        if self.first is not None:
            rec.marks.append((self.id, self.name, self.first, self.last))
        return None

    @contextlib.contextmanager
    def device(self):
        """Around the span's device operations: its first block records the
        start mark, its last the end mark (nothing without a CUDA device)."""
        cuda = self.rec.cuda
        if cuda and self.first is None:
            self.first = self.rec.mark()
        try:
            yield self
        finally:
            if cuda:
                self.last = self.rec.mark()


class _ClockMap:
    """Device event -> host nanoseconds, linear between two anchors, each an
    (event, host ns) pair: the host time at which the device completed it."""

    def __init__(self, a: Tuple[object, int], b: Tuple[object, int]):
        (self.ev0, self.host0), (ev1, host1) = a, b
        device_ns = self.ev0.elapsed_time(ev1) * 1e6
        self.scale = (host1 - self.host0) / device_ns if device_ns > 0 else 1.0
        self.drift_ns = (host1 - self.host0) - device_ns

    def __call__(self, ev) -> int:
        return self.host0 + round(self.ev0.elapsed_time(ev) * 1e6 * self.scale)


def _anchor(device: torch.device) -> Tuple[object, int]:
    """An event completed on an idle device, and the host time it was seen
    complete."""
    torch.cuda.synchronize(device)
    ev = _event(torch.cuda.current_stream(device))
    while not ev.query():
        pass
    return ev, time.perf_counter_ns()


def _resolve(rec: _Recorder, out: Record, clock: Optional[_ClockMap]) -> None:
    out.spans = sorted(rec.spans, key=lambda s: s.start_ns)
    out.counters = dict(rec.counters)
    out.steps = rec.steps
    if clock is None:
        return
    out.drift_ns = clock.drift_ns
    leads = []
    for sid, name, first, last in rec.marks:
        start, end = clock(first.event), clock(last.event)
        out.intervals.append(Interval(sid, name, start, end))
        leads += [first.called_ns - start, last.called_ns - end]
    out.intervals.sort(key=lambda i: i.start_ns)
    out.lead_ns = max(leads) if leads else None


@contextlib.contextmanager
def spans(device) -> Iterator[Record]:
    """Records the spans, device marks and counters of the work inside on
    `device` and yields the :class:`Record`, filled when the block ends.
    One recording at a time: opening a second raises."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a span recording is already open")
    device = torch.device(device)
    rec = _Recorder(device)
    out = Record()
    first = _anchor(device) if rec.cuda else None
    _REC = rec
    try:
        yield out
    finally:
        _REC = None
    clock = None
    if first is not None:
        last = _anchor(device)
        out.anchors_ns = (first[1], last[1])
        clock = _ClockMap(first, last)
    _resolve(rec, out, clock)
