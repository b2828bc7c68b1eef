"""The closed training loop the window drives: each step fed as the port's
trainer feeds it (a shuffled epoch of the data loader, the padded one-hot,
both copied to the device), issued after the last, with no synchronise
after a step. A device event is recorded after each step; the host waits
on the event of the step `AHEAD` steps back, so that it runs ahead of the
device by a bounded number of steps. Host time is taken around the
trainer's calls and around the step call."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, List, Optional

import torch

AHEAD = 3


class Marks:
    """Device events recorded after each step (on the CPU: host times)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        else:
            self.events.append(time.perf_counter())

    def wait(self, i: int) -> None:
        if self.cuda:
            self.events[i].synchronize()

    def seconds(self, first: int) -> float:
        """From mark `first` to the last (after the device has passed them)."""
        a, b = self.events[first], self.events[-1]
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def intervals_ms(self, first: int = 0) -> List[float]:
        """Between consecutive marks from mark `first` on (after the device
        has passed them all)."""
        ev = self.events[first:]
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        return [(b - a) * 1e3 for a, b in zip(ev, ev[1:])]


def endless(epoch: Callable[[], Iterator]) -> Iterator:
    """Epoch after epoch of the loader."""
    while True:
        yield from epoch()


class Loop:
    """Drives `step` on batches from `batches`, feeding it as train_niti
    does. `feed` makes the step's arguments from a host batch: (trainer
    calls) -> the device tensors."""

    def __init__(self, step, batches: Iterator, feed: Callable, device: torch.device):
        self.step, self.batches, self.feed, self.device = step, batches, feed, device
        self.losses: List[torch.Tensor] = []
        self.trainer_s: List[float] = []
        self.step_s: List[float] = []

    def clear(self) -> None:
        """Forget the losses and host times of the steps run so far."""
        self.losses.clear()
        self.trainer_s.clear()
        self.step_s.clear()

    def run(self, until: Callable[[int], bool], spans: bool = False,
            marks: Optional[Marks] = None) -> int:
        """Issue steps until until(steps issued) is true; -> steps issued.
        With `spans`, each call is inside a profiler range named
        h100bench.<layer>."""
        from torch.profiler import record_function

        def span(name):
            return record_function("h100bench." + name) if spans else contextlib.nullcontext()

        marks = marks or Marks(self.device)
        n = 0
        while not until(n):
            t0 = time.perf_counter()
            with span("trainer"):
                args = self.feed(next(self.batches))
            t1 = time.perf_counter()
            with span("step"):
                loss = self.step(*args)
            t2 = time.perf_counter()
            marks.mark()
            self.losses.append(loss)
            self.trainer_s.append(t1 - t0)
            self.step_s.append(t2 - t1)
            n += 1
            if len(marks.events) > AHEAD:
                with span("wait"):
                    marks.wait(len(marks.events) - 1 - AHEAD)
        return n
