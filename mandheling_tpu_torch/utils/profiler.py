"""Step timing, trace capture, flop counts and per-op device tables (port of
``mandheling_tpu/utils/profiler.py``).

Reference: AUTOTIME scoped timers (`include/MNN/AutoTime.hpp`) and the
express per-op profiler (`Executor::Profiler`, express/Executor.cpp:34-77).
The JAX package reads per-op detail from an XLA trace and flops from XLA's
cost model; the port reads torch.profiler's events (utils/device_trace.py)
and counts flops as it runs:

- :class:`StepTimer`: ms/step and samples/s, as the training loops print
  them (MnistUtils.cpp:128-147);
- :func:`trace` (`xla_trace`): a Chrome trace of the work inside;
- :func:`spans` (utils/spans.py): the program's own host spans, counters
  and device marks on one clock, without torch.profiler, so a replayed
  CUDA graph runs as it does untraced; `Record.write_chrome` writes them;
- :func:`cost_analysis` / :func:`flops_per_step`: the NITI integer
  contractions from their shapes (ops/flops.py) and the float contractions
  from torch's FlopCounterMode;
- :func:`trace_device_events` (`trace_device_planes`) and
  :func:`per_op_profile`: the device's events of a few calls, and the
  per-op and per-category tables of them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._pytree import tree_flatten

from ..ops import flops as flop_count
from . import device_trace
from .spans import Record, count, span, spans  # noqa: F401


class StepTimer:
    """Accumulates step wall-times; reports ms/step and samples/s.

    CUDA work runs asynchronously, so a host clock alone measures the
    enqueue: pass `sync` (e.g. torch.cuda.synchronize) and each step ends
    when the device has finished it."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self._sync = sync
        self.reset()

    def reset(self):
        self._times = []
        self._samples = 0

    @contextlib.contextmanager
    def step(self, n_samples: int):
        t0 = time.perf_counter()
        yield
        if self._sync is not None:
            self._sync()
        self._times.append(time.perf_counter() - t0)
        self._samples += n_samples

    @property
    def total_s(self) -> float:
        return sum(self._times)

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.total_s / max(len(self._times), 1)

    @property
    def samples_per_sec(self) -> float:
        return self._samples / self.total_s if self.total_s else 0.0

    def summary(self) -> str:
        return (
            f"{len(self._times)} steps, {self.ms_per_step:.2f} ms/step, "
            f"{self.samples_per_sec:.0f} samples/s"
        )


def _activities(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    return acts + [torch.profiler.ProfilerActivity.CUDA] if cuda else acts


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A torch.profiler trace of the work inside (host ops, and the card's
    activity when there is a card), written into `logdir` as a Chrome trace
    (chrome://tracing, Perfetto) when the block ends; with no `logdir`,
    nothing is traced. Yields the profiler, or None."""
    if not logdir:
        yield None
        return
    cuda = torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities(cuda)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class _FloatFlops(FlopCounterMode):
    """FlopCounterMode without the float work a counted integer op does
    inside (a plain version's float64 GEMM), which ops/flops.py counts from
    the op's shapes instead; `bytes` adds the tensor arguments and results
    of every float contraction it counts, each once."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.bytes = 0

    def _count_flops(self, func_packet, out, args, kwargs):
        if flop_count.inside():
            return out
        if func_packet in self.flop_registry:
            leaves = tree_flatten((args, kwargs, out))[0]
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return super()._count_flops(func_packet, out, args, kwargs)


def _eager(fn: Callable) -> Callable:
    """The step a compiled step (train/step_graph.py) replays: a replay
    runs no Python, so it is counted through its eager form."""
    from ..train.step_graph import CompiledStep

    return fn.fn if isinstance(fn, CompiledStep) else fn


def cost_analysis(fn, *example_args) -> dict:
    """The work of one call of fn(*example_args) (the analog of XLA's cost
    model over the JAX package's jitted step, and of the reference's
    per-OpType flops, Executor.cpp:34-77): {"flops", "contraction bytes",
    "integer flops", "float flops"}.

    Unlike XLA's cost model, this runs `fn` once (eagerly, a compiled step
    too): a train step updates its model, so pass one to throw away. The
    NITI integer contractions count 2 flops a multiply-add from their
    shapes wherever they run (ops/flops.py), the same on the CPU and on the
    card and in every fused mode; float convolutions and matmuls (the float
    twins, QAT) count as torch's FlopCounterMode counts them. Elementwise
    work counts no flops (XLA's model counts it). "contraction bytes" has
    the same reach: every counted contraction, integer or float, reads its
    operands once and writes its result once (an integer op's result is
    what it returns: an int32 accumulator, or the requantized int8 or int16
    tensor). Elementwise traffic outside them is not counted, so this is
    not XLA's "bytes accessed", and fusing elementwise work does not move
    it."""
    with flop_count.counting() as ints, _FloatFlops(display=False) as floats:
        _eager(fn)(*example_args)
    float_flops = floats.get_total_flops()
    return {"flops": ints.flops + float_flops, "contraction bytes": ints.bytes + floats.bytes,
            "integer flops": ints.flops, "float flops": float_flops}


def flops_per_step(fn, *example_args) -> float:
    """The flops of one call of `fn(*example_args)` (cost_analysis)."""
    return float(cost_analysis(fn, *example_args)["flops"])


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in tree_flatten(args)[0])


def trace_device_events(fn, *example_args, iters: int = 3) -> List[dict]:
    """Call fn(*example_args) once outside the trace (a compiled step
    captures there), then trace `iters` calls and return the device's events
    (utils/device_trace.device_events): the card's CUDA activities when an
    argument is on the card, else the host's aten ops."""
    cuda = _on_cuda(example_args)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn(*example_args)
    sync()
    with flop_count.recording() as notes:
        with torch.profiler.profile(activities=_activities(cuda)) as prof:
            for _ in range(iters):
                fn(*example_args)
            sync()
    return device_trace.device_events(prof.events(), notes, cuda)


def per_op_profile(fn, *example_args, iters: int = 3):
    """Per-op device-time table of `iters` calls of fn(*example_args), the
    analog of the reference's Executor::Profiler per-OpType dump
    (express/Executor.cpp:34-77, printed per epoch by MnistUtils.cpp:184):
    (per-op rows, per-category rows) of utils/device_trace.py. Times,
    occurrences, flops and bytes are summed over the calls; divide by
    `iters` for one."""
    rows = device_trace.per_op_rows(trace_device_events(fn, *example_args, iters=iters))
    return rows, device_trace.by_category(rows)
