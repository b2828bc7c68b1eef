"""Step timing and samples/s counters (port of ``StepTimer`` from
``mandheling_tpu/utils/profiler.py``)."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional


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
