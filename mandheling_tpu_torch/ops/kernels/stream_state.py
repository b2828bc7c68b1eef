"""Device state that a kernel keeps between its launches, one set per CUDA
stream: K3's phase-1 running max and block ticket and its K-major weight
buffers, K4's phase-1 ticket, K5's scratch accumulator and column tickets.

Each kernel leaves its state as it found it, so a launch on a stream starts
from the state the previous launch on that stream left, and so does every
replay of a CUDA graph captured on it (``train/step_graph.py``). The state
is made on the device (a fill, never a copy from a host list), and never
inside a capture: made there, it would come from the graph's private pool
and outlive the graph through this cache. A step is therefore run once on
the capturing stream before it is captured; a miss during a capture raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable

import torch

_STATE: Dict[Hashable, torch.Tensor] = {}


def per_stream(key: Hashable, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The tensor cached under `key` (which names the kernel, the device and
    the stream's handle), made by make() at the first call."""
    t = _STATE.get(key)
    if t is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"kernel state {key!r} would be made inside a CUDA graph capture: run the "
                "step once on the capturing stream before capturing it")
        t = _STATE[key] = make()
    return t
