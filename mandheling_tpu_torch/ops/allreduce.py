"""Cross-replica gradient allreduce and the collectives of the parallel
layer (port of ``mandheling_tpu/ops/allreduce.py``, and of the
`lax.pmax` / `psum` / `all_gather` / `axis_index` calls the JAX package
makes inside `shard_map`).

Where the JAX package names a mesh axis (`axis_name`), the port passes a
``torch.distributed`` process group (`group`); `None` is the single-replica
path in both. Every collective of the port goes through this module, which
counts the calls and their host time (:func:`collective_stats`).

The ranks of one card share it over gloo (NCCL refuses two ranks on one
device), and gloo moves CUDA tensors through host memory. The collectives
here stage a CUDA tensor through the host themselves: the copy out waits for
the kernels before it on the current stream (a fused kernel's phase 1), the
copy back is ordered before the kernels after it (its phase 2), and gloo
sees CPU tensors only (it sends and receives no CUDA tensor at all).

Every collective counts its call and the host time from its call to its
result (:func:`collective_stats`; by site, for a caller that names one).
That time includes the wait for the card's queued work, which the copy out
does on the current stream; under :func:`timed_collectives` the card drains
its queue first, so that the time is the collective's own.

Two ways to combine the per-replica int32 weight-gradient accumulators
(`allreduce.py:1-21` of the JAX package):

- "int32" (default, exact): sum the int32 accumulators over the group
  BEFORE the single range estimate and pseudo-stochastic shift. Integer
  addition is associative (and wraps mod 2^32 as XLA's does), so the
  result is the single replica's byte for byte; 4 bytes an element travel.
- "int8" (approximate, 4x narrower): align every replica to a common
  exponent (the group's largest local bw plus ceil(log2 N) of headroom),
  psto-shift to int8 locally, sum the int8 tensors on the wire, then
  requantize the summed counts.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from . import numerics
from .kernels import requant_int32 as _rq

_MODE = "int32"
_VALID = ("int32", "int8")

# Collectives made since the last reset and the host seconds spent in them,
# in all and by the site a caller names.
_CALLS = 0
_SECONDS = 0.0
_SITES = {}
_SYNC = False


def set_grad_allreduce(mode: str) -> None:
    global _MODE
    if mode not in _VALID:
        raise ValueError(f"mode must be one of {_VALID}, got {mode!r}")
    _MODE = mode


def get_grad_allreduce() -> str:
    return _MODE


@contextlib.contextmanager
def use_grad_allreduce(mode: str):
    global _MODE
    prev = _MODE
    set_grad_allreduce(mode)
    try:
        yield
    finally:
        _MODE = prev


def collective_stats() -> Tuple[int, float]:
    """(collectives, host seconds in them) since the last reset."""
    return _CALLS, _SECONDS


def collective_sites() -> Dict[str, Tuple[int, float]]:
    """{site: (collectives, host seconds)} since the last reset, for the
    collectives whose caller named a site."""
    return dict(_SITES)


def reset_collective_stats() -> None:
    global _CALLS, _SECONDS
    _CALLS, _SECONDS = 0, 0.0
    _SITES.clear()


@contextlib.contextmanager
def timed_collectives():
    """Within: the card finishes its queued work before each collective
    starts its timer (a measuring run's setting; a step otherwise waits
    only for the current stream, in the copy out)."""
    global _SYNC
    prev, _SYNC = _SYNC, torch.cuda.is_initialized()
    try:
        yield
    finally:
        _SYNC = prev


def _timed(fn, *args, site: Optional[str] = None):
    """fn(*args), counted as one collective (and one of `site`), with its
    host time."""
    global _CALLS, _SECONDS
    if _SYNC:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    dt = time.perf_counter() - t0
    _SECONDS += dt
    _CALLS += 1
    if site is not None:
        n, t = _SITES.get(site, (0, 0.0))
        _SITES[site] = (n + 1, t + dt)
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t in host memory."""
    return t.detach().to("cpu", copy=True).contiguous()


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    out = _host(t)
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.device)


def _reduce(t: torch.Tensor, op, group, site: Optional[str] = None) -> torch.Tensor:
    return _timed(_all_reduce, t, op, group, site=site)


def pmax(t: torch.Tensor, group, site: Optional[str] = None) -> torch.Tensor:
    """Elementwise maximum over the group (`lax.pmax`)."""
    return _reduce(t, dist.ReduceOp.MAX, group, site)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over the group in t's dtype (`lax.psum`); integer
    sums wrap as XLA's do."""
    return _reduce(t, dist.ReduceOp.SUM, group)


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    src = _host(t)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t`, in group-rank order (`lax.all_gather`)."""
    return _timed(_all_gather, t, group)


def send(t: torch.Tensor, dst: int) -> None:
    """Point-to-point send to global rank `dst` (`lax.ppermute`'s half)."""
    _timed(dist.send, _host(t), dst)


def recv(shape, dtype, src: int, device) -> torch.Tensor:
    """Receive a tensor of `shape` and `dtype` from global rank `src`."""
    def _recv():
        buf = torch.empty(tuple(shape), dtype=dtype)
        dist.recv(buf, src)
        return buf.to(device)
    return _timed(_recv)


def maybe_pmax(m: torch.Tensor, group, site: Optional[str] = None) -> torch.Tensor:
    """`m`, or its maximum over `group` (JAX `ops/conv.py:111-114`)."""
    return m if group is None else pmax(m, group, site)


def grad_allreduce_requant(acc: torch.Tensor, group, margin: int,
                           pc_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Combine the per-replica int32 gradient accumulators over `group` and
    requantize to the int8 NITI gradient (shift = bw - margin); with group
    None, the local requant (JAX `allreduce.py:59-93`).

    `pc_shift`, the per-channel depthwise alignment (a broadcastable int32
    tensor of right shifts, truncating), is applied AFTER the cross-replica
    sum: truncating division does not commute with addition. The final
    requant, the shift inside it, is K7's (kernels/requant_int32.py) in
    every mode: one site a gradient."""
    if group is not None and _MODE == "int8":
        n = dist.get_world_size(group)
        log2n = max(1, math.ceil(math.log2(n))) if n > 1 else 0
        bw_g = pmax(numerics.range_estimate(acc), group)
        # |psto(acc, bw_g + log2n - 7)| <= 2^(7 - log2n): the N-replica sum
        # stays within int8, so the wire dtype really is int8
        aligned = numerics.psto_shift_int8(acc, bw_g + log2n - 7)
        acc = psum(aligned, group).to(torch.int32)
    elif group is not None:
        acc = psum(acc, group)
    acc = _rq.Values(acc, pc_shift=pc_shift, pc_right=True)
    return _rq.requant_grad(acc, _rq.absmax(acc), margin)
