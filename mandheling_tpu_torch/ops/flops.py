"""Work of the NITI integer contractions, counted from their shapes: the
integer half of `utils/profiler.cost_analysis` (XLA's cost model counts the
JAX package's convolutions and dots from their shapes the same way).

Every public contraction op of ops/conv.py, ops/depthwise.py and
ops/matmul.py is wrapped by :func:`counted` (and, as no work, so that their
launches are noted: ops/eltwise.add_int8's requant and K8's pools and concat,
ops/pool.py, ops/depthwise.py's average pool, ops/eltwise.concat_int8), at
its entry, where every route passes: the plain version, K1, and the fused
two-phase routes (K2, K3, K4), which do not all go through the `_acc`
functions. So a count does not
depend on the backend, the fused mode or the device. An op counts 2 flops a
multiply-add of the contraction its shapes define (a strided input grad
counts the forward's products, not those of the zero-dilated form the
kernels compute), and its bytes as its operands read once and its result
written once. An op called inside another counted op (a forward's
accumulator) is not counted again.

While a counted op runs, :func:`inside` is true: cost_analysis leaves the
float work of a plain version (its float64 GEMM) out of the float count.

:func:`recording` notes, for every kernel launch a counted op makes, the
kernel's launch counter, the op's flops and bytes (none for K7's and K8's
launches, ``kernels.NO_CONTRACTION``) and the op's source (file:line), in
launch order. Every graph of train/step_graph.py keeps the
notes of its capture (:func:`hold_launches`, :func:`take_launches`) and
hands them to the open records at every replay (:func:`add_launches`), in
the replay hook that re-adds the launch counts. The profiler joins the
notes to the traced kernels of each counter in order
(utils/device_trace.py).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
from typing import Any, Callable, List, Mapping, Tuple

import torch

from . import kernels

# (launch counter, flops, bytes, source) of one kernel launch
Launch = Tuple[str, int, int, str]

_COUNTS: List["Count"] = []
_RECORDS: List[List[Launch]] = []
_DEPTH = 0


class Count:
    """Flops and bytes of the counted ops."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0


@contextlib.contextmanager
def counting():
    """A :class:`Count` of the counted ops run while inside."""
    count = Count()
    _COUNTS.append(count)
    try:
        yield count
    finally:
        _COUNTS.remove(count)


def inside() -> bool:
    """Whether a counted op is running (while something counts or records)."""
    return _DEPTH > 0


def hold_launches():
    """Start taking the launches noted from here on out of the open records
    (a capture's launches run nothing); take_launches(token) ends it."""
    mine: List[Launch] = []
    others = [(notes, len(notes)) for notes in _RECORDS]
    _RECORDS.append(mine)
    return mine, others


def take_launches(token) -> List[Launch]:
    """The launches noted since hold_launches() gave `token`, taken out of
    the records that were open then."""
    mine, others = token
    _RECORDS.remove(mine)
    for notes, n in others:
        del notes[n:]
    return mine


def add_launches(made: List[Launch]) -> None:
    """Note `made` in every open record (a replay of the graph that
    captured them)."""
    for notes in _RECORDS:
        notes.extend(made)


@contextlib.contextmanager
def recording():
    """The launches (a list of Launch) of the counted ops run while inside."""
    notes: List[Launch] = []
    _RECORDS.append(notes)
    try:
        yield notes
    finally:
        _RECORDS.remove(notes)


def counted(work: Callable[[Mapping[str, Any]], Tuple[int, int]]):
    """Decorate a contraction op: work(arguments) -> (multiply-adds, bytes),
    from the op's arguments by name (defaults filled in)."""

    def wrap(op):
        source = f"{op.__code__.co_filename}:{op.__code__.co_firstlineno}"
        signature = inspect.signature(op)

        @functools.wraps(op)
        def run(*args, **kwargs):
            global _DEPTH
            if _DEPTH or not (_COUNTS or _RECORDS):
                return op(*args, **kwargs)
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            macs, nbytes = work(bound.arguments)
            for count in _COUNTS:
                count.flops += 2 * macs
                count.bytes += nbytes
            before = kernels.launch_counts() if _RECORDS else None
            _DEPTH += 1
            try:
                out = op(*args, **kwargs)
            finally:
                _DEPTH -= 1
            if before is not None:
                after = kernels.launch_counts()
                made = [(name, 0, 0, source) if name in kernels.NO_CONTRACTION
                        else (name, 2 * macs, nbytes, source)
                        for name in after for _ in range(after[name] - before[name])]
                for notes in _RECORDS:
                    notes.extend(made)
            return out

        return run

    return wrap


def nbytes(*tensors: torch.Tensor) -> int:
    """The bytes of `tensors`, each read once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_out(spatial, kernel, stride, pads) -> Tuple[int, int]:
    """The output spatial size of a conv with per-edge `pads`."""
    return tuple((n + p[0] + p[1] - k) // s + 1
                 for n, k, s, p in zip(spatial, kernel, stride, pads))


def grad_work(gy: torch.Tensor, other: torch.Tensor, taps: int, ic: int, out_shape,
              out_size: int) -> Tuple[int, int]:
    """(multiply-adds, bytes) of a gradient of the conv whose output
    gradient is gy (B, OH, OW, OC) with `taps` kernel positions and `ic`
    input channels a filter: the forward's products; gy and `other` (the
    weight, or x for a filter grad) read once, the gradient of `out_shape`
    written once (`out_size` bytes an element)."""
    return (gy.numel() * taps * ic,
            nbytes(gy, other) + math.prod(out_shape) * out_size)
