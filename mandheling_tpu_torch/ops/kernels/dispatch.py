"""Kernel backend selector (port of ``mandheling_tpu/ops/kernels/dispatch.py``).

- "cuda"  (default; the analog of "pallas"): the hand-written kernels. A
          CUDA tensor launches the kernel or raises; a CPU tensor takes the
          kernel's plain version.
- "torch" (the analog of "xla"): the plain PyTorch versions on any device,
          and no fused route. For comparisons only.

Every backend produces the same int32 accumulator, so the NITI requant
above it is backend-independent.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from . import conv_int8, matmul_int8

_BACKEND = "cuda"
_VALID = ("cuda", "torch")


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


@contextlib.contextmanager
def use_backend(name: str):
    global _BACKEND
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        _BACKEND = prev


def _check_types(a: torch.Tensor, b: torch.Tensor) -> None:
    """An int8 or int16 left operand (int16: the projection outputs of
    MobileNetV2 with proj_bits=15, which K1's int16-A route takes) against
    an int8 right one. The JAX package widens an int8 gy to int16 in the
    filter grad; the values are the same, so the port keeps it int8."""
    if a.dtype not in (torch.int8, torch.int16) or b.dtype != torch.int8:
        raise TypeError(f"need int8 or int16 x int8 operands, got {a.dtype} x {b.dtype}")


def _matmul():
    return matmul_int8.matmul_acc_plain if _BACKEND == "torch" else matmul_int8.matmul_acc


def conv_acc(
    x: torch.Tensor,
    w: torch.Tensor,
    strides: Tuple[int, int],
    padding: Tuple[Tuple[int, int], Tuple[int, int]],
    lhs_dilation: Optional[Tuple[int, int]] = None,
    rhs_dilation: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """int8 or int16 NHWC x * int8 HWIO w with int32 accumulation on the
    selected backend."""
    _check_types(x, w)
    return conv_int8.conv_acc(x, w, strides, padding, lhs_dilation or (1, 1),
                              rhs_dilation or (1, 1), matmul=_matmul())


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 or int16 (M,K) x int8 (K,N) -> int32 (M,N) on the selected
    backend."""
    _check_types(a, b)
    return _matmul()(a, b)
