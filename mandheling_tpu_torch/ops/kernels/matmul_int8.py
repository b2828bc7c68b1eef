"""K1: int8 x int8 -> int32 GEMM, a hand-written Hopper kernel
(``csrc/matmul_int8.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``mandheling_tpu/ops/kernels/matmul_int8.py``
``_matmul_kernel`` (the ``pallas_call`` of ``matmul_acc_pallas_padded``).
PyTorch has no integer ``mm`` or ``conv2d`` on CUDA, and a float32 product is
exact only below 2^24, so on the card this kernel serves every NITI
contraction of the training step: no profitability guard, no padding.

Bound on an H100: every LeNet contraction does at most ~90 int8 operations
per byte moved (the card's ridge is ~590), so device memory bounds it, and
at batch 64 the launch itself does. See the CUDA source for the design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

# Launches of the CUDA kernel (plain integer; counted where it launches).
LAUNCHES = 0

_BM = _BN = 64
_BK = 32
_MIN_BLOCKS = 264           # two blocks per SM of a 132-SM H100
_MIN_KSTEPS_PER_SPLIT = 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("matmul_int8")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mh_matmul_s8s32.argtypes = [p, p, p, i, i, i, ll, ll, ll, ll, i, i, p]
    lib.mh_matmul_s8s32.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(m: int, n: int, k: int):
    """(k-steps per split, splits): split the K loop across blocks only when
    the M x N tiles cannot fill the card (the filter grads' skinny outputs
    over a long batch contraction)."""
    ksteps = _cdiv(k, _BK)
    tiles = _cdiv(m, _BM) * _cdiv(n, _BN)
    if tiles >= _MIN_BLOCKS or ksteps <= _MIN_KSTEPS_PER_SPLIT:
        return ksteps, 1
    splits = min(_cdiv(_MIN_BLOCKS, tiles), _cdiv(ksteps, _MIN_KSTEPS_PER_SPLIT))
    per = _cdiv(ksteps, splits)
    return per, _cdiv(ksteps, per)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need (M, K) x (K, N), got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {a.dtype} x {b.dtype}")


def matmul_acc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N), exact on any device.

    float64 holds every partial sum of int8 products exactly (|sum| <
    2^53 for any K below 2^38), and the int64 -> int32 cast wraps as XLA's
    int32 accumulation does. Never float32: exact only below 2^24."""
    _check(a, b)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64).to(torch.int32)


def matmul_acc_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors (any strides) -> int32 (M, N), contiguous."""
    global LAUNCHES
    _check(a, b)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"K1 needs both operands on one CUDA device, got {a.device}, {b.device}")
    m, k = a.shape
    n = b.shape[1]
    per, splits = split_k(m, n, k)
    alloc = torch.zeros if splits > 1 else torch.empty
    c = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return c
    err = _lib().mh_matmul_s8s32(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), per, splits,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return c


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor; its plain version on a CPU tensor."""
    if a.is_cuda:
        return matmul_acc_cuda(a, b)
    return matmul_acc_plain(a, b)
