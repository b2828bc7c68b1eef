"""K1: int8 x int8 -> int32 GEMM, a hand-written Hopper kernel
(``csrc/matmul_int8.cu`` on ``csrc/gemm_s8_sm90.cuh``) and its plain
PyTorch version.

Replaces the TPU kernel ``mandheling_tpu/ops/kernels/matmul_int8.py``
``_matmul_kernel`` (the ``pallas_call`` of ``matmul_acc_pallas_padded``).
PyTorch has no integer ``mm`` or ``conv2d`` on CUDA, and a float32 product is
exact only below 2^24, so on the card this kernel serves every NITI
contraction of the training step: no profitability guard, no padding.

Bound on an H100: every LeNet and MobileNetV2 contraction does far fewer
int8 operations per byte moved than the card's ridge (~590), so device
memory bounds it, and at LeNet's batch 64 the launch itself does.

:func:`plan` reads the operands' strides and picks the kernel's route, copy
widths, tile and K split; it is plain Python, so the CPU tests hold it to
every layout the training step gives the kernel:

- ``kmajor`` (A's k contiguous: the forwards and input grads): wgmma. B must
  be K-major in shared memory (8-bit wgmma has no transpose), so an N-major
  B (the HWIO weights of a forward) is copied K-major first: one small copy
  per call, of a weight of at most 1280 x 320 bytes in MobileNetV2.
- ``mnmajor`` (A's m contiguous: the filter grads' im2col(x)^T view):
  mma.sync on 4 x 4 byte transposes, B read N-major (gy).

The int16-A route (:func:`matmul_acc_int16_cuda`) takes an int16 A (the
int16 projection outputs of MobileNetV2 with ``proj_bits=15`` that the next
conv reads, in both of its layouts) against an int8 B, and gives the int32
wrap of the exact product, as XLA's int32 accumulation does in the JAX
package, which computes these products outside Pallas
(``mandheling_tpu/ops/kernels/dispatch.py:72-86``). A is split into a signed
high-byte plane and an unsigned low-byte plane (two elementwise torch ops);
one launch of K1 multiplies both with the same plan, the low one by the
tensor cores' u8 x s8 form, and adds them as 256 hi + lo modulo 2^32. Like
the JAX package, it has no guard against the int32 wrap (32767 x 127 x K
passes 2^31 from K = 517).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import build

# Launches of the CUDA kernel (plain integers; counted where it launches),
# of the int8 route and of the int16-A route.
LAUNCHES = 0
INT16_LAUNCHES = 0

_BM = _BN = 64              # split_k's tile; the kernel's own come from plan()
_BK = 32                    # split_k's k-step in bytes
_MIN_BLOCKS = 264           # two blocks per SM of a 132-SM H100
_MIN_KSTEPS_PER_SPLIT = 4
_KMAJOR_BN = (32, 64, 96, 128, 160, 192, 256)  # wgmma tile widths (n32 steps)
_ROUTES = {"kmajor": 0, "mnmajor": 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("matmul_int8")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mh_matmul_s8s32.argtypes = [p, p, p, p, p, i, i, i, ll, ll, ll, ll, i, i, i, i, i, i, i,
                                    p]
    lib.mh_matmul_s8s32.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(m: int, n: int, k: int, tiles: Optional[int] = None):
    """(k-steps per split, splits): split the K loop across blocks only when
    the M x N tiles (64 x 64 unless `tiles` counts them) cannot fill the
    card (the filter grads' skinny outputs over a long batch contraction)."""
    ksteps = _cdiv(k, _BK)
    if tiles is None:
        tiles = _cdiv(m, _BM) * _cdiv(n, _BN)
    if tiles >= _MIN_BLOCKS or ksteps <= _MIN_KSTEPS_PER_SPLIT:
        return ksteps, 1
    splits = min(_cdiv(_MIN_BLOCKS, tiles), _cdiv(ksteps, _MIN_KSTEPS_PER_SPLIT))
    per = _cdiv(ksteps, splits)
    return per, _cdiv(ksteps, per)


def layout(m: int, k: int, n: int, a_strides: Sequence[int],
           b_strides: Sequence[int]) -> Tuple[str, str]:
    """(A's class, B's class) from the element strides: A "k" (k
    contiguous), "m" (m contiguous) or "strided"; B "k", "n" or "strided".
    A dimension of size 1 is contiguous whatever its stride."""
    (sam, sak), (sbk, sbn) = a_strides, b_strides
    a = "k" if sak == 1 or k <= 1 else "m" if sam == 1 or m <= 1 else "strided"
    b = "k" if sbk == 1 or k <= 1 else "n" if sbn == 1 or n <= 1 else "strided"
    return a, b


def copy_width(ptr: int, stride: int) -> int:
    """The widest copy (16, 8 or 4 bytes, else 1: the byte path) that keeps
    every row of an operand at `ptr` with row stride `stride` aligned."""
    for w in (16, 8, 4):
        if ptr % w == 0 and stride % w == 0:
            return w
    return 1


def kmajor_bn(n: int) -> int:
    """The wgmma tile width for N: least padded columns, counting 32 more
    a tile for the A tile each one re-reads; ties to the wider tile. Every
    N <= 256 gets one tile (BN >= N), so a K2 phase reads A once."""
    return min(_KMAJOR_BN, key=lambda bn: (_cdiv(n, bn) * (bn + 32), -bn))


@dataclass(frozen=True)
class Plan:
    route: str        # "kmajor" (wgmma) or "mnmajor" (mma.sync)
    copy_a: bool      # A is copied contiguous first (neither stride is 1)
    copy_b: bool      # B is copied into the layout the route reads
    a_width: int      # copy widths in bytes: 16, 8, 4 or 1
    b_width: int
    warps: int        # kmajor: warpgroups; mnmajor: warps along M (BM = 64 x warps)
    bn: int
    per: int          # k-steps of 32 bytes per split
    splits: int


def plan(m: int, k: int, n: int, a_strides: Sequence[int], b_strides: Sequence[int],
         a_ptr: int = 0, b_ptr: int = 0, fused: bool = False, wide: bool = False) -> Plan:
    """How K1 (or, with `fused`, K2: K-major only, never split) runs on
    operands with these strides and base addresses. A copied operand is a
    fresh allocation, aligned to 16 bytes and more. With `wide` (the
    int16-A route, whose byte planes these strides describe) the K-major
    route runs one warpgroup a block."""
    a_cls, b_cls = layout(m, k, n, a_strides, b_strides)
    per, splits = (_cdiv(k, _BK), 1) if fused else split_k(m, n, k)
    if a_cls == "m" and not fused:
        copy_b = b_cls != "n"
        sbk = n if copy_b else b_strides[0]
        warps, bn = min(((2, 64), (1, 128), (4, 32)),
                        key=lambda c: _cdiv(m, 64 * c[0]) * 64 * c[0] * _cdiv(n, c[1]) * c[1])
        per, splits = split_k(m, n, k, _cdiv(m, 64 * warps) * _cdiv(n, bn))
        return Plan("mnmajor", False, copy_b,
                    copy_width(a_ptr, a_strides[1] if k > 1 else 0),
                    copy_width(0 if copy_b else b_ptr, sbk if k > 1 else 0),
                    warps, bn, per, splits)
    copy_a, copy_b = a_cls != "k", b_cls != "k"
    sam = k if copy_a else a_strides[0]
    sbn = k if copy_b else b_strides[1]
    bn = kmajor_bn(n)
    warps = 2 if _cdiv(m, 128) * _cdiv(n, bn) >= _MIN_BLOCKS and not wide else 1
    return Plan("kmajor", copy_a, copy_b,
                copy_width(0 if copy_a else a_ptr, sam if m > 1 else 0),
                copy_width(0 if copy_b else b_ptr, sbn if n > 1 else 0),
                warps, bn, per, splits)


def prepare(a: torch.Tensor, b: torch.Tensor, pl: Plan):
    """The operands as the plan's route reads them (copies where it says)."""
    if pl.copy_a:
        a = a.contiguous()
    if pl.copy_b and pl.route == "kmajor":
        b = torch.empty_strided(b.shape, (1, b.shape[0]), dtype=b.dtype, device=b.device).copy_(b)
    elif pl.copy_b:
        b = b.contiguous()
    return a, b


def _check(a: torch.Tensor, b: torch.Tensor, a_types=(torch.int8,)) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need (M, K) x (K, N), got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype not in a_types or b.dtype != torch.int8:
        want = " or ".join(str(t) for t in a_types)
        raise TypeError(f"need {want} x torch.int8 operands, got {a.dtype} x {b.dtype}")


def matmul_acc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 or int16 (M, K) x int8 (K, N) -> int32 (M, N), exact on any
    device.

    float64 holds every partial sum exactly: a product is at most 2^22 in
    magnitude (int16 x int8), so |sum| < 2^53 for any K below 2^31; the
    int64 -> int32 cast wraps as XLA's int32 accumulation does. Never
    float32: exact only below 2^24."""
    _check(a, b, (torch.int8, torch.int16))
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64).to(torch.int32)


def _launch(a: torch.Tensor, a_lo: Optional[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """One launch of K1 -> int32 (M, N), contiguous: on int8 A, or (a_lo
    given) on the int16-A route's planes, a the high bytes and a_lo the
    low bytes with a's strides."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"K1 needs both operands on one CUDA device, got {a.device}, {b.device}")
    m, k = a.shape
    n = b.shape[1]
    pl = plan(m, k, n, a.stride(), b.stride(), a.data_ptr(), b.data_ptr(),
              wide=a_lo is not None)
    c = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return c
    a, b = prepare(a, b, pl)
    if a_lo is not None:
        a_lo = a_lo.contiguous() if pl.copy_a else a_lo
        if a_lo.stride() != a.stride():
            raise ValueError("the int16-A route's byte planes differ in layout")
    # the splits' partial sums, added by the kernel's second pass
    ws = (torch.empty((pl.splits, m, n), dtype=torch.int32, device=a.device)
          if pl.splits > 1 else None)
    err = _lib().mh_matmul_s8s32(
        a.data_ptr(), None if a_lo is None else a_lo.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), _ROUTES[pl.route],
        pl.a_width, pl.b_width, pl.warps, pl.bn, pl.per * _BK, pl.splits,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"matmul_int8 kernel launch failed: CUDA error {err}")
    return c


def matmul_acc_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on int8 CUDA tensors (any strides) -> int32 (M, N), contiguous."""
    global LAUNCHES
    _check(a, b)
    c = _launch(a, None, b)
    if c.numel():
        LAUNCHES += 1
    return c


def split_bytes(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int16 (M, K) a -> (int8 high bytes, uint8 low bytes), a = 256 hi +
    lo, each plane in a's layout where a is dense, row- or column-major;
    any other a is copied contiguous first."""
    if not (a.is_contiguous() or a.t().is_contiguous()):
        a = a.contiguous()
    return (a >> 8).to(torch.int8), (a & 0xFF).to(torch.uint8)


def matmul_acc_int16_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1's int16-A route on CUDA tensors: int16 (M, K) x int8 (K, N) ->
    int32 (M, N), contiguous, the int32 wrap of the exact product."""
    global INT16_LAUNCHES
    _check(a, b, (torch.int16,))
    hi, lo = split_bytes(a)
    c = _launch(hi, lo, b)
    if c.numel():
        INT16_LAUNCHES += 1
    return c


def matmul_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors (its int16-A route for an int16 A); its plain
    version on CPU tensors."""
    if a.is_cuda:
        if a.dtype == torch.int16:
            return matmul_acc_int16_cuda(a, b)
        return matmul_acc_cuda(a, b)
    return matmul_acc_plain(a, b)
