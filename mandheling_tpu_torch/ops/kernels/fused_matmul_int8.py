"""K2: the two-phase fused NITI matmul, a hand-written Hopper kernel
(``csrc/fused_matmul_int8.cu``) and its plain PyTorch version.

Replaces the TPU kernels of ``mandheling_tpu/ops/kernels/fused_matmul_int8.py``:
``_small_max_kernel`` / ``_max_kernel`` (phase 1) and
``_small_requant_kernel`` / ``_requant_kernel`` (phase 2); one CUDA design
covers both the small-K/N and the tiled branch.

- phase 1 (:func:`matmul_max`): max|A @ B| as a 0-d int32; the int32
  accumulator never reaches device memory.
- glue (the caller, ``ops/conv.py``): ``range_estimate_from_max`` and
  ``forward_shift`` on the device, so the host never waits between phases.
- phase 2 (:func:`matmul_requant`): recompute A @ B and apply the psto
  epilogue, reading the shift from device memory, writing int8 only.

Bound on an H100: every shape ``supports`` takes (K, N <= 512) does few int8
operations per byte moved, so device memory bounds it; phase 2 also has a
floor on the CUDA cores (the psto epilogue's ~30 integer operations an
output). Both phases run K1's K-major wgmma route (``plan(..., fused=True)``:
an N-major B is copied K-major first, and BN covers N up to 256, so a phase
reads A once).

K6 (:func:`matmul_max_bf16`, ``csrc/matmul_max_bf16.cu``) is phase 1 with
the int8 operands multiplied as bf16 on the tensor cores and summed in
float32, then converted to int32: the bf16 variant of the TPU micro-probe
``tools/probes/dot_probe.py`` (``tools/probes/dot_probe_torch.py`` runs
both). No training path calls it. It stages the int8 tiles by ``cp.async``
as they lie (A k-contiguous, B n-contiguous: other strides are copied so
first), converts them into swizzled bf16 tiles in shared memory, and runs
``wgmma`` on them, bound by the tensor cores' bf16 rate.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import numerics
from . import build
from .matmul_int8 import _check, copy_width, matmul_acc_plain, plan, prepare

# Launches of the CUDA kernels (plain integers; counted where they launch).
MAX_LAUNCHES = 0
REQUANT_LAUNCHES = 0
MAX_BF16_LAUNCHES = 0

_SMALL_KN = 512
_MIN_ACC_BYTES = 2 * 2**20
_INT32_MIN = -(2**31)


def supports(m: int, k: int, n: int) -> bool:
    """The JAX package's eligibility rule, unchanged, so that the same shapes
    take the fused route on both: small K and N, and an int32 accumulator of
    at least 2 MB (the fc2 input grad from batch 1056 on)."""
    return (
        k <= _SMALL_KN
        and n <= _SMALL_KN
        and m % 8 == 0
        and m >= 1024
        and 4 * m * n >= _MIN_ACC_BYTES
    )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_matmul_int8")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mh_fused_matmul_max.argtypes = [p, p, p, i, i, i, ll, ll, i, i, i, p]
    lib.mh_fused_matmul_max.restype = ctypes.c_int
    lib.mh_fused_matmul_requant.argtypes = [p, p, p, p, i, i, i, ll, ll, i, i, i, i, p]
    lib.mh_fused_matmul_requant.restype = ctypes.c_int
    return lib


def _check_cuda(a: torch.Tensor, b: torch.Tensor) -> None:
    _check(a, b)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"K2 needs both operands on one CUDA device, got {a.device}, {b.device}")


def _kmajor(a: torch.Tensor, b: torch.Tensor):
    """(a, b, plan) with both operands K-major, as K2's kernels read them."""
    m, k = a.shape
    pl = plan(m, k, b.shape[1], a.stride(), b.stride(), a.data_ptr(), b.data_ptr(), fused=True)
    return (*prepare(a, b, pl), pl)


def matmul_max_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return numerics.abs_max(matmul_acc_plain(a, b))


def matmul_requant_plain(a: torch.Tensor, b: torch.Tensor, shift: torch.Tensor,
                         grad: bool = False) -> torch.Tensor:
    return numerics.psto_epilogue(matmul_acc_plain(a, b), shift, grad)


def matmul_max_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Phase 1 on the card -> 0-d int32 max|a @ b| (INT32_MIN for an empty
    product, the identity of jnp.max)."""
    global MAX_LAUNCHES
    _check_cuda(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((), _INT32_MIN, dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    a, b, pl = _kmajor(a, b)
    err = _lib().mh_fused_matmul_max(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(1),
        pl.a_width, pl.b_width, pl.bn, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_matmul_max kernel launch failed: CUDA error {err}")
    MAX_LAUNCHES += 1
    return out


def matmul_requant_cuda(a: torch.Tensor, b: torch.Tensor, shift: torch.Tensor,
                        grad: bool = False) -> torch.Tensor:
    """Phase 2 on the card -> int8 (M, N); `shift` is a 0-d int32 on the
    operands' device and is read there by the kernel."""
    global REQUANT_LAUNCHES
    _check_cuda(a, b)
    if shift.device != a.device or shift.numel() != 1:
        raise ValueError("shift must be a one-element tensor on the operands' device")
    shift = shift.to(torch.int32).contiguous()
    m, k = a.shape
    n = b.shape[1]
    y = torch.empty((m, n), dtype=torch.int8, device=a.device)
    if m == 0 or n == 0:
        return y
    a, b, pl = _kmajor(a, b)
    err = _lib().mh_fused_matmul_requant(
        a.data_ptr(), b.data_ptr(), shift.data_ptr(), y.data_ptr(), m, n, k, a.stride(0),
        b.stride(1), pl.a_width, pl.b_width, pl.bn, int(grad),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_matmul_requant kernel launch failed: CUDA error {err}")
    REQUANT_LAUNCHES += 1
    return y


def matmul_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Phase 1: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if a.is_cuda:
        return matmul_max_cuda(a, b)
    return matmul_max_plain(a, b)


def matmul_requant(a: torch.Tensor, b: torch.Tensor, shift: torch.Tensor,
                   grad: bool = False) -> torch.Tensor:
    """Phase 2: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if a.is_cuda:
        return matmul_requant_cuda(a, b, shift, grad)
    return matmul_requant_plain(a, b, shift, grad)


@functools.lru_cache(maxsize=None)
def _bf16_lib() -> ctypes.CDLL:
    lib = build.library("matmul_max_bf16")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mh_matmul_max_bf16.argtypes = [p, p, p, i, i, i, ll, ll, i, i, p]
    lib.mh_matmul_max_bf16.restype = ctypes.c_int
    return lib


def matmul_max_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max|A @ B| with the operands as bf16 and the sums in float32, then
    int32, as the TPU probe computes it. Every int8 is exact in bf16 and in
    float32, so the product is taken in float32; its sums are exact, and
    equal ``matmul_max_plain``, while they stay below 2^24."""
    acc = (a.to(torch.float32) @ b.to(torch.float32)).to(torch.int32)
    return numerics.abs_max(acc)


def matmul_max_bf16_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6 on the card -> 0-d int32 max|a @ b| (INT32_MIN for an empty product)."""
    global MAX_BF16_LAUNCHES
    _check_cuda(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((), _INT32_MIN, dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    if a.stride(1) != 1 and k > 1:  # the kernel reads A's rows k-contiguous
        a = a.contiguous()
    if b.stride(1) != 1 and n > 1:  # and B's rows n-contiguous
        b = b.contiguous()
    err = _bf16_lib().mh_matmul_max_bf16(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
        copy_width(a.data_ptr(), a.stride(0) if m > 1 else 0),
        copy_width(b.data_ptr(), b.stride(0) if k > 1 else 0),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"fused_matmul_max_bf16 kernel launch failed: CUDA error {err}")
    MAX_BF16_LAUNCHES += 1
    return out


def matmul_max_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if a.is_cuda:
        return matmul_max_bf16_cuda(a, b)
    return matmul_max_bf16_plain(a, b)
