"""K4, the two-phase fused NITI depthwise conv, and K5, the depthwise
filter-grad accumulator: hand-written Hopper kernels
(``csrc/fused_dwconv_int8.cu``, ``csrc/fused_dwconv_fgrad_int8.cu``) and
their plain PyTorch versions.

K4 replaces the TPU kernels of ``mandheling_tpu/ops/kernels/fused_dwconv_int8.py``
``_max_kernel`` (``dwconv_max_pallas``) and ``_requant_kernel``
(``dwconv_requant_pallas``). Both take the pre-padded input xp
(B, Hp, Wp, C) and the (KH, KW, 1, C) weight of a VALID stride-1 depthwise
conv:

- phase 1 (:func:`dwconv_max`): max|acc| as a 0-d int32;
- phase 2 (:func:`dwconv_requant`): recompute the taps and apply the psto
  epilogue with the shift read from device memory, writing int8 only.

No channel contraction, so no tensor-core work: KH*KW multiply-adds of int8
operands into int32 per output on the CUDA cores, channels across the lanes
of a warp. The 3x3 instance (every depthwise layer of the MobileNets) stages
a halo tile of xp in shared memory and keeps the weights in registers; one
untiled instance takes every other kernel size, as the JAX kernel does.
Bound on an H100 at the MobileNetV2 shapes: bytes, in both phases. At the
CUDA cores' int8 rate (IDP4A, 67 T multiply-adds/s: 132 SMs x 64 x 4 x
1.98 GHz) the operations take at most 0.4 of the bytes' time (see the CUDA
source).

K5 (:func:`dwconv_fgrad_acc`) replaces the third TPU kernel here,
``_fgrad_kernel`` (``dwconv_fgrad_acc_pallas``): the int32 (KH, KW, 1, C)
filter-grad accumulator of a stride-1 depthwise conv, from xp and the
output diff gy (B, OH, OW, C) in one pass, wrapping modulo 2^32 as the TPU
kernel's int32 sums do. No path of the JAX package routes that kernel; the
port routes K5 for every stride-1 depthwise filter grad that
:func:`supports_fgrad` takes, under the "cuda" backend
(``ops/depthwise.py``). Bound: bytes (see the CUDA source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import numerics
from . import build

# Launches of the CUDA kernels (plain integers; counted where they launch).
MAX_LAUNCHES = 0
REQUANT_LAUNCHES = 0
FGRAD_LAUNCHES = 0

# The JAX package's VMEM budget, which its eligibility rule is written in.
_VMEM_BUDGET = 6 * 2**20


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supports(b: int, hp: int, wp: int, oh: int, ow: int, c: int) -> bool:
    """The JAX package's eligibility rule, unchanged, so that the same shapes
    take the fused route on both: one padded image fits its VMEM budget."""
    cpad = _round_up(c, 128)
    return (hp * wp + 5 * oh * ow * 4 + ow) * cpad <= _VMEM_BUDGET


def supports_fgrad(xp_shape, gy_shape, kernel, stride=(1, 1)) -> bool:
    """The JAX package's rule for its filter-grad kernel, unchanged: stride
    1, gy the VALID output of xp, and one padded image within its VMEM
    budget (``dwconv_fgrad_acc_pallas`` returns None otherwise)."""
    kh, kw = kernel
    _, hp, wp, c = xp_shape
    oh, ow = gy_shape[1], gy_shape[2]
    if tuple(stride) != (1, 1) or (oh, ow) != (hp - kh + 1, wp - kw + 1):
        return False
    return (hp * wp + 3 * oh * ow * 4) * _round_up(c, 128) <= _VMEM_BUDGET


def dwconv_fgrad_acc_plain(xp: torch.Tensor, gy: torch.Tensor, kernel,
                           stride=(1, 1)) -> torch.Tensor:
    """int32 (KH, KW, 1, C): sum over (b, oh, ow) of xp[b, oh*s+dy, ow*s+dx, c]
    * gy[b, oh, ow, c]. torch sums the int32 products in int64; the low 32
    bits are kept, as the TPU kernel's int32 sums (and XLA's) wrap."""
    kh, kw = kernel
    sh, sw = stride
    _, oh, ow, c = gy.shape
    g = gy.to(torch.int32)
    taps = [(xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw, :]
             .to(torch.int32) * g).sum(dim=(0, 1, 2))
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps).reshape(kh, kw, 1, c).to(torch.int32)


def dwconv_acc_plain(xp: torch.Tensor, w: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
    """int32 accumulator of the VALID depthwise conv of xp (B, Hp, Wp, C) with
    w (KH, KW, 1, C): KH*KW shifted multiply-adds, exact on any device."""
    kh, kw, _, c = w.shape
    sh, sw = stride
    b, hp, wp, _ = xp.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    acc = torch.zeros((b, oh, ow, c), dtype=torch.int32, device=xp.device)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw, :]
            acc += tap.to(torch.int32) * w[dy, dx, 0].to(torch.int32)
    return acc


def dwconv_max_plain(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return numerics.abs_max(dwconv_acc_plain(xp, w))


def dwconv_requant_plain(xp: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                         grad: bool = False) -> torch.Tensor:
    return numerics.psto_epilogue(dwconv_acc_plain(xp, w), shift, grad)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_dwconv_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mh_fused_dwconv_max.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.mh_fused_dwconv_max.restype = ctypes.c_int
    lib.mh_fused_dwconv_requant.argtypes = [p, p, p, p] + [i] * 7 + [p]
    lib.mh_fused_dwconv_requant.restype = ctypes.c_int
    return lib


def _prepare(xp: torch.Tensor, w: torch.Tensor):
    if xp.dim() != 4 or w.dim() != 4 or w.shape[2] != 1 or w.shape[3] != xp.shape[3]:
        raise ValueError(f"need xp (B, Hp, Wp, C) and w (KH, KW, 1, C), got "
                         f"{tuple(xp.shape)}, {tuple(w.shape)}")
    if xp.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {xp.dtype}, {w.dtype}")
    if not (xp.is_cuda and w.is_cuda) or xp.device != w.device:
        raise ValueError(f"K4 needs xp and w on one CUDA device, got {xp.device}, {w.device}")
    kh, kw, _, c = w.shape
    b, hp, wp, _ = xp.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    if b > 65535 or xp.numel() >= 2**31:
        raise ValueError(f"K4 takes batches up to 65535 and int32-indexable xp, got {tuple(xp.shape)}")
    w2 = w.reshape(kh * kw, c).contiguous()
    return xp.contiguous(), w2, (b, max(oh, 0), max(ow, 0), c), [b, hp, wp, c, kh, kw]


def dwconv_max_cuda(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Phase 1 on the card -> 0-d int32 max|acc| (INT32_MIN when empty)."""
    global MAX_LAUNCHES
    xp, w2, (b, oh, ow, c), dims = _prepare(xp, w)
    out = torch.full((), -(2**31), dtype=torch.int32, device=xp.device)
    if b * oh * ow * c == 0:
        return out
    err = _lib().mh_fused_dwconv_max(xp.data_ptr(), w2.data_ptr(), out.data_ptr(), *dims,
                                     torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_dwconv_max kernel launch failed: CUDA error {err}")
    MAX_LAUNCHES += 1
    return out


def dwconv_requant_cuda(xp: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                        grad: bool = False) -> torch.Tensor:
    """Phase 2 on the card -> int8 (B, OH, OW, C); `shift` is a 0-d int32 on
    xp's device and is read there by the kernel."""
    global REQUANT_LAUNCHES
    xp, w2, shape, dims = _prepare(xp, w)
    if shift.device != xp.device or shift.numel() != 1:
        raise ValueError("shift must be a one-element tensor on xp's device")
    shift = shift.to(torch.int32).contiguous()
    y = torch.empty(shape, dtype=torch.int8, device=xp.device)
    if y.numel() == 0:
        return y
    err = _lib().mh_fused_dwconv_requant(xp.data_ptr(), w2.data_ptr(), shift.data_ptr(),
                                         y.data_ptr(), *dims, int(grad),
                                         torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_dwconv_requant kernel launch failed: CUDA error {err}")
    REQUANT_LAUNCHES += 1
    return y


def dwconv_max(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Phase 1: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if xp.is_cuda:
        return dwconv_max_cuda(xp, w)
    return dwconv_max_plain(xp, w)


def dwconv_requant(xp: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                   grad: bool = False) -> torch.Tensor:
    """Phase 2: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if xp.is_cuda:
        return dwconv_requant_cuda(xp, w, shift, grad)
    return dwconv_requant_plain(xp, w, shift, grad)


@functools.lru_cache(maxsize=None)
def _fgrad_lib() -> ctypes.CDLL:
    lib = build.library("fused_dwconv_fgrad_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mh_dwconv_fgrad_acc.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.mh_dwconv_fgrad_acc.restype = ctypes.c_int
    return lib


def dwconv_fgrad_acc_cuda(xp: torch.Tensor, gy: torch.Tensor, kernel) -> torch.Tensor:
    """K5 on the card -> int32 (KH, KW, 1, C)."""
    global FGRAD_LAUNCHES
    kh, kw = kernel
    if xp.dim() != 4 or gy.dim() != 4 or xp.shape[0] != gy.shape[0] or xp.shape[3] != gy.shape[3]:
        raise ValueError(f"need xp (B, Hp, Wp, C) and gy (B, OH, OW, C), got "
                         f"{tuple(xp.shape)}, {tuple(gy.shape)}")
    if xp.dtype != torch.int8 or gy.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {xp.dtype}, {gy.dtype}")
    if not (xp.is_cuda and gy.is_cuda) or xp.device != gy.device:
        raise ValueError(f"K5 needs xp and gy on one CUDA device, got {xp.device}, {gy.device}")
    b, hp, wp, c = xp.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    if (gy.shape[1], gy.shape[2]) != (oh, ow):
        raise ValueError(f"gy {tuple(gy.shape)} is not the VALID stride-1 output of xp "
                         f"{tuple(xp.shape)} under a {kh}x{kw} kernel")
    if b * oh > 32 * 65535:
        raise ValueError(f"K5 takes up to {32 * 65535} (b, oh) rows, got {b * oh}")
    out = torch.zeros((kh, kw, 1, c), dtype=torch.int32, device=xp.device)
    if b * oh * ow * c == 0:
        return out
    xp, gy = xp.contiguous(), gy.contiguous()
    err = _fgrad_lib().mh_dwconv_fgrad_acc(xp.data_ptr(), gy.data_ptr(), out.data_ptr(),
                                           b, hp, wp, c, kh, kw,
                                           torch.cuda.current_stream(xp.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_dwconv_fgrad kernel launch failed: CUDA error {err}")
    FGRAD_LAUNCHES += 1
    return out


def dwconv_fgrad_acc(xp: torch.Tensor, gy: torch.Tensor, kernel) -> torch.Tensor:
    """K5: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if xp.is_cuda:
        return dwconv_fgrad_acc_cuda(xp, gy, kernel)
    return dwconv_fgrad_acc_plain(xp, gy, kernel)
