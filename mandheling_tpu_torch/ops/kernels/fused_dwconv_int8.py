"""K4, the two-phase fused NITI depthwise conv, and K5, the depthwise
filter-grad accumulator: hand-written Hopper kernels
(``csrc/fused_dwconv_int8.cu``, ``csrc/fused_dwconv_fgrad_int8.cu``) and
their plain PyTorch versions.

K4 replaces the TPU kernels of ``mandheling_tpu/ops/kernels/fused_dwconv_int8.py``
``_max_kernel`` (``dwconv_max_pallas``) and ``_requant_kernel``
(``dwconv_requant_pallas``): a VALID stride-1 depthwise conv with the
(KH, KW, 1, C) weight w over a padded input (B, Hp, Wp, C),

- phase 1 (:func:`dwconv_max`): max|acc| as a 0-d int32;
- phase 2 (:func:`dwconv_requant`): recompute the taps and apply the psto
  epilogue with the shift read from device memory, writing int8 only.

Its operands are wider than the TPU kernels', each computing in the kernel
what the port's callers computed in torch around it: x comes unpadded with
its `pads` ((top, bottom), (left, right), none negative), and optionally
zero-dilated by `dilation` (the input grad of a strided conv), with w
rotated by 180 degrees (`rot180`, the input grad's filter), and with a
per-channel left shift `pc_shift` (int32 (C,)) applied to each accumulator
before the max and the epilogue (the per-channel depthwise exponents'
alignment). With the defaults it is the TPU kernels' function on a
pre-padded x.

No channel contraction, so no tensor-core work: KH*KW multiply-adds of int8
operands into int32 per output on the CUDA cores. The 3x3 instance for
C % 4 == 0 (every depthwise layer of the MobileNets) takes four channels a
thread in a 32-bit word and walks a run of output rows per thread with its
window in registers, a row's 3 taps of a channel in one IDP4A; one untiled,
byte-wise instance takes every other input (any kernel size, as the JAX
kernel does, and any C).
Bound on an H100 at the MobileNetV2 shapes: phase 1 by bytes and integer
instructions alike, phase 2 by the psto epilogue's integer instructions on
the CUDA cores (see the CUDA source).

K5 (:func:`dwconv_fgrad_acc`) replaces the third TPU kernel here,
``_fgrad_kernel`` (``dwconv_fgrad_acc_pallas``): the int32 (KH, KW, 1, C)
filter-grad accumulator of a depthwise conv from its input and output diff
gy (B, OH, OW, C) in one launch, wrapping modulo 2^32 as the TPU kernel's
int32 sums do. Like K4 it takes x unpadded with its `pads`, and also a
stride, where the TPU kernel takes a pre-padded input at stride 1 only
(:func:`supports_fgrad`, its rule, unchanged); :func:`fgrad_takes` says
what K5 takes. No path of the JAX package routes that kernel (it computes
every depthwise filter grad as a batch-grouped conv, the same bytes); the
port routes every depthwise filter grad that K5 takes through it under the
"cuda" backend, strided ones included (``ops/depthwise.py``). The 3x3
instance for C % 4 == 0 at strides 1 and 2 takes four channels and four
output columns a thread, one IDP4A per tap, channel and four columns, each
x row read once; one untiled byte-wise instance takes every other input.
Bound: bytes (see the CUDA source).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import numerics
from . import build
from .conv_int8 import _dilate_hw, pad_hw
from .stream_state import per_stream

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
_NO_PADS: Pads = ((0, 0), (0, 0))

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


def fgrad_out_spatial(x_shape, kernel, pads: Pads = _NO_PADS, stride=(1, 1)) -> Tuple[int, int]:
    """The VALID strided output (OH, OW) of x padded by `pads` under `kernel`."""
    return tuple((n + lo + hi - k) // s + 1 if n + lo + hi >= k else 0
                 for n, (lo, hi), k, s in zip(x_shape[1:3], pads, kernel, stride))


def fgrad_takes(x_shape, gy_shape, kernel, pads: Pads = _NO_PADS, stride=(1, 1)) -> bool:
    """What K5 takes: x (B, H, W, C) and gy (B, OH, OW, C) with pads >= 0,
    any stride >= 1, gy within the VALID strided output of the padded x (the
    filter grad's own gy is that output), and int32-indexable tensors."""
    if len(x_shape) != 4 or len(gy_shape) != 4 or x_shape[0] != gy_shape[0] \
            or x_shape[3] != gy_shape[3]:
        return False
    if min(min(pads[0]), min(pads[1])) < 0 or min(stride) < 1 or min(kernel) < 1:
        return False
    oh, ow = fgrad_out_spatial(x_shape, kernel, pads, stride)
    if gy_shape[1] > oh or gy_shape[2] > ow:
        return False
    return math.prod(x_shape) < 2**31 and math.prod(gy_shape) < 2**31


def dwconv_fgrad_acc_plain(xp: torch.Tensor, gy: torch.Tensor, kernel,
                           stride=(1, 1), *, pads: Pads = _NO_PADS) -> torch.Tensor:
    """int32 (KH, KW, 1, C): sum over (b, oh, ow) of xp[b, oh*s+dy, ow*s+dx, c]
    * gy[b, oh, ow, c], with xp the input padded by `pads` (by default
    none: xp as given). torch sums the int32 products in int64; the low 32
    bits are kept, as the TPU kernel's int32 sums (and XLA's) wrap."""
    kh, kw = kernel
    sh, sw = stride
    xp = pad_hw(xp, pads)
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


def dwconv_shifted_acc_plain(x: torch.Tensor, w: torch.Tensor, pads: Pads = _NO_PADS,
                             dilation=(1, 1), pc_shift: Optional[torch.Tensor] = None,
                             rot180: bool = False) -> torch.Tensor:
    """The accumulator K4 sees: the taps of w (rotated by 180 degrees if
    `rot180`) over x zero-dilated by `dilation` and padded by `pads`, each
    channel left-shifted by `pc_shift` (int32 << wraps, as XLA's does)."""
    if rot180:
        w = torch.flip(w, dims=(0, 1))
    acc = dwconv_acc_plain(pad_hw(_dilate_hw(x, *dilation), pads), w)
    return acc if pc_shift is None else acc << pc_shift


def dwconv_max_plain(x: torch.Tensor, w: torch.Tensor, *, pads: Pads = _NO_PADS,
                     dilation=(1, 1), pc_shift: Optional[torch.Tensor] = None,
                     rot180: bool = False) -> torch.Tensor:
    return numerics.abs_max(dwconv_shifted_acc_plain(x, w, pads, dilation, pc_shift, rot180))


def dwconv_requant_plain(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                         grad: bool = False, *, pads: Pads = _NO_PADS, dilation=(1, 1),
                         pc_shift: Optional[torch.Tensor] = None,
                         rot180: bool = False) -> torch.Tensor:
    return numerics.psto_epilogue(
        dwconv_shifted_acc_plain(x, w, pads, dilation, pc_shift, rot180), shift, grad)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_dwconv_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mh_fused_dwconv_max.argtypes = [p] * 6 + [i] * 13 + [p]
    lib.mh_fused_dwconv_max.restype = ctypes.c_int
    lib.mh_fused_dwconv_requant.argtypes = [p, p, p, p, p] + [i] * 14 + [p]
    lib.mh_fused_dwconv_requant.restype = ctypes.c_int
    return lib


def _prepare(x: torch.Tensor, w: torch.Tensor, pads: Pads, dilation, pc_shift, rot180: bool):
    """Checks K4's operands -> (x, w, pc_shift or None, output shape, the
    kernel's int arguments B, H, W, C, KH, KW, pt, pl, dh, dw, OH, OW, rot)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != 1 or w.shape[3] != x.shape[3]:
        raise ValueError(f"need x (B, H, W, C) and w (KH, KW, 1, C), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {x.dtype}, {w.dtype}")
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"K4 needs x and w on one CUDA device, got {x.device}, {w.device}")
    (pt, pb), (pl, pr) = pads
    dh, dw = dilation
    if min(pt, pb, pl, pr) < 0 or min(dh, dw) < 1:
        raise ValueError(f"K4 takes pads >= 0 and dilations >= 1, got {pads}, {dilation}")
    kh, kw, _, c = w.shape
    b, h, wd, _ = x.shape
    oh = max((h - 1) * dh + 1 + pt + pb - kh + 1, 0) if h else 0
    ow = max((wd - 1) * dw + 1 + pl + pr - kw + 1, 0) if wd else 0
    if x.numel() >= 2**31 or b * oh * ow * c >= 2**31:
        raise ValueError(f"K4 takes int32-indexable tensors, got x {tuple(x.shape)}")
    if pc_shift is not None:
        if pc_shift.shape != (c,) or pc_shift.dtype != torch.int32 or pc_shift.device != x.device:
            raise ValueError(f"pc_shift must be int32 ({c},) on {x.device}, got "
                             f"{pc_shift.dtype} {tuple(pc_shift.shape)} on {pc_shift.device}")
        pc_shift = pc_shift.contiguous()
    dims = [b, h, wd, c, kh, kw, pt, pl, dh, dw, oh, ow, int(rot180)]
    return x.contiguous(), w.contiguous(), pc_shift, (b, oh, ow, c), dims


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """Phase 1's block counter for the CUDA stream `stream` of `device`
    (stream_state.py): zeroed once, while that stream is current; the
    kernel leaves it at 0."""
    return per_stream(("fused_dwconv_ticket", device, stream),
                      lambda: torch.zeros((1,), dtype=torch.int32, device=device))


def dwconv_max_cuda(x: torch.Tensor, w: torch.Tensor, *, pads: Pads = _NO_PADS,
                    dilation=(1, 1), pc_shift: Optional[torch.Tensor] = None,
                    rot180: bool = False) -> torch.Tensor:
    """Phase 1 on the card -> 0-d int32 max|acc| (INT32_MIN when empty), in
    one launch: each block leaves its max in a scratch word, and the last
    block to finish reduces them (its ticket, one per stream, returns to 0)."""
    global MAX_LAUNCHES
    x, w, pc_shift, (b, oh, ow, c), dims = _prepare(x, w, pads, dilation, pc_shift, rot180)
    if b * oh * ow * c == 0:
        return torch.full((), -(2**31), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    out = torch.empty((), dtype=torch.int32, device=x.device)
    partials = torch.empty((-(-b * oh * ow * c // 256),), dtype=torch.int32, device=x.device)
    err = _lib().mh_fused_dwconv_max(x.data_ptr(), w.data_ptr(), _ptr(pc_shift), out.data_ptr(),
                                     partials.data_ptr(),
                                     _ticket(x.device, stream.cuda_stream).data_ptr(), *dims,
                                     stream.cuda_stream)
    if err:
        raise RuntimeError(f"fused_dwconv_max kernel launch failed: CUDA error {err}")
    MAX_LAUNCHES += 1
    return out


def dwconv_requant_cuda(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                        grad: bool = False, *, pads: Pads = _NO_PADS, dilation=(1, 1),
                        pc_shift: Optional[torch.Tensor] = None,
                        rot180: bool = False) -> torch.Tensor:
    """Phase 2 on the card -> int8 (B, OH, OW, C); `shift` is a 0-d int32 on
    x's device and is read there by the kernel."""
    global REQUANT_LAUNCHES
    x, w, pc_shift, shape, dims = _prepare(x, w, pads, dilation, pc_shift, rot180)
    if shift.device != x.device or shift.numel() != 1:
        raise ValueError("shift must be a one-element tensor on x's device")
    shift = shift.to(torch.int32).contiguous()
    y = torch.empty(shape, dtype=torch.int8, device=x.device)
    if y.numel() == 0:
        return y
    err = _lib().mh_fused_dwconv_requant(x.data_ptr(), w.data_ptr(), _ptr(pc_shift),
                                         shift.data_ptr(), y.data_ptr(), *dims, int(grad),
                                         torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_dwconv_requant kernel launch failed: CUDA error {err}")
    REQUANT_LAUNCHES += 1
    return y


def dwconv_max(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """Phase 1: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if x.is_cuda:
        return dwconv_max_cuda(x, w, **kw)
    return dwconv_max_plain(x, w, **kw)


def dwconv_requant(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor,
                   grad: bool = False, **kw) -> torch.Tensor:
    """Phase 2: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if x.is_cuda:
        return dwconv_requant_cuda(x, w, shift, grad, **kw)
    return dwconv_requant_plain(x, w, shift, grad, **kw)


@functools.lru_cache(maxsize=None)
def _fgrad_lib() -> ctypes.CDLL:
    lib = build.library("fused_dwconv_fgrad_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mh_dwconv_fgrad_acc.argtypes = [p] * 5 + [i] * 12 + [p]
    lib.mh_dwconv_fgrad_acc.restype = ctypes.c_int
    return lib


def _fgrad_state(device: torch.device, stream: int, taps_c: int, columns: int) -> torch.Tensor:
    """K5's scratch accumulator (taps_c words) and column tickets for the
    CUDA stream `stream` of `device` (stream_state.py): zeroed once, while
    that stream is current; every call leaves them at 0."""
    return per_stream(("fused_dwconv_fgrad_state", device, stream, taps_c, columns),
                      lambda: torch.zeros((taps_c + columns,), dtype=torch.int32, device=device))


def dwconv_fgrad_acc_cuda(x: torch.Tensor, gy: torch.Tensor, kernel, stride=(1, 1), *,
                          pads: Pads = _NO_PADS) -> torch.Tensor:
    """K5 on the card -> int32 (KH, KW, 1, C), from x unpadded with its
    `pads` and the `stride`, in one launch: blocks add into a scratch
    accumulator and the last block of each 32-channel column moves its sums
    out (the scratch and tickets, one set per stream and size, return to 0)."""
    global FGRAD_LAUNCHES
    kh, kw = kernel
    if x.dim() != 4 or gy.dim() != 4:
        raise ValueError(f"need x (B, H, W, C) and gy (B, OH, OW, C), got "
                         f"{tuple(x.shape)}, {tuple(gy.shape)}")
    if x.dtype != torch.int8 or gy.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {x.dtype}, {gy.dtype}")
    if not (x.is_cuda and gy.is_cuda) or x.device != gy.device:
        raise ValueError(f"K5 needs x and gy on one CUDA device, got {x.device}, {gy.device}")
    if not fgrad_takes(tuple(x.shape), tuple(gy.shape), (kh, kw), pads, stride):
        raise ValueError(f"K5 takes gy within the VALID output of x padded by pads >= 0 at "
                         f"stride >= 1, int32-indexable: got x {tuple(x.shape)}, gy "
                         f"{tuple(gy.shape)}, {kh}x{kw}, pads {pads}, stride {stride}")
    b, h, w, c = x.shape
    oh, ow = gy.shape[1], gy.shape[2]
    if b * oh * ow * c == 0 or x.numel() == 0:
        return torch.zeros((kh, kw, 1, c), dtype=torch.int32, device=x.device)
    x, gy = x.contiguous(), gy.contiguous()
    out = torch.empty((kh, kw, 1, c), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    columns = -(-c // 32)
    state = _fgrad_state(x.device, stream.cuda_stream, kh * kw * c, columns)
    (pt, _), (pl, _) = pads
    err = _fgrad_lib().mh_dwconv_fgrad_acc(
        x.data_ptr(), gy.data_ptr(), out.data_ptr(), state.data_ptr(),
        state[kh * kw * c:].data_ptr(), b, h, w, c, kh, kw, pt, pl, stride[0], stride[1], oh, ow,
        stream.cuda_stream)
    if err:
        raise RuntimeError(f"fused_dwconv_fgrad kernel launch failed: CUDA error {err}")
    FGRAD_LAUNCHES += 1
    return out


def dwconv_fgrad_acc(x: torch.Tensor, gy: torch.Tensor, kernel, stride=(1, 1), *,
                     pads: Pads = _NO_PADS) -> torch.Tensor:
    """K5: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if x.is_cuda:
        return dwconv_fgrad_acc_cuda(x, gy, kernel, stride, pads=pads)
    return dwconv_fgrad_acc_plain(x, gy, kernel, stride, pads=pads)
