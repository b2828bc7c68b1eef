"""K3: the two-phase fused NITI conv, a hand-written Hopper kernel
(``csrc/fused_conv_int8.cu``) and its plain PyTorch version.

Replaces the TPU kernels of ``mandheling_tpu/ops/kernels/fused_conv_int8.py``:
``_max_kernel`` (``conv_max_pallas``) and ``_requant_kernel``
(``conv_requant_pallas``). It keeps their contract, not their banding: an
implicit-GEMM int8 conv on K1's and K2's ``wgmma`` mainloops
(``csrc/gemm_s8_sm90.cuh``) whose A tile each block gathers from the NHWC
input by ``cp.async`` (16 channels of one tap a copy where C % 16 == 0 and
x is 16-byte aligned; a funnel-shift byte path otherwise), with the stride
and the pads applied there, and K2's two epilogues. The wrapper copies the
HWIO weight K-major once per call (one copy into a buffer kept per stream
and shape), each kernel row's KW*C bytes padded with zeros to a multiple of
16 (:func:`kmajor_weight`), since 8-bit ``wgmma`` takes no transposed
operand.

- phase 1 (:func:`conv_max`): max|conv(x, w)| as a 0-d int32 in one launch
  (a two-int state per stream, back at its initial value after each call);
  the int32 accumulator never reaches device memory.
- glue (the caller, ``ops/conv.py``): ``range_estimate_from_max`` and
  ``forward_shift`` on the device.
- phase 2 (:func:`conv_requant`): recompute the conv and apply the psto
  epilogue, reading the shift from device memory, writing int8 only.

Bound on an H100: the bytes at the stems and LeNet's convs; the tensor
cores' operations at ResNet18's 3x3 convs (see the CUDA source).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import numerics
from . import build
from .conv_int8 import conv_acc
from .matmul_int8 import matmul_acc_plain
from .stream_state import per_stream

# Launches of the two CUDA kernels (plain integers; counted where they launch).
MAX_LAUNCHES = 0
REQUANT_LAUNCHES = 0

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

_BAND_BUDGET = 4 * 2**20


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supports(w_shape, padded_width: int, stride, band_budget: int = _BAND_BUDGET) -> bool:
    """The JAX package's eligibility rule, unchanged (its band-matrix VMEM
    budget), so that the same shapes take the fused route on both.
    `padded_width` is the input width including the conv's padding."""
    kh, kw, ic, oc = w_shape
    sw = stride[1]
    ow = (padded_width - kw) // sw + 1
    if ow < 1:
        return False
    bn = min(_round_up(ow * oc, 128), 512)
    return kh * padded_width * ic * bn <= band_budget


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_conv_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mh_fused_conv_max.argtypes = [p, p, p, p] + [i] * 14 + [p]
    lib.mh_fused_conv_max.restype = ctypes.c_int
    lib.mh_fused_conv_requant.argtypes = [p, p, p, p] + [i] * 15 + [p]
    lib.mh_fused_conv_requant.restype = ctypes.c_int
    return lib


def _out_spatial(x: torch.Tensor, w: torch.Tensor, pad: Pads, stride) -> Tuple[int, int]:
    kh, kw = w.shape[:2]
    hp = x.shape[1] + pad[0][0] + pad[0][1]
    wp = x.shape[2] + pad[1][0] + pad[1][1]
    return (hp - kh) // stride[0] + 1, (wp - kw) // stride[1] + 1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"need NHWC x and HWIO w, got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands only, got {x.dtype}, {w.dtype}")


def conv_acc_plain(x: torch.Tensor, w: torch.Tensor, pad: Pads,
                   stride=(1, 1)) -> torch.Tensor:
    """int32 NHWC accumulator of the conv, exact on any device (im2col and
    the float64 GEMM of K1's plain version)."""
    _check(x, w)
    return conv_acc(x, w, tuple(stride), pad, matmul=matmul_acc_plain)


def conv_max_plain(x, w, pad: Pads, stride=(1, 1)) -> torch.Tensor:
    return numerics.abs_max(conv_acc_plain(x, w, pad, stride))


def conv_requant_plain(x, w, shift: torch.Tensor, pad: Pads, stride=(1, 1),
                       grad: bool = False) -> torch.Tensor:
    return numerics.psto_epilogue(conv_acc_plain(x, w, pad, stride), shift, grad)


def run_bytes(w_shape) -> int:
    """R: the bytes of K one kernel row takes in the kernel's layout, its
    KW*C taps rounded up to 16."""
    return _round_up(w_shape[1] * w_shape[2], 16)


def kmajor_weight(w: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The HWIO weight as K3's B, K-major: (OC, KH * R) with row n holding,
    for each kernel row dy, w[dy, :, :, n] flattened and zeros up to R.
    Written into `out` ((OC, KH, R) int8, its run tails already zero) where
    given: one copy."""
    kh, kw, c, oc = w.shape
    run, r = kw * c, run_bytes(w.shape)
    if out is None:
        out = torch.zeros((oc, kh, r), dtype=w.dtype, device=w.device)
    out[:, :, :run].copy_(w.reshape(kh, run, oc).permute(2, 0, 1))
    return out.reshape(oc, kh * r)


def _kmajor_buffer(device: torch.device, stream: int, w_shape) -> torch.Tensor:
    """A zeroed (OC, KH, R) int8 buffer for `kmajor_weight`, one per CUDA
    stream and weight shape (stream_state.py): each call rewrites the same
    bytes before its launch on that stream, so the run tails stay zero and
    one copy a call is all the weight costs (a fresh allocation is 16-byte
    aligned)."""
    kh, _, _, oc = w_shape
    return per_stream(("fused_conv_kmajor", device, stream, tuple(w_shape)),
                      lambda: torch.zeros((oc, kh, run_bytes(w_shape)), dtype=torch.int8,
                                          device=device))


def _make_state(device: torch.device) -> torch.Tensor:
    state = torch.zeros(2, dtype=torch.int32, device=device)
    state[0].fill_(-(2**31))
    return state


def _state(device: torch.device, stream: int) -> torch.Tensor:
    """Phase 1's two ints {INT32_MIN, 0} (the running max, the block ticket)
    for the CUDA stream `stream` of `device` (stream_state.py): filled on
    the device once, while that stream is current; every call leaves them
    so."""
    return per_stream(("fused_conv_state", device, stream), lambda: _make_state(device))


def _geometry(x: torch.Tensor, w: torch.Tensor, pad: Pads, stride):
    _check(x, w)
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"K3 needs x and w on one CUDA device, got {x.device}, {w.device}")
    if min(pad[0] + pad[1]) < 0:
        raise ValueError(f"K3 takes no negative pads, got {pad}")
    b, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    oh, ow = _out_spatial(x, w, pad, stride)
    if b * max(oh, 0) * max(ow, 0) >= 2**31 or x.numel() >= 2**31:
        raise ValueError("K3 indexes rows with int32")
    geom = [b, h, wd, c, oh, ow, oc, kh, kw, stride[0], stride[1], pad[0][0], pad[1][0],
            run_bytes(w.shape)]
    return x.contiguous(), w, (b, max(oh, 0), max(ow, 0), oc), geom


def conv_max_cuda(x: torch.Tensor, w: torch.Tensor, pad: Pads, stride=(1, 1)) -> torch.Tensor:
    """Phase 1 on the card -> 0-d int32 max|conv| (INT32_MIN when empty),
    in one launch."""
    global MAX_LAUNCHES
    x, w, (b, oh, ow, oc), geom = _geometry(x, w, pad, stride)
    if b * oh * ow * oc == 0:
        return torch.full((), -(2**31), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wk = kmajor_weight(w, _kmajor_buffer(x.device, stream, tuple(w.shape)))
    out = torch.empty((), dtype=torch.int32, device=x.device)
    err = _lib().mh_fused_conv_max(x.data_ptr(), wk.data_ptr(), _state(x.device, stream).data_ptr(),
                                   out.data_ptr(), *geom, stream)
    if err:
        raise RuntimeError(f"fused_conv_max kernel launch failed: CUDA error {err}")
    MAX_LAUNCHES += 1
    return out


def conv_requant_cuda(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, pad: Pads,
                      stride=(1, 1), grad: bool = False) -> torch.Tensor:
    """Phase 2 on the card -> int8 NHWC (B, OH, OW, OC); `shift` is a 0-d
    int32 on the operands' device and is read there by the kernel."""
    global REQUANT_LAUNCHES
    x, w, (b, oh, ow, oc), geom = _geometry(x, w, pad, stride)
    if shift.device != x.device or shift.numel() != 1:
        raise ValueError("shift must be a one-element tensor on the operands' device")
    shift = shift.to(torch.int32).contiguous()
    y = torch.empty((b, oh, ow, oc), dtype=torch.int8, device=x.device)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wk = kmajor_weight(w, _kmajor_buffer(x.device, stream, tuple(w.shape)))
    err = _lib().mh_fused_conv_requant(x.data_ptr(), wk.data_ptr(), shift.data_ptr(),
                                       y.data_ptr(), *geom, int(grad), stream)
    if err:
        raise RuntimeError(f"fused_conv_requant kernel launch failed: CUDA error {err}")
    REQUANT_LAUNCHES += 1
    return y


def conv_max(x: torch.Tensor, w: torch.Tensor, pad: Pads, stride=(1, 1)) -> torch.Tensor:
    """Phase 1: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if x.is_cuda:
        return conv_max_cuda(x, w, pad, stride)
    return conv_max_plain(x, w, pad, stride)


def conv_requant(x: torch.Tensor, w: torch.Tensor, shift: torch.Tensor, pad: Pads,
                 stride=(1, 1), grad: bool = False) -> torch.Tensor:
    """Phase 2: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if x.is_cuda:
        return conv_requant_cuda(x, w, shift, pad, stride, grad)
    return conv_requant_plain(x, w, shift, pad, stride, grad)
