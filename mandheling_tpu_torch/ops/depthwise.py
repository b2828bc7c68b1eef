"""NITI int8 depthwise convolution and average pooling (port of
``mandheling_tpu/ops/depthwise.py``).

Weights are (KH, KW, 1, C) HWIO, one filter per channel. Numerics follow the
NITI conv contract: int8 x int8 -> int32, forward and input-grad requant at
bw-7, filter grad at bw - margin, the shared code of ops/numerics.py.

- The accumulator is the "taps" form, the JAX package's default: KH*KW
  shifted multiply-adds (its "grouped" routing gives the same bytes and is
  not ported).
- Under the "cuda" backend a stride-1 forward, and every input grad whose
  pads are not negative, run through the two-phase fused kernel K4
  (``kernels/fused_dwconv_int8.py``) when its `supports` takes the padded
  (and, for a strided input grad, dilated) shape, as under the JAX
  package's Pallas backends. K4 takes x unpadded with its pads, gy
  undilated with the stride as its dilation, w with its 180-degree
  rotation by index, and the per-channel forms' alignment shifts: so the
  per-channel forms take it too, where their per-tensor twins do (the JAX
  package computes them with the same bytes outside Pallas, by the taps and
  a shift). The strided forward runs the taps as plain torch ops on the
  tensor's device, as in the JAX package.
- The filter grad is a sum over (b, oh, ow) of tap products; the int32 sum
  wraps as XLA's does. Under the "cuda" backend every one that K5's
  `fgrad_takes` takes, strided ones included, runs through the filter-grad
  kernel K5 (``kernels/fused_dwconv_int8.dwconv_fgrad_acc``) with x
  unpadded, its pads and the stride, in every fused mode, as the int8 GEMM
  K1 follows the backend; every one under the "torch" backend runs the taps
  as plain torch ops (the JAX package computes them all as a batch-grouped
  conv, outside Pallas, with the same bytes).
- A per-channel exponent vector (``nn/init.niti_xavier_int8_dw_per_channel``)
  is aligned to the smallest channel exponent by shifts capped by
  :func:`pc_shift_cap`.
- With a replica `group` (JAX's `axis_name`), the forward and input-grad
  range estimates take the maximum over it, between K4's two phases on the
  fused route, and the filter grad hands K5's int32 accumulator and the
  per-channel shift to ops/allreduce.py, which sums over the group first.
- Every public contraction op counts its work from its shapes
  (ops/flops.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch

from . import allreduce, flops, numerics
from .conv import (_fused_enabled, _input_grad_pads, get_fgrad_margin, get_fused_conv_mode,
                   resolve_padding, set_fgrad_margin)
from .kernels import fused_dwconv_int8 as _fdw
from .kernels import pool_concat_int8 as _pc
from .kernels import requant_int32 as _rq
from .kernels.conv_int8 import pad_hw
from .kernels.dispatch import get_backend

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def pc_shift_cap(taps: int) -> int:
    """Largest alignment left shift such that the worst-case |acc| of `taps`
    int8*int8 products stays int32: taps*127^2 << cap < 2^31 (3x3 -> 12,
    5x5 -> 11, 7x7 -> 10)."""
    return 30 - math.ceil(math.log2(taps * 127 * 127))


def check_pc_spread(w_exp: torch.Tensor, taps: int) -> None:
    """Raise if a per-channel exponent vector spreads wider than the
    int32-safe alignment cap. Reads the exponents on the host."""
    if w_exp.dim() == 0:
        return
    cap = pc_shift_cap(taps)
    spread = int(w_exp.max()) - int(w_exp.min())
    if spread > cap:
        raise ValueError(
            f"per-channel dw exponent spread {spread} exceeds the int32-safe "
            f"alignment cap {cap} for a {taps}-tap kernel; re-initialize with "
            "niti_xavier_int8_dw_per_channel (which floors the per-channel "
            "range) or narrow the exponents"
        )


def _per_channel_shifts(w_exp: torch.Tensor, taps: int = 9):
    """(e_base 0-d, shift_c vector or None) for a per-tensor (0-d) or a
    per-channel ((C,)) weight exponent. The vector case aligns every channel
    to the smallest exponent by a left shift of exp_c - min exp_c, clipped
    to the cap.

    The spread check reads the exponents on the host, so it runs here only
    for a CPU tensor; on the card the layer ran it when its exponents were
    set (NITI-SGD never changes them), as the JAX package runs it only on a
    concrete value and not inside a traced step."""
    w_exp = w_exp.to(torch.int32)
    if w_exp.dim() == 0:
        return w_exp, None
    if w_exp.device.type == "cpu":
        check_pc_spread(w_exp, taps)
    e_base = w_exp.amin()
    return e_base, torch.clamp(w_exp - e_base, 0, pc_shift_cap(taps))


# Depthwise filter-grad requant margin (shift = bw - margin). The dense NITI
# contract is 2; the MobileNetV2 recipe (MobilenetV2Train) sets 0 for the
# dense and the depthwise filter grads.
_DW_FGRAD_MARGIN = 2


def set_dw_fgrad_margin(margin: int) -> None:
    global _DW_FGRAD_MARGIN
    _DW_FGRAD_MARGIN = int(margin)


def get_dw_fgrad_margin() -> int:
    return _DW_FGRAD_MARGIN


@contextlib.contextmanager
def recipe_margins(dense: int = 0, dw: int = 0):
    """Dense and depthwise filter-grad margins `dense`/`dw` while inside
    (by default 0/0, the MobileNetV2 recipe's, DIVERGENCE_r05.json); the
    caller's margins come back after, whatever happens."""
    saved = (get_fgrad_margin(), get_dw_fgrad_margin())
    set_fgrad_margin(dense)
    set_dw_fgrad_margin(dw)
    try:
        yield
    finally:
        set_fgrad_margin(saved[0])
        set_dw_fgrad_margin(saved[1])


def _work(args, out_size: int) -> Tuple[int, int]:
    """(multiply-adds, bytes) of the depthwise conv of args["x"] by
    args["w"]: both read once, the output written once (`out_size` bytes an
    element)."""
    x, w = args["x"], args["w"]
    b, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    pads = resolve_padding(args["padding"], (kh, kw), args["stride"], (h, wd))
    oh, ow = flops.conv_out((h, wd), (kh, kw), args["stride"], pads)
    return b * oh * ow * kh * kw * c, flops.nbytes(x, w) + b * oh * ow * c * out_size


def _input_grad_work(args) -> Tuple[int, int]:
    gy, w = args["gy"], args["w"]
    return flops.grad_work(gy, w, w.shape[0] * w.shape[1], 1,
                           (gy.shape[0], *args["x_spatial"], gy.shape[-1]), 1)


def _filter_grad_work(args, out_size: int) -> Tuple[int, int]:
    x, gy = args["x"], args["gy"]
    (kh, kw), c = args["kernel_spatial"], x.shape[-1]
    return flops.grad_work(gy, x, kh * kw, 1, (kh, kw, 1, c), out_size)


@flops.counted(lambda args: _work(args, 4))
def dwconv2d_int8_acc(x: torch.Tensor, w: torch.Tensor,
                      stride: Sequence[int] = (1, 1), padding="SAME") -> torch.Tensor:
    """int8 NHWC x, (KH, KW, 1, C) w -> int32 depthwise accumulator."""
    pad = resolve_padding(padding, w.shape[:2], stride, x.shape[1:3])
    return _fdw.dwconv_acc_plain(pad_hw(x, pad), w, tuple(stride))


def _fused_dw_requant(x: torch.Tensor, w: torch.Tensor, pad: Pads,
                      dilation: Tuple[int, int] = (1, 1),
                      pc_shift: Optional[torch.Tensor] = None, rot180: bool = False,
                      group=None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The stride-1 depthwise conv of x, padded by `pad` after zero-dilation
    by `dilation`, with w (rotated by 180 degrees if `rot180`), each channel's
    accumulator shifted left by `pc_shift`, through the two-phase fused
    kernel K4, forward requant -> (int8 y, eff_shift); or None where
    `supports` refuses the padded, dilated shape, as the JAX package's rule
    does. The maximum over `group` sits between the phases (JAX
    `ops/depthwise.py:83-108`)."""
    if get_fused_conv_mode() == "off":
        return None
    kh, kw, _, c = w.shape
    b, h, wd, _ = x.shape
    (pt, pb), (pl, pr) = pad
    hp = (h - 1) * dilation[0] + 1 + pt + pb
    wp = (wd - 1) * dilation[1] + 1 + pl + pr
    if not _fdw.supports(b, hp, wp, hp - kh + 1, wp - kw + 1, c):
        return None
    k4 = dict(pads=pad, dilation=dilation, pc_shift=pc_shift, rot180=rot180)
    m = allreduce.maybe_pmax(_fdw.dwconv_max(x, w, **k4), group)
    eff_shift = numerics.forward_shift(numerics.range_estimate_from_max(m))
    return _fdw.dwconv_requant(x, w, eff_shift, False, **k4), eff_shift


@flops.counted(lambda args: _work(args, 1))
def dwconv2d_forward(
    x: torch.Tensor,
    x_exp: torch.Tensor,
    w: torch.Tensor,
    w_exp: torch.Tensor,
    stride: Sequence[int] = (1, 1),
    padding="SAME",
    act: Optional[str] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NITI int8 depthwise forward -> (int8 y, int32 exp_out)."""
    e_base, pc_shift = _per_channel_shifts(w_exp, w.shape[0] * w.shape[1])
    if _fused_enabled() and tuple(stride) == (1, 1):
        pad = resolve_padding(padding, w.shape[:2], stride, x.shape[1:3])
        fused = _fused_dw_requant(x, w, pad, pc_shift=pc_shift, group=group)
        if fused is not None:
            y, eff_shift = fused
            e = x_exp.to(torch.int32) + e_base + eff_shift
            return _rq.apply_act(y, e, act), e
    acc = _rq.Values(dwconv2d_int8_acc(x, w, stride, padding), pc_shift=pc_shift)
    m = allreduce.maybe_pmax(_rq.absmax(acc), group)
    return _rq.requant_forward(acc, m, (x_exp, e_base), act=act)


@flops.counted(_input_grad_work)
def dwconv2d_input_grad(
    gy: torch.Tensor,
    w: torch.Tensor,
    x_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1),
    padding="SAME",
    w_exp: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Transposed depthwise conv with rot180 weights (no io swap: one in,
    one out per channel) on the zero-dilated gy, bw-7 requant. A
    per-channel `w_exp` aligns each channel's accumulator to the smallest
    channel exponent before the per-tensor requant."""
    kh, kw = w.shape[0], w.shape[1]
    pc_shift = None
    if w_exp is not None and w_exp.dim() > 0:
        _, pc_shift = _per_channel_shifts(w_exp, kh * kw)
    pad = _input_grad_pads(w.shape, x_spatial, gy.shape[1:3], tuple(stride), padding)
    if _fused_enabled() and min(pad[0] + pad[1]) >= 0:
        fused = _fused_dw_requant(gy, w, pad, dilation=tuple(stride), pc_shift=pc_shift,
                                  rot180=True, group=group)
        if fused is not None:
            return fused[0]
    acc = _rq.Values(_fdw.dwconv_shifted_acc_plain(gy, w, pad, tuple(stride), rot180=True),
                     pc_shift=pc_shift)
    m = allreduce.maybe_pmax(_rq.absmax(acc), group)
    return _rq.requant_forward(acc, m)[0]


@flops.counted(lambda args: _filter_grad_work(args, 4))
def dwconv2d_filter_grad_acc(
    x: torch.Tensor, gy: torch.Tensor, kernel_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1), padding="SAME",
) -> torch.Tensor:
    """int32 (KH, KW, 1, C) accumulator:
    dw[dy,dx,0,c] = sum_{b,oh,ow} xp[b, oh*s+dy, ow*s+dx, c] * gy[b,oh,ow,c].
    Under the "cuda" backend K5 takes it, x unpadded with its pads and the
    stride, wherever `fgrad_takes` does; the rest, and everything under
    "torch", runs K5's plain taps, which keep the low 32 bits of int64
    sums, as XLA's int32 accumulation wraps (b256 at 32x32 can pass 2^31)."""
    kh, kw = kernel_spatial
    pads = resolve_padding(padding, (kh, kw), stride, x.shape[1:3])
    stride = tuple(stride)
    if get_backend() == "cuda" and _fdw.fgrad_takes(x.shape, gy.shape, (kh, kw), pads, stride):
        return _fdw.dwconv_fgrad_acc(x, gy, (kh, kw), stride, pads=pads)
    return _fdw.dwconv_fgrad_acc_plain(x, gy, (kh, kw), stride, pads=pads)


@flops.counted(lambda args: _filter_grad_work(args, 1))
def dwconv2d_filter_grad(
    x: torch.Tensor,
    gy: torch.Tensor,
    kernel_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1),
    padding="SAME",
    w_exp: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """int8 depthwise filter grad with the bw - margin shift. A per-channel
    `w_exp` expresses the accumulator (value units, uniform across channels)
    in each channel's own data units by a truncating right shift of
    exp_c - min exp_c before the per-tensor requant; with `group`, after
    the accumulators' sum over it (JAX `ops/depthwise.py:341-392`)."""
    kh, kw = kernel_spatial
    acc = dwconv2d_filter_grad_acc(x, gy, kernel_spatial, stride, padding)
    pc_shift = None
    if w_exp is not None and w_exp.dim() > 0:
        _, pc_vec = _per_channel_shifts(w_exp, kh * kw)
        pc_shift = pc_vec.reshape(1, 1, 1, -1)
    return allreduce.grad_allreduce_requant(acc, group, margin=_DW_FGRAD_MARGIN,
                                            pc_shift=pc_shift)


@flops.counted(lambda args: (0, 0))
def avgpool2d_int8(
    x: torch.Tensor, x_exp: torch.Tensor, window: Sequence[int],
    stride: Optional[Sequence[int]] = None, pad: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 VALID average pool of x zero-padded by `pad` a side: int32 window
    sum, division truncated toward zero by the window size, exponent
    passthrough. K8 (kernels/pool_concat_int8.py) under "cuda", which reads
    the pad as zeros; counted as no work, so that its launches are noted."""
    return _pc.avgpool(x, window, stride or window, pad), x_exp


@flops.counted(lambda args: (0, 0))
def avgpool2d_grad(
    gy: torch.Tensor, x_spatial: Tuple[int, int], window: Sequence[int],
    stride: Optional[Sequence[int]] = None, pad: int = 0,
) -> torch.Tensor:
    """Spread gy / |window| (truncating division) over each window; int32
    sums of overlapping windows clip to int8. `x_spatial` is the input's
    size before its `pad`, and so is the gradient's."""
    return _pc.avgpool_grad(gy, x_spatial, window, stride or window, pad)
