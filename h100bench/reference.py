"""Plain PyTorch reference of one NITI train step: the layers, the loss and
the update. The networks are built from them by one file a family,
families/<family>.py. It imports nothing of the program under test.

The arithmetic is the NITI contract (Wang et al., "NITI: Training Integer
Neural Networks Using Integer-only Arithmetic", arXiv:2009.13108, and the
Mandheling recipe): int8 data with one power-of-two exponent a tensor,
int32 accumulation, the range estimate bw = ceil(log2 max|acc|), the
pseudo-stochastic right shift, forward and input-gradient requant at
bw - 7, filter-gradient requant at bw - margin, the integer softmax
cross-entropy gradient shifted by 4, and the update w <- clip(w - g).

Every contraction is an im2col product in float64 (exact: every partial
sum of int8 products is an integer below 2^53; the int64 -> int32 cast
wraps as an int32 accumulator does) or a sum of depthwise taps in int32
and int64. Nothing here reads a device value on the host, so a step runs
on any device, the meta device included.

A layer has fwd(x, e, ctx) -> (y, exponent, residual), bwd(residual, gy,
ctx, need_input_grad) -> (gx, [(layer, weight grad)]) and out_shape(shape)
of its NHWC input shape. A layer with a weight has `weight_shape`, `w` and
`w_exp`; a composite layer has `branches`, the layer lists that all read
its input, in the order of the program's modules. weighted() and the work
count (work.py) read nothing else, so a family file can define a layer of
its own.

`Precision(bits)` sets the width every activation and gradient is
requantized to: 7 magnitude bits (int8, the configurations' precision), or
3 (int4) for the control that must come out not correct. Weights stay int8
in both.
"""

from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


@dataclass(frozen=True)
class Precision:
    """Magnitude bits of the requantized tensors: 7 for int8, 3 for int4."""

    bits: int = 7

    @property
    def rail(self) -> int:
        return (1 << self.bits) - 1


INT8 = Precision(7)
INT4 = Precision(3)


# ---------------------------------------------------------------- numerics

def _i32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


def _mask(s: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(s), s) - 1


def trunc_shift(x: torch.Tensor, s) -> torch.Tensor:
    """x / 2^s truncated toward zero (s >= 0), int32."""
    x = x.to(torch.int32)
    s = _i32(s, x.device)
    return (x + torch.bitwise_and(x >> 31, _mask(s))) >> s


def psto(acc: torch.Tensor, shift, rail: int) -> torch.Tensor:
    """Pseudo-stochastic right shift by `shift` (clamped to [0, 30]) of an
    int32 tensor, clipped to [-rail, rail]: the truncated quotient, plus the
    sign where the remainder's high half exceeds its low half (doubled for
    an odd shift)."""
    acc = acc.to(torch.int32)
    shift = torch.clamp(_i32(shift, acc.device), 0, 30)
    q = (acc + torch.bitwise_and(acc >> 31, _mask(shift))) >> shift
    rem = torch.abs(acc - torch.bitwise_left_shift(q, shift))
    half = shift >> 1
    hi = rem >> half
    lo = torch.bitwise_left_shift(torch.bitwise_and(rem, _mask(half)),
                                  torch.bitwise_and(shift, 1))
    up = (hi > lo).to(torch.int32) * torch.sign(acc).to(torch.int32)
    return torch.clamp(q + up, -rail, rail)


def bits_of_max(m: torch.Tensor) -> torch.Tensor:
    """ceil(log2 m) of a non-negative int32 max, exactly: the number of k in
    [0, 31) with 2^k < m (0 for m <= 1, and for the negative |INT32_MIN|)."""
    m = m.to(torch.int32)
    powers = torch.bitwise_left_shift(torch.ones(31, dtype=torch.int32, device=m.device),
                                      torch.arange(31, dtype=torch.int32, device=m.device))
    return (m > powers).sum(dtype=torch.int32)


def abs_max(acc: torch.Tensor) -> torch.Tensor:
    return torch.abs(acc.to(torch.int32)).amax()


def wrap(x: torch.Tensor, p: Precision) -> torch.Tensor:
    """Two's-complement wrap of int32 values to bits + 1 bits (a plain cast)."""
    half = 1 << p.bits
    return torch.remainder(x.to(torch.int32) + half, 2 * half) - half


def requant_forward(acc: torch.Tensor, exp_in: torch.Tensor, p: Precision):
    """(data, exp_out) of an int32 accumulator: shift = bw - bits, 1 taken as
    2, none when <= 0 (then a plain wrapping cast); exp_out = exp_in + shift."""
    bw = bits_of_max(abs_max(acc))
    shift = bw - p.bits
    shift = torch.where(shift > 1, shift, torch.where(shift == 1, 2, 0).to(torch.int32))
    out = torch.where(shift > 0, psto(acc, shift, p.rail), wrap(acc, p))
    return out.to(torch.int8), exp_in.to(torch.int32) + shift


def requant_grad(acc: torch.Tensor, margin: int, p: Precision) -> torch.Tensor:
    """Filter-gradient requant: psto by bw - margin; all-zero stays zero."""
    bw = bits_of_max(abs_max(acc))
    out = psto(acc, bw - margin, p.rail).to(torch.int8)
    return torch.where(bw == 0, torch.zeros_like(out), out)


def clip(x: torch.Tensor, rail: int) -> torch.Tensor:
    return torch.clamp(x.to(torch.int32), -rail, rail).to(torch.int8)


# ---------------------------------------------------------------- geometry

def same_or_valid(padding: str, kernel, stride, spatial) -> Pads:
    """Per-edge pads of "SAME" (out = ceil(in / stride), the odd pixel at
    the end) or "VALID"."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    pads = []
    for n, k, s in zip(spatial, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return (pads[0], pads[1])


def transposed_pads(kernel, x_spatial, gy_spatial, stride, padding: str) -> Pads:
    """Pads of the transposed conv (full correlation of the zero-dilated gy)
    whose output has the forward input's size."""
    (pt, _), (pl, _) = same_or_valid(padding, kernel, stride, x_spatial)
    out = []
    for k, p0, n, m, s in zip(kernel, (pt, pl), x_spatial, gy_spatial, stride):
        lo = k - 1 - p0
        out.append((lo, n - ((m - 1) * s + 1) - lo + k - 1))
    return (out[0], out[1])


def pad(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    """Zero-pad H and W of NHWC (negative pads crop)."""
    (t, b), (l, r) = pads
    return x if (t, b, l, r) == (0, 0, 0, 0) else F.pad(x, (0, 0, l, r, t, b))


def dilate(x: torch.Tensor, stride) -> torch.Tensor:
    """Insert stride - 1 zeros between the pixels of NHWC."""
    sh, sw = stride
    if (sh, sw) == (1, 1):
        return x
    b, h, w, c = x.shape
    out = x.new_zeros((b, (h - 1) * sh + 1, (w - 1) * sw + 1, c))
    out[:, ::sh, ::sw, :] = x
    return out


def conv_spatial(spatial, kernel, stride, padding: str) -> Tuple[int, int]:
    """Output H and W of a conv or pool with "SAME" or "VALID" padding."""
    pads = same_or_valid(padding, kernel, stride, spatial)
    return tuple((n + p[0] + p[1] - k) // s + 1
                 for n, p, k, s in zip(spatial, pads, kernel, stride))


def windows(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """(B, OH, OW, KH, KW, C) strided view of the VALID windows of NHWC x."""
    kh, kw = kernel
    sh, sw = stride
    b, h, w, c = x.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    sb, s_h, s_w, sc = x.stride()
    return x.as_strided((b, oh, ow, kh, kw, c), (sb, s_h * sh, s_w * sw, s_h, s_w, sc))


def patches(x: torch.Tensor, kernel, stride) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """VALID windows of a padded NHWC tensor as (B*OH*OW, KH*KW*C) rows,
    ordered (kh, kw, c)."""
    win = windows(x, kernel, stride)
    b, oh, ow, kh, kw, c = win.shape
    return win.reshape(b * oh * ow, kh * kw * c), (oh, ow)


def scatter(taps: Sequence[torch.Tensor], kernel, stride, spatial) -> torch.Tensor:
    """The int32 (B, H, W, C) sum of the window taps' (B, OH, OW, C)
    tensors, each put back where its tap read: taps[i * KW + j] for tap
    (i, j) of windows of `kernel` and `stride` over H, W = `spatial`."""
    kh, kw = kernel
    sh, sw = stride
    b, oh, ow, c = taps[0].shape
    out = torch.zeros((b, *spatial, c), dtype=torch.int32, device=taps[0].device)
    for i in range(kh):
        for j in range(kw):
            out[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :] += \
                taps[i * kw + j].to(torch.int32)
    return out


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32, exact, wrapping as int32 does."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64).to(torch.int32)


def conv_acc(x: torch.Tensor, w: torch.Tensor, stride, pads: Pads) -> torch.Tensor:
    """int32 NHWC accumulator of x (NHWC) by w (HWIO)."""
    kh, kw, ic, oc = w.shape
    rows, (oh, ow) = patches(pad(x, pads), (kh, kw), stride)
    return exact_matmul(rows, w.reshape(kh * kw * ic, oc)).reshape(x.shape[0], oh, ow, oc)


def dw_taps(xp: torch.Tensor, w: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
    """int32 accumulator of the VALID depthwise conv of a padded NHWC x by
    w (KH, KW, 1, C)."""
    kh, kw, _, c = w.shape
    sh, sw = stride
    b, h, wd, _ = xp.shape
    oh, ow = (h - kh) // sh + 1, (wd - kw) // sw + 1
    acc = torch.zeros((b, oh, ow, c), dtype=torch.int32, device=xp.device)
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :]
            acc += tap.to(torch.int32) * w[i, j, 0].to(torch.int32)
    return acc


def relu6_cap(exp: torch.Tensor, p: Precision) -> torch.Tensor:
    """The data value of 6.0 at exponent `exp`, saturated to the rail."""
    e = exp.to(torch.int32)
    six = torch.full_like(e, 6)
    below = torch.clamp_max(torch.bitwise_left_shift(six, torch.clamp(-e, 0, 5)), p.rail)
    return torch.where(e <= 0, below, six >> torch.clamp(e, 0, 31))


def relu6_mask(y: torch.Tensor, exp: torch.Tensor, p: Precision) -> torch.Tensor:
    """Where gradient passes a ReLU6 whose output is y: 0 < y < cap, or on a
    saturated rail (6.0 not representable)."""
    cap = relu6_cap(exp, p).to(torch.int8)
    return (y > 0) & ((y < cap) | (cap == p.rail))


# ------------------------------------------------------------------ layers

class Conv:
    """int8 conv (HWIO weight, 0-d exponent); act None or "relu6"."""

    def __init__(self, ic: int, oc: int, kernel=(1, 1), stride=(1, 1), padding="VALID",
                 act: Optional[str] = None):
        self.ic, self.oc = ic, oc
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding, self.act = padding, act
        self.w: Optional[torch.Tensor] = None
        self.w_exp: Optional[torch.Tensor] = None

    per_channel = False

    @property
    def weight_shape(self):
        return (*self.kernel, self.ic, self.oc)

    def out_shape(self, shape):
        return (shape[0], *conv_spatial(shape[1:3], self.kernel, self.stride, self.padding),
                self.oc)

    def fwd(self, x, e, ctx):
        pads = same_or_valid(self.padding, self.kernel, self.stride, x.shape[1:3])
        y, ey = requant_forward(conv_acc(x, self.w, self.stride, pads),
                                e.to(torch.int32) + self.w_exp.to(torch.int32), ctx.p)
        if self.act == "relu6":
            y = torch.clamp_min(torch.minimum(y, relu6_cap(ey, ctx.p).to(torch.int8)), 0)
        return y, ey, (x, y, ey)

    def bwd(self, res, gy, ctx, need_input_grad=True):
        x, y, ey = res
        if self.act == "relu6":
            gy = torch.where(relu6_mask(y, ey, ctx.p), gy, torch.zeros_like(gy))
        pads = same_or_valid(self.padding, self.kernel, self.stride, x.shape[1:3])
        rows, _ = patches(pad(x, pads), self.kernel, self.stride)
        acc = exact_matmul(rows.t(), gy.reshape(-1, self.oc)).reshape(self.weight_shape)
        grads = [(self, requant_grad(acc, ctx.dense_margin, ctx.p))]
        if not need_input_grad:
            return None, grads
        tp = transposed_pads(self.kernel, x.shape[1:3], gy.shape[1:3], self.stride, self.padding)
        w_t = torch.flip(self.w, dims=(0, 1)).permute(0, 1, 3, 2)
        gx, _ = requant_forward(conv_acc(dilate(gy, self.stride), w_t, (1, 1), tp),
                                torch.zeros((), dtype=torch.int32, device=gy.device), ctx.p)
        return gx, grads


def dw_pc_shift_cap(taps: int) -> int:
    """Largest alignment shift keeping taps * 127^2 << cap inside int32."""
    return 30 - math.ceil(math.log2(taps * 127 * 127))


class DepthwiseConv:
    """int8 depthwise conv, (KH, KW, 1, C) weight; with `per_channel` a (C,)
    exponent, every channel's accumulator aligned to the smallest exponent
    by a left shift (its filter grad back by a truncating right shift),
    capped by dw_pc_shift_cap."""

    def __init__(self, c: int, kernel=(3, 3), stride=(1, 1), padding="SAME",
                 per_channel=False, act: Optional[str] = None):
        self.c = c
        self.kernel, self.stride, self.padding = tuple(kernel), tuple(stride), padding
        self.per_channel, self.act = per_channel, act
        self.w: Optional[torch.Tensor] = None
        self.w_exp: Optional[torch.Tensor] = None

    @property
    def weight_shape(self):
        return (*self.kernel, 1, self.c)

    def out_shape(self, shape):
        return (shape[0], *conv_spatial(shape[1:3], self.kernel, self.stride, self.padding),
                self.c)

    def _shifts(self):
        e = self.w_exp.to(torch.int32)
        if e.dim() == 0:
            return e, None
        base = e.amin()
        cap = dw_pc_shift_cap(self.kernel[0] * self.kernel[1])
        return base, torch.clamp(e - base, 0, cap)

    def fwd(self, x, e, ctx):
        base, sh = self._shifts()
        pads = same_or_valid(self.padding, self.kernel, self.stride, x.shape[1:3])
        acc = dw_taps(pad(x, pads), self.w, self.stride)
        if sh is not None:
            acc = acc << sh
        y, ey = requant_forward(acc, e.to(torch.int32) + base, ctx.p)
        if self.act == "relu6":
            y = torch.clamp_min(torch.minimum(y, relu6_cap(ey, ctx.p).to(torch.int8)), 0)
        return y, ey, (x, y, ey)

    def bwd(self, res, gy, ctx, need_input_grad=True):
        x, y, ey = res
        if self.act == "relu6":
            gy = torch.where(relu6_mask(y, ey, ctx.p), gy, torch.zeros_like(gy))
        _, sh = self._shifts()
        kh, kw = self.kernel
        s_h, s_w = self.stride
        xp = pad(x, same_or_valid(self.padding, self.kernel, self.stride, x.shape[1:3]))
        _, oh, ow, c = gy.shape
        g = gy.to(torch.int32)
        taps = [(xp[:, i:i + (oh - 1) * s_h + 1:s_h, j:j + (ow - 1) * s_w + 1:s_w, :]
                 .to(torch.int32) * g).sum(dim=(0, 1, 2))
                for i in range(kh) for j in range(kw)]
        acc = torch.stack(taps).reshape(kh, kw, 1, c).to(torch.int32)
        if sh is not None:
            acc = trunc_shift(acc, sh.reshape(1, 1, 1, -1))
        grads = [(self, requant_grad(acc, ctx.dw_margin, ctx.p))]
        if not need_input_grad:
            return None, grads
        tp = transposed_pads(self.kernel, x.shape[1:3], gy.shape[1:3], self.stride, self.padding)
        acc = dw_taps(pad(dilate(gy, self.stride), tp), torch.flip(self.w, dims=(0, 1)))
        if sh is not None:
            acc = acc << sh
        gx, _ = requant_forward(acc, torch.zeros((), dtype=torch.int32, device=gy.device), ctx.p)
        return gx, grads


class Relu:
    def out_shape(self, shape):
        return shape

    def fwd(self, x, e, ctx):
        return torch.clamp_min(x, 0), e, x

    def bwd(self, res, gy, ctx, need_input_grad=True):
        return torch.where(res > 0, gy, torch.zeros_like(gy)), []


class GlobalAvgPool:
    """(B, H, W, C) -> (B, 1, 1, C): int32 sum / (H*W), truncated, clipped."""

    def out_shape(self, shape):
        return (shape[0], 1, 1, shape[3])

    def fwd(self, x, e, ctx):
        _, h, w, _ = x.shape
        acc = x.to(torch.int32).sum(dim=(1, 2), keepdim=True, dtype=torch.int32)
        return clip(torch.div(acc, h * w, rounding_mode="trunc"), ctx.p.rail), e, x.shape

    def bwd(self, res, gy, ctx, need_input_grad=True):
        b, h, w, c = res
        g = torch.div(gy.to(torch.int32), h * w, rounding_mode="trunc")
        return clip(g.expand(b, h, w, c), ctx.p.rail), []


class MaxPool:
    """VALID max pool; the exponent passes (NITI_Maxpool_Int8.cpp). The
    gradient goes to the first position of each window, in row-major scan
    order, whose value is at least the window's max
    (NITI_CPUPoolGrad_Int8.cpp:60-66); where windows overlap, the
    contributions add in int32 and clip."""

    def __init__(self, window=(2, 2), stride=(2, 2)):
        self.window, self.stride = tuple(window), tuple(stride)

    def out_shape(self, shape):
        return (shape[0], *conv_spatial(shape[1:3], self.window, self.stride, "VALID"), shape[3])

    def fwd(self, x, e, ctx):
        y = windows(x, self.window, self.stride).amax(dim=(3, 4))
        return y, e, (x, y)

    def bwd(self, res, gy, ctx, need_input_grad=True):
        x, y = res
        win = windows(x, self.window, self.stride)
        b, oh, ow, kh, kw, c = win.shape
        hit = (win >= y[:, :, :, None, None, :]).reshape(b, oh, ow, kh * kw, c)
        first = hit & (torch.cumsum(hit.to(torch.int32), dim=3, dtype=torch.int32) == 1)
        zero = torch.zeros((), dtype=gy.dtype, device=gy.device)
        taps = [torch.where(first[:, :, :, t], gy, zero) for t in range(kh * kw)]
        return clip(scatter(taps, self.window, self.stride, x.shape[1:3]), ctx.p.rail), []


class AvgPool:
    """Average pool of `pad` zero pixels a side and a VALID window: the
    int32 window sum divided by |window|, truncated, clipped; the exponent
    passes. The gradient spreads gy / |window|, truncated, over each
    window, sums in int32, clips and crops the pad."""

    def __init__(self, window=(3, 3), stride=(1, 1), pad: int = 0):
        self.window, self.stride, self.pad = tuple(window), tuple(stride), int(pad)

    def out_shape(self, shape):
        p = self.pad
        return (shape[0], *conv_spatial((shape[1] + 2 * p, shape[2] + 2 * p), self.window,
                                        self.stride, "VALID"), shape[3])

    def fwd(self, x, e, ctx):
        p, (kh, kw) = self.pad, self.window
        win = windows(pad(x, ((p, p), (p, p))), self.window, self.stride)
        acc = torch.zeros(win.shape[:3] + win.shape[5:], dtype=torch.int32, device=x.device)
        for i in range(kh):
            for j in range(kw):
                acc += win[:, :, :, i, j, :].to(torch.int32)
        y = clip(torch.div(acc, kh * kw, rounding_mode="trunc"), ctx.p.rail)
        return y, e, x.shape

    def bwd(self, res, gy, ctx, need_input_grad=True):
        _, h, w, _ = res
        p, (kh, kw) = self.pad, self.window
        g = torch.div(gy.to(torch.int32), kh * kw, rounding_mode="trunc")
        gx = clip(scatter([g] * (kh * kw), self.window, self.stride, (h + 2 * p, w + 2 * p)),
                  ctx.p.rail)
        return gx[:, p:p + h, p:p + w, :], []


class Flatten:
    """(B, H, W, C) -> (B, 1, 1, H*W*C) in NHWC order; the gradient
    restores the shape."""

    def out_shape(self, shape):
        return (shape[0], 1, 1, math.prod(shape[1:]))

    def fwd(self, x, e, ctx):
        return x.reshape(x.shape[0], 1, 1, -1), e, x.shape

    def bwd(self, res, gy, ctx, need_input_grad=True):
        return gy.reshape(res), []


def add(a, ea, b, eb, p: Precision):
    """Exponent-aligned residual add: both truncated to the larger exponent,
    summed in int32, forward requant."""
    ea, eb = ea.to(torch.int32), eb.to(torch.int32)
    e = torch.maximum(ea, eb)
    return requant_forward(trunc_shift(a, e - ea) + trunc_shift(b, e - eb), e, p)


class Residual:
    """y = branch(x) + proj(x), proj the identity when None; the gradient
    passes to both paths, their input grads summed and clipped."""

    def __init__(self, branch: Sequence, proj: Optional[Conv] = None):
        self.branch, self.proj = list(branch), proj

    @property
    def branches(self):
        return [self.branch] + ([[self.proj]] if self.proj is not None else [])

    def out_shape(self, shape):
        return shape_of(self.branch, shape)

    def fwd(self, x, e, ctx):
        y, ey, res_b = run_forward(self.branch, x, e, ctx)
        if self.proj is None:
            s, es, res_p = x, e, None
        else:
            s, es, res_p = self.proj.fwd(x, e, ctx)
        out, eo = add(y, ey, s, es, ctx.p)
        return out, eo, (res_b, res_p)

    def bwd(self, res, gy, ctx, need_input_grad=True):
        res_b, res_p = res
        gb, grads = run_backward(self.branch, res_b, gy, ctx, True)
        if self.proj is None:
            gs = gy
        else:
            gs, gp = self.proj.bwd(res_p, gy, ctx)
            grads = grads + gp
        return clip(gb.to(torch.int32) + gs.to(torch.int32), ctx.p.rail), grads


class Concat:
    """Branches that all read the input, joined on the channel axis: each
    output shifted right, truncating, to the largest exponent. The gradient
    gives each branch its own channel slice; the branches' input grads are
    summed in branch order and clipped after each sum, as where two
    gradient paths meet (grad/OpGrad.cpp:64-128)."""

    def __init__(self, branches: Sequence[Sequence]):
        self.branches = [list(b) for b in branches]

    def out_shape(self, shape):
        outs = [shape_of(b, shape) for b in self.branches]
        return (*outs[0][:3], sum(o[3] for o in outs))

    def fwd(self, x, e, ctx):
        outs = [run_forward(b, x, e, ctx) for b in self.branches]
        eo = torch.stack([eb.to(torch.int32) for _, eb, _ in outs]).amax()
        y = torch.cat([trunc_shift(yb, eo - eb.to(torch.int32)).to(torch.int8)
                       for yb, eb, _ in outs], dim=-1)
        return y, eo, ([r for _, _, r in outs], [yb.shape[-1] for yb, _, _ in outs])

    def bwd(self, res, gy, ctx, need_input_grad=True):
        ress, sizes = res
        gx, grads, at = None, [], 0
        for branch, r, n in zip(self.branches, ress, sizes):
            gb, g = run_backward(branch, r, gy[..., at:at + n], ctx, True)
            at += n
            grads += g
            gx = gb if gx is None else clip(gx.to(torch.int32) + gb.to(torch.int32), ctx.p.rail)
        return gx, grads


def run_forward(layers, x, e, ctx):
    residuals = []
    for layer in layers:
        x, e, r = layer.fwd(x, e, ctx)
        residuals.append(r)
    return x, e, residuals


def run_backward(layers, residuals, gy, ctx, need_input_grad=True):
    grads = []
    for i in range(len(layers) - 1, -1, -1):
        gy, g = layers[i].bwd(residuals[i], gy, ctx, need_input_grad or i > 0)
        grads = g + grads
    return gy, grads


def shape_of(layers, shape):
    """The output shape of `layers` on an NHWC input of `shape`."""
    for layer in layers:
        shape = layer.out_shape(tuple(shape))
    return tuple(shape)


def weighted(layers) -> List:
    """The layers that hold a weight, in the order of the program's
    modules: a composite layer's branches one after another (a residual's
    branch before its projection)."""
    out = []
    for layer in layers:
        if hasattr(layer, "weight_shape"):
            out.append(layer)
        for branch in getattr(layer, "branches", ()):
            out += weighted(branch)
    return out


# ------------------------------------------------------------------ models

FAMILIES = Path(__file__).resolve().parent / "families"


def build(family: str, **kwargs) -> List:
    """The layers of a network family: build(**kwargs) of
    families/<family>.py."""
    spec = importlib.util.spec_from_file_location(f"h100bench_family_{family}",
                                                  FAMILIES / f"{family}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build(**kwargs)


# -------------------------------------------------------------------- step

@dataclass
class Ctx:
    p: Precision = INT8
    dense_margin: int = 2
    dw_margin: int = 2


def quantize_batch(x: torch.Tensor, p: Precision):
    """Standardize a batch of float pixels by its mean and standard
    deviation (both moments summed in float64, rounded once to float32) and
    scale its largest deviation r to the rail: (data, exponent)."""
    x = x.to(torch.float32)
    x64 = x.to(torch.float64)
    n, s, s2 = float(x.numel()), x64.sum(), (x64 * x64).sum()
    s, s2 = s.to(torch.float32), s2.to(torch.float32)
    mean = s / n
    std = torch.sqrt(torch.clamp_min(s2 / n - mean * mean, 0.0))
    r = torch.abs(x - mean).amax()
    exp = torch.ceil(torch.log2(r / std)).to(torch.int32) - p.bits
    data = torch.round((x - mean) * (float(p.rail) / r)).to(torch.int8)
    return data, exp


def loss_value(logits: torch.Tensor, exp: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of softmax(logits * 2^exp), float32."""
    z = logits.to(torch.float32) * torch.exp2(exp.to(torch.float32))
    return -torch.mean(torch.sum(torch.log_softmax(z, dim=-1) * onehot.to(torch.float32), dim=-1))


def _soft_linear(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    a = torch.clamp_min(a, -6)
    t = torch.div(x * 47274, 1 << 15, rounding_mode="trunc")  # x * log2(e), Q15
    up = t * torch.bitwise_left_shift(torch.ones_like(a), torch.clamp_min(a, 0))
    down = trunc_shift(t, torch.clamp_min(-a, 0))
    s = torch.where(a >= 0, up, down)
    e = torch.clamp_min(s - (s.amax(dim=-1, keepdim=True) - 10), 0)
    soft = torch.bitwise_left_shift(torch.ones_like(e), e) - 1
    return torch.div(soft * (1 << 11), soft.sum(dim=-1, keepdim=True, dtype=torch.int32),
                     rounding_mode="trunc")


def _soft_quadratic(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    a = torch.clamp(a, -25, -7).to(torch.int64)
    one = torch.ones_like(a)
    soft = (torch.bitwise_left_shift(one, 1 - 2 * a) + x * torch.bitwise_left_shift(one, 1 - a)
            + x * x)
    return torch.div(soft * (1 << 11), soft.sum(dim=-1, keepdim=True),
                     rounding_mode="trunc").to(torch.int32)


def loss_grad(logits: torch.Tensor, exp: torch.Tensor, onehot: torch.Tensor,
              p: Precision) -> torch.Tensor:
    """Integer softmax cross-entropy gradient: p = 2^11-scaled softmax (base-2
    exponentials above exponent -7, a quadratic below), g = p - sum(p) *
    onehot, shifted by 4 (int8) or 8 (int4)."""
    x = logits.to(torch.int32)
    a = torch.clamp(exp.to(torch.int32), -25, 15)
    prob = torch.where(a > -7, _soft_linear(x, a), _soft_quadratic(x, a))
    g = prob - prob.sum(dim=-1, keepdim=True, dtype=torch.int32) * onehot.to(torch.int32)
    return psto(g, 4 + INT8.bits - p.bits, p.rail).to(torch.int8)


def train_step(model: List, x: torch.Tensor, onehot: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """One NITI step on the model's weights, updated in place -> the float
    loss (0-d)."""
    data, exp = quantize_batch(x, ctx.p)
    y, ey, residuals = run_forward(model, data, exp, ctx)
    logits = y.reshape(y.shape[0], -1)
    loss = loss_value(logits, ey, onehot)
    g = loss_grad(logits, ey, onehot, ctx.p).reshape(y.shape)
    _, grads = run_backward(model, residuals, g, ctx, need_input_grad=False)
    for layer, gw in grads:
        layer.w.copy_(clip(layer.w.to(torch.int32) - gw.to(torch.int32), INT8.rail))
    return loss


def load(model: List, leaves: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Give the model's weighted layers copies of (data, exponent) leaves."""
    layers = weighted(model)
    if len(layers) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(layers)} weighted layers")
    for layer, (w, e) in zip(layers, leaves):
        if tuple(w.shape) != layer.weight_shape:
            raise ValueError(f"leaf {tuple(w.shape)} for a layer of {layer.weight_shape}")
        layer.w, layer.w_exp = w.clone(), e.clone()


def weights(model: List) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(layer.w, layer.w_exp) for layer in weighted(model)]
