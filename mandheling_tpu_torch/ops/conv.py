"""NITI int8 convolution: forward, input gradient and filter gradient
(port of ``mandheling_tpu/ops/conv.py``).

Layouts are the JAX package's: NHWC activations, HWIO weights. Every
contraction is an int8 GEMM through the dispatch layer (K1 on the card):
the forward and the input grad through im2col, the filter grad as
patches^T @ gy — the JAX package's "matmul" strategy, which gives the same
int32 as its "conv" and "corr" forms. The requantization is the shared code
in ops/numerics.py, on the device, with no host synchronisation; an int32
accumulator that reaches device memory is requantized by K7
(kernels/requant_int32.py: two launches on the card under the "cuda"
backend, its plain version, that shared code, otherwise).

Under the "cuda" backend, as under the JAX package's Pallas backends, a
conv whose shape a fused kernel takes runs through it instead (the int32
accumulator then never reaches device memory): a 1x1 conv through the
two-phase fused matmul K2 when `fused_matmul_int8.supports` takes it, and,
in fused mode "all", any other conv through the fused conv K3 when
`fused_conv_int8.supports` takes it.

With a replica `group` (a ``torch.distributed`` process group, where the
JAX package passes `axis_name`), every range estimate takes the maximum
over the group, between the fused kernels' two phases on the fused routes,
and the filter-grad accumulators are summed over it before their shift
(ops/allreduce.py), so data-parallel steps give the single replica's bytes.

Every public contraction op counts its work from its shapes (ops/flops.py).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

from . import allreduce, flops, numerics
from .kernels import dispatch as _dispatch
from .kernels import fused_conv_int8 as _fconv
from .kernels import fused_matmul_int8 as _fmm
from .kernels import requant_int32 as _rq
from .kernels.conv_int8 import _dilate_hw, im2col, pad_hw

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def resolve_padding(
    padding, kernel: Tuple[int, int], stride: Sequence[int],
    in_spatial: Tuple[int, int],
) -> Pads:
    """Resolve 'VALID'/'SAME'/explicit padding to per-edge pads. SAME follows
    the TF/XLA convention: out = ceil(in/stride), the odd pixel at the end."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        if padding.upper() == "SAME":
            pads = []
            for i, k, s in zip(in_spatial, kernel, stride):
                out = -(-i // s)
                total = max((out - 1) * s + k - i, 0)
                pads.append((total // 2, total - total // 2))
            return (pads[0], pads[1])
        raise ValueError(f"unknown padding {padding}")
    (pt, pb), (pl, pr) = padding
    return ((pt, pb), (pl, pr))


# Fused-kernel selection under the "cuda" backend: "off", "matmul_only" (K2
# for 1x1 convs; the default, as in the JAX package) or "all" (K2, and K3
# for every other conv its `supports` takes).
_FUSED_CONV_MODE = "matmul_only"
_FC_VALID = ("off", "matmul_only", "all")


def set_fused_conv_mode(mode: str) -> None:
    global _FUSED_CONV_MODE
    if mode not in _FC_VALID:
        raise ValueError(f"mode must be one of {_FC_VALID}, got {mode!r}")
    _FUSED_CONV_MODE = mode


def get_fused_conv_mode() -> str:
    return _FUSED_CONV_MODE


@contextlib.contextmanager
def use_fused_conv_mode(mode: str):
    global _FUSED_CONV_MODE
    prev = _FUSED_CONV_MODE
    set_fused_conv_mode(mode)
    try:
        yield
    finally:
        _FUSED_CONV_MODE = prev


def _fused_enabled() -> bool:
    return _dispatch.get_backend() == "cuda"


def _work(args, out_size: int) -> Tuple[int, int]:
    """(multiply-adds, bytes) of the conv of args["x"] by args["w"]: both read
    once, the output written once (`out_size` bytes an element)."""
    x, w = args["x"], args["w"]
    b, h, wd, _ = x.shape
    kh, kw, ic, oc = w.shape
    pads = resolve_padding(args["padding"], (kh, kw), args["stride"], (h, wd))
    oh, ow = flops.conv_out((h, wd), (kh, kw), args["stride"], pads)
    return b * oh * ow * kh * kw * ic * oc, flops.nbytes(x, w) + b * oh * ow * oc * out_size


def _input_grad_work(args, out_size: int) -> Tuple[int, int]:
    gy, w = args["gy"], args["w"]
    kh, kw, ic, _ = w.shape
    return flops.grad_work(gy, w, kh * kw, ic, (gy.shape[0], *args["x_spatial"], ic), out_size)


def _filter_grad_work(args, out_size: int) -> Tuple[int, int]:
    x, gy = args["x"], args["gy"]
    (kh, kw), ic = args["kernel_spatial"], x.shape[-1]
    return flops.grad_work(gy, x, kh * kw, ic, (kh, kw, ic, gy.shape[-1]), out_size)


@flops.counted(lambda args: _work(args, 4))
def conv2d_int8_acc(x: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int] = (1, 1), padding="VALID") -> torch.Tensor:
    """int8 or int16 NHWC x * int8 HWIO w -> int32 accumulator."""
    pad = resolve_padding(padding, w.shape[:2], stride, x.shape[1:3])
    return _dispatch.conv_acc(x, w, tuple(stride), pad)


def _fused_conv_requant(
    x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int], pad: Pads, group=None,
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The conv through a two-phase fused kernel, forward requant semantics
    -> (int8 y, eff_shift), or None when no fused kernel takes the shape. In
    the JAX package's order: a 1x1 conv goes to K2; any other conv, in mode
    "all" only, to K3. The maximum over `group` sits between the phases
    (JAX `ops/conv.py:248-294`)."""
    if _FUSED_CONV_MODE == "off":
        return None
    kh, kw, ic, oc = w.shape
    if (kh, kw) != (1, 1):
        if _FUSED_CONV_MODE != "all":
            return None
        wp = x.shape[2] + pad[1][0] + pad[1][1]
        if not _fconv.supports(w.shape, wp, stride):
            return None
        m = allreduce.maybe_pmax(_fconv.conv_max(x, w, pad, stride), group)
        eff_shift = numerics.forward_shift(numerics.range_estimate_from_max(m))
        return _fconv.conv_requant(x, w, eff_shift, pad, stride, grad=False), eff_shift
    x = pad_hw(x, pad)
    sh, sw = stride
    if (sh, sw) != (1, 1):
        x = x[:, ::sh, ::sw, :]
    b, h, w_sp, _ = x.shape
    if not _fmm.supports(b * h * w_sp, ic, oc):
        return None
    a2 = x.reshape(b * h * w_sp, ic)
    w2 = w.reshape(ic, oc)
    m = allreduce.maybe_pmax(_fmm.matmul_max(a2, w2), group)
    eff_shift = numerics.forward_shift(numerics.range_estimate_from_max(m))
    y = _fmm.matmul_requant(a2, w2, eff_shift, grad=False)
    return y.reshape(b, h, w_sp, oc), eff_shift


@flops.counted(lambda args: _work(args, 2 if args["out_bits"] > 7 else 1))
def conv2d_forward(
    x: torch.Tensor,
    x_exp: torch.Tensor,
    w: torch.Tensor,
    w_exp: torch.Tensor,
    stride: Sequence[int] = (1, 1),
    padding="VALID",
    act: Optional[str] = None,
    out_bits: int = 7,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NITI int8 conv forward -> (int8 y, int32 exp_out), exp_out = x_exp +
    w_exp + shift from the range estimate of the accumulator
    (NITI_Conv_Int8.cpp:255-307). `out_bits=15` gives an int16 y; an int16
    x or y never takes a fused kernel, and an int16 y no activation. The
    accumulator of a conv no fused kernel takes is requantized by K7
    (kernels/requant_int32.py), the activation with it."""
    if _fused_enabled() and out_bits == 7 and x.dtype == torch.int8:
        pad = resolve_padding(padding, w.shape[:2], stride, x.shape[1:3])
        fused = _fused_conv_requant(x, w, tuple(stride), pad, group)
        if fused is not None:
            y, eff_shift = fused
            e = x_exp.to(torch.int32) + w_exp.to(torch.int32) + eff_shift
            return _rq.apply_act(y, e, act), e
    acc = conv2d_int8_acc(x, w, stride, padding)
    m = allreduce.maybe_pmax(_rq.absmax(acc), group)
    return _rq.requant_forward(acc, m, (x_exp, w_exp), out_bits, act)


def _rot180_io(w: torch.Tensor) -> torch.Tensor:
    """Rotate HWIO weights 180 degrees spatially and swap in/out channels."""
    return torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)


def _input_grad_pads(w_shape, x_spatial, gy_spatial, stride, padding):
    """Full-correlation pads of the transposed conv, adjusted so that the
    output spatial size equals the input's, and the dilated gy size."""
    kh, kw = w_shape[0], w_shape[1]
    (pt, _pb), (pl, _pr) = resolve_padding(padding, (kh, kw), stride, x_spatial)
    sh, sw = stride
    ih, iw = x_spatial
    oh, ow = gy_spatial
    pad_top = kh - 1 - pt
    pad_left = kw - 1 - pl
    dil_h = (oh - 1) * sh + 1
    dil_w = (ow - 1) * sw + 1
    pad_bottom = ih - dil_h - pad_top + kh - 1
    pad_right = iw - dil_w - pad_left + kw - 1
    return ((pad_top, pad_bottom), (pad_left, pad_right))


@flops.counted(lambda args: _input_grad_work(args, 4))
def conv2d_input_grad_acc(
    gy: torch.Tensor, w: torch.Tensor, x_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1), padding="VALID",
) -> torch.Tensor:
    """int32 accumulator of the transposed conv: zero-dilate gy by the
    stride, pad to full overlap, conv with the rot180 / io-swapped weights."""
    pad = _input_grad_pads(w.shape, x_spatial, gy.shape[1:3], stride, padding)
    return _dispatch.conv_acc(gy, _rot180_io(w), (1, 1), pad,
                              lhs_dilation=tuple(stride))


@flops.counted(lambda args: _input_grad_work(args, 1))
def conv2d_input_grad(
    gy: torch.Tensor, w: torch.Tensor, x_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1), padding="VALID", group=None,
) -> torch.Tensor:
    """int8 input gradient with the forward-style bw-7 requant
    (NITI_DeConv_Int8.cpp:294-318). Under the "cuda" backend a shape a
    fused kernel takes runs through it on the zero-dilated gy with the
    rot180 / io-swapped weights."""
    if _fused_enabled():
        pad = _input_grad_pads(w.shape, x_spatial, gy.shape[1:3], stride, padding)
        if min(pad[0] + pad[1]) >= 0:
            fused = _fused_conv_requant(_dilate_hw(gy, *stride), _rot180_io(w),
                                        (1, 1), pad, group)
            if fused is not None:
                return fused[0]
    acc = conv2d_input_grad_acc(gy, w, x_spatial, stride, padding)
    m = allreduce.maybe_pmax(_rq.absmax(acc), group)
    return _rq.requant_forward(acc, m)[0]


@flops.counted(lambda args: _filter_grad_work(args, 4))
def conv2d_filter_grad_acc(
    x: torch.Tensor, gy: torch.Tensor, kernel_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1), padding="VALID",
) -> torch.Tensor:
    """int32 filter-gradient accumulator, HWIO:
    dw[kh,kw,ic,oc] = sum_{b,oh,ow} x[b, oh*s+kh, ow*s+kw, ic] * gy[b,oh,ow,oc],
    computed as im2col(x)^T @ gy (the JAX package's "matmul" strategy; the
    transposed patches go to the GEMM as a strided view)."""
    kh, kw = kernel_spatial
    ic, oc = x.shape[-1], gy.shape[-1]
    pad = resolve_padding(padding, kernel_spatial, stride, x.shape[1:3])
    patches, (oh, ow) = im2col(x, (kh, kw), tuple(stride), pad)
    if (oh, ow) != tuple(gy.shape[1:3]):
        raise ValueError(f"gy spatial {tuple(gy.shape[1:3])} != conv output {(oh, ow)}")
    acc = _dispatch.matmul_acc(patches.t(), gy.reshape(-1, oc))
    return acc.reshape(kh, kw, ic, oc)


# Dense-conv filter-grad requant margin (shift = bw - margin); the reference
# contract is 2 (NITI_GradientConv_Int8.cpp:274-296).
_FGRAD_MARGIN = 2


def set_fgrad_margin(margin: int) -> None:
    global _FGRAD_MARGIN
    _FGRAD_MARGIN = int(margin)


def get_fgrad_margin() -> int:
    return _FGRAD_MARGIN


@flops.counted(lambda args: _filter_grad_work(args, 1))
def conv2d_filter_grad(
    x: torch.Tensor, gy: torch.Tensor, kernel_spatial: Tuple[int, int],
    stride: Sequence[int] = (1, 1), padding="VALID", group=None,
) -> torch.Tensor:
    """int8 filter gradient with the bw - margin shift; all-zero stays zero.
    With `group`, the accumulators combine over it first, by the selected
    allreduce mode (ops/allreduce.py)."""
    acc = conv2d_filter_grad_acc(x, gy, kernel_spatial, stride, padding)
    return allreduce.grad_allreduce_requant(acc, group, margin=_FGRAD_MARGIN)
