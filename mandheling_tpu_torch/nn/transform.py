"""Post-hoc NITI model transforms (port of ``mandheling_tpu/nn/transform.py``).

:func:`dw_to_per_channel` gives every per-tensor depthwise layer of a built
model per-channel weight exponents: one half of the integer MobileNet
training recipe (per-channel depthwise exponents and filter-grad margins
0/0, DIVERGENCE_r05.json), for a model that was built or imported with
per-tensor ones.
"""

from __future__ import annotations

import torch

from ..ops.depthwise import check_pc_spread, pc_shift_cap
from .blocks import (NITIDepthwiseConv2D, ParallelAdd, ParallelConcat, ProjectedResidualBlock,
                     ResidualBlock)
from .module import Sequential


# XLA's float32 log of 2^k is k * C1 + k * C0 (the Cephes split of ln 2),
# and jnp.log2 multiplies it by a float32 1 / ln 2.
_LN2_C0, _LN2_C1 = 0.693359375, -2.12194440e-4
_INV_LN2 = 1.0 / 0.6931471824645996


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """ceil(jnp.log2(x)) as the JAX package computes it on the CPU, for
    positive normal float32 x = d * 2^e with an integer d <= 127 (a range of
    int8 data times a power of two). Away from the powers of two, log2 is
    not within float32 rounding of an integer there, and the ceiling is the
    exact one (x = m * 2^e, m in [0.5, 1) gives e). At x = 2^k, jnp.log2 is
    XLA's float32 log times a float32 1 / ln 2, which lands just above k at
    some k (-13, -15, -26, ...), giving k + 1: that value is reproduced in
    the same float32 operations, so that the exponents are the JAX
    package's."""
    f32 = torch.float32
    m, e = torch.frexp(x.to(f32))
    k = (e - 1).to(f32)
    log = k * torch.tensor(_LN2_C1, dtype=f32) + k * torch.tensor(_LN2_C0, dtype=f32)
    at_power = torch.ceil(log * torch.tensor(_INV_LN2, dtype=f32)).to(torch.int32)
    return torch.where(m == 0.5, at_power, e.to(torch.int32))


def requant_dw_per_channel(w: torch.Tensor, w_exp: torch.Tensor):
    """Per-tensor (int8 w (KH, KW, 1, C), 0-d exponent) -> per-channel
    (int8 data, (C,) int32 exponents), value-preserving: data_c =
    round(value / 2^exp_c) with exp_c = ceil(log2(range_c)) - 7, so that no
    value clips (but a range of exactly 2^k, whose data reaches 128 and
    clips to 127); each channel's range is floored at the largest over
    2^cap (``pc_shift_cap``), which bounds the exponent spread. float32
    throughout, on the CPU, rounding half to even as jnp.round does."""
    kh, kw = w.shape[0], w.shape[1]
    w, w_exp = w.cpu(), w_exp.cpu()
    wf = torch.ldexp(w.to(torch.float32), w_exp.to(torch.int32))
    rng = wf.abs().amax(dim=(0, 1, 2))
    rng = torch.maximum(rng, rng.max() / 2.0 ** pc_shift_cap(kh * kw))
    rng = torch.clamp(rng, min=torch.finfo(torch.float32).tiny)
    exp_c = ceil_log2(rng) - 7
    data = torch.round(torch.ldexp(wf, -exp_c.reshape(1, 1, 1, -1)))
    return torch.clamp(data, -127, 127).to(torch.int8), exp_c


def dw_to_per_channel(model: Sequential) -> Sequential:
    """Re-quantize every per-tensor NITIDepthwiseConv2D of `model` in place
    to per-channel exponents and flip it to ``per_channel=True``; returns
    the model. The walk recurses into residual branches, into a
    Sequential used as a layer and into each branch of a ParallelConcat or
    ParallelAdd, as the JAX walk does. A ProjectedResidualBlock is left as
    it is, as the JAX walk returns its params untouched (ResNet has no
    depthwise layer)."""
    for layer in model.layers:
        if isinstance(layer, ProjectedResidualBlock):
            continue
        if isinstance(layer, ResidualBlock):
            dw_to_per_channel(layer.branch)
        elif isinstance(layer, Sequential):
            dw_to_per_channel(layer)
        elif isinstance(layer, (ParallelAdd, ParallelConcat)):
            for branch in layer.branches:
                dw_to_per_channel(branch)
        elif isinstance(layer, NITIDepthwiseConv2D) and not layer.per_channel \
                and layer.w_exp.dim() == 0:
            data, exp_c = requant_dw_per_channel(layer.w, layer.w_exp)
            check_pc_spread(exp_c, layer.kernel[0] * layer.kernel[1])
            layer.w.copy_(data)
            layer.w_exp = exp_c.to(layer.w.device)  # a (C,) buffer in place of the 0-d one
            layer.per_channel = True
    return model
