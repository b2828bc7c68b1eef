"""Seeded int8 weights for the reference's weighted layers, made on the
device in one draw: the NITI Xavier scheme (std = sqrt(2 / (fan_in +
fan_out)), scaled by the largest magnitude to +-127, exponent
ceil(log2 max) - 7), per channel for a depthwise layer that asks for it
(each channel's range floored at the largest over 2^cap, so that the
exponents' spread stays inside the alignment cap)."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from .reference import dw_pc_shift_cap, weighted


def _quantize(w: torch.Tensor, rng: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    exp = (torch.ceil(torch.log2(rng)) - 7).to(torch.int32)
    return torch.round(w / rng * 127.0).to(torch.int8), exp


def make(model: List, gen: torch.Generator) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(int8 data, int32 exponent) for every weighted layer of `model`, in
    order: one normal draw from `gen` on its device, split among them."""
    layers = weighted(model)
    sizes = [math.prod(layer.weight_shape) for layer in layers]
    draw = torch.randn(sum(sizes), generator=gen, device=gen.device, dtype=torch.float32)
    out, at = [], 0
    for layer, n in zip(layers, sizes):
        kh, kw, ic, oc = layer.weight_shape
        per_channel = getattr(layer, "per_channel", False)
        fans = 2 if per_channel else ic + oc  # a per-channel filter is its own layer
        w = draw[at:at + n].view(layer.weight_shape) * math.sqrt(2.0 / (kh * kw * fans))
        at += n
        if per_channel:
            rng = torch.abs(w).amax(dim=(0, 1, 2))
            rng = torch.maximum(rng, rng.amax() / 2.0 ** dw_pc_shift_cap(kh * kw))
        else:
            rng = torch.abs(w).amax()
        out.append(_quantize(w, rng))
    return out
