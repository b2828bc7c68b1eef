"""NITI int8 Xavier initialization (port of ``mandheling_tpu/nn/init.py``;
reference `Initializer.cpp:112-141`, `Distributions.cpp:26-51`):

    std  = sqrt(2 / (fan_in + fan_out)); w ~ N(0, std); range = max|w|
    data = round(w / range * 127) -> int8; exp = ceil(log2(range)) - 7

The draw comes from a CPU `torch.Generator`, so one seed gives the same
weights on every device. It is not jax.random's stream: tests that compare
with the JAX package carry its params across (utils/jax_params.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.depthwise import pc_shift_cap
from ..ops.qtensor import QTensor


def niti_xavier_int8(shape_hwio: Tuple[int, int, int, int],
                     generator: Optional[torch.Generator] = None) -> QTensor:
    """HWIO conv weight -> (int8 data, 0-d int32 exponent), on the CPU.
    fan_in = IC*KH*KW, fan_out = OC*KH*KW."""
    kh, kw, ic, oc = shape_hwio
    std = math.sqrt(2.0 / (ic * kh * kw + oc * kh * kw))
    w = torch.randn(tuple(shape_hwio), generator=generator, dtype=torch.float32) * std
    rng = torch.abs(w).amax()
    exp = (torch.ceil(torch.log2(rng)) - 7).to(torch.int32)
    data = torch.round(w / rng * 127.0).to(torch.int8)
    return QTensor(data, exp)


def niti_xavier_int8_dw_per_channel(shape_hwio: Tuple[int, int, int, int],
                                    generator: Optional[torch.Generator] = None) -> QTensor:
    """Depthwise weight (KH, KW, 1, C) with a per-channel (C,) int32 exponent:
    the same Xavier draw (fan_in = fan_out = KH*KW), scaled per channel.
    Each channel's range is floored at max_c(range) / 2^cap, cap =
    ``ops.depthwise.pc_shift_cap(KH*KW)``, so that the exponent spread never
    exceeds the int32-safe alignment cap."""
    kh, kw, one, c = shape_hwio
    if one != 1:
        raise ValueError(f"depthwise weights are (KH, KW, 1, C), got {tuple(shape_hwio)}")
    std = math.sqrt(2.0 / (kh * kw + kh * kw))
    w = torch.randn(tuple(shape_hwio), generator=generator, dtype=torch.float32) * std
    rng_c = torch.abs(w).amax(dim=(0, 1, 2))
    rng_c = torch.maximum(rng_c, rng_c.amax() / (2.0 ** pc_shift_cap(kh * kw)))
    exp_c = (torch.ceil(torch.log2(rng_c)) - 7).to(torch.int32)
    data = torch.round(w / rng_c * 127.0).to(torch.int8)
    return QTensor(data, exp_c)
