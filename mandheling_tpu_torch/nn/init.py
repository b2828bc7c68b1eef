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
