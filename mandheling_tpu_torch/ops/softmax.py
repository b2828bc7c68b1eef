"""NITI int8 softmax forward and its passthrough gradient (port of
``mandheling_tpu/ops/softmax.py``; reference NITI_CPUSoftmax_Int8.cpp:49-112,
NITI_CPUSoftmaxGrad_Int8.cpp:28-45).

The forward gives UNNORMALIZED int32 counts: for ascale > -7,
2^max(s - max_c(s) + 10, 0) - 1 with s = trunc(x * 47274 / 2^15) scaled by
2^ascale; at ascale <= -7 the quadratic fallback 2^(1-2a) + x*2^(1-a) + x^2.
The gradient truncates its int32 upstream to the low byte, as C's implicit
conversion does.
"""

from __future__ import annotations

import torch

from . import numerics


def _branch_linear(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    t = torch.div(x * 47274, 1 << 15, rounding_mode="trunc")
    pos = t * torch.bitwise_left_shift(torch.ones_like(a), torch.clamp_min(a, 0))
    neg = numerics.trunc_shift_div(t, torch.clamp_min(-a, 0))
    s = torch.where(a >= 0, pos, neg)
    m = s.amax(dim=-1, keepdim=True) - 10
    e = torch.clamp_min(s - m, 0)
    return torch.bitwise_left_shift(torch.ones_like(e), e) - 1


def _branch_quadratic(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    # Only a <= -7 selects this branch. XLA gives 0 for the negative shifts
    # that a > -7 would make here; torch leaves them undefined, so the shift
    # amounts are taken at a clamped to -7 (the values are discarded).
    a = torch.clamp_max(a, -7)
    one = torch.ones_like(a)
    base = torch.bitwise_left_shift(one, 1 - 2 * a)
    shiftbase = torch.bitwise_left_shift(one, 1 - a)
    return base + x * shiftbase + x * x


def softmax_int8_forward(logits: torch.Tensor, ascale: torch.Tensor) -> torch.Tensor:
    """int8 logits (..., C) and an int32 exponent -> int32 counts (..., C)."""
    x = logits.to(torch.int32)
    a = torch.clamp(ascale.to(device=x.device, dtype=torch.int32), -9, 15)
    return torch.where(a > -7, _branch_linear(x, a), _branch_quadratic(x, a))


def softmax_grad_int8(upstream: torch.Tensor) -> torch.Tensor:
    """int32 -> int8 by truncation to the low byte (NITI_CPUSoftmaxGrad_Int8.cpp:40-42)."""
    return upstream.to(torch.int32).to(torch.int8)
