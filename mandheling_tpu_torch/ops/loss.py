"""NITI integer-only softmax cross-entropy: float loss value + int8 gradient
(port of ``mandheling_tpu/ops/loss.py``; reference
`NITI_CPULoss_Int8.cpp:69-131`, `NITI_CPULossGrad_Int8.cpp:84-200`).

The gradient's linear branch (ascale > -7) is exact in int32; the quadratic
fallback (ascale <= -7) runs in int64 with ascale clamped to [-25, -7],
beyond which the reference's own int64 arithmetic overflows. Divisions
truncate toward zero (`rounding_mode="trunc"`, never `//`, which floors).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import numerics


def _mean_nll(logits: torch.Tensor, ascale: torch.Tensor, target_onehot: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    x = logits.to(dtype) * torch.exp2(ascale.to(dtype))
    logp = torch.log_softmax(x, dim=-1)
    return -torch.mean(torch.sum(logp * target_onehot.to(dtype), dim=-1))


def loss_cross_entropy_float(logits: torch.Tensor, ascale: torch.Tensor,
                             target_onehot: torch.Tensor) -> torch.Tensor:
    """Float CE value for logging: mean NLL of softmax(logits * 2^ascale),
    0-d float64. It is the JAX package's float32 value wherever that is
    finite, and the same formula in float64 where logits * 2^ascale
    overflows float32 (ascale above about 120: a network without batch norm
    whose logits' exponent runs away), finite up to ascale about 1015. Both
    are computed and one is selected on the device, so the host never reads
    ascale."""
    narrow = _mean_nll(logits, ascale, target_onehot, torch.float32).to(torch.float64)
    wide = _mean_nll(logits, ascale, target_onehot, torch.float64)
    return torch.where(torch.isfinite(narrow), narrow, wide)


def _p_linear(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    a = torch.clamp_min(a, -6)  # branch valid for a > -7 only
    t = torch.div(x * 47274, 1 << 15, rounding_mode="trunc")
    pos = t * torch.bitwise_left_shift(torch.ones_like(a), torch.clamp_min(a, 0))
    neg = numerics.trunc_shift_div(t, torch.clamp_min(-a, 0))
    s = torch.where(a >= 0, pos, neg)
    m = s.amax(dim=-1, keepdim=True) - 10
    e = torch.clamp_min(s - m, 0)
    soft = torch.bitwise_left_shift(torch.ones_like(e), e) - 1
    ssum = soft.sum(dim=-1, keepdim=True, dtype=torch.int32)
    return torch.div(soft * (1 << 11), ssum, rounding_mode="trunc")


def _p_quadratic(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    x64 = x.to(torch.int64)
    a64 = torch.clamp(a, -25, -7).to(torch.int64)
    one = torch.ones_like(a64)
    base = torch.bitwise_left_shift(one, 1 - 2 * a64)
    shiftbase = torch.bitwise_left_shift(one, 1 - a64)
    soft = base + x64 * shiftbase + x64 * x64
    ssum = soft.sum(dim=-1, keepdim=True)
    return torch.div(soft * (1 << 11), ssum, rounding_mode="trunc").to(torch.int32)


def loss_grad_int8(logits: torch.Tensor, ascale: torch.Tensor,
                   target_onehot: torch.Tensor) -> torch.Tensor:
    """Integer-only softmax-CE gradient -> int8 (B, C). Both branches are
    computed and one is selected on the device, so the host never reads
    ascale."""
    x = logits.to(torch.int32)
    a = torch.clamp(ascale.to(torch.int32), -25, 15)
    p = torch.where(a > -7, _p_linear(x, a), _p_quadratic(x, a))
    psum = p.sum(dim=-1, keepdim=True, dtype=torch.int32)
    g = p - psum * target_onehot.to(torch.int32)
    return numerics.psto_shift_int8(g, 4)



def loss_and_grad(logits: torch.Tensor, ascale: torch.Tensor,
                  target_onehot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float loss for logging, int8 gradient) in one call: the reference's
    `_NITI_LOSS_SUM` forward and `NITI_LOSS_Grad_Int8` backward pair
    (grad/NITI_SoftmaxGrad.cpp:41-67)."""
    return (loss_cross_entropy_float(logits, ascale, target_onehot),
            loss_grad_int8(logits, ascale, target_onehot))
