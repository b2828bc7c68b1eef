"""NITI int8 ReLU / ReLU6 forward and backward (port of
``mandheling_tpu/ops/relu.py``; reference `NITI_CPURelu_Int8.cpp`,
`NITI_CPUReluGrad_Int8.cpp:28-62`)."""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def relu_grad(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Pass gy where the forward input was > 0."""
    return torch.where(x > 0, gy, torch.zeros_like(gy))


def relu6_cap(exp: torch.Tensor) -> torch.Tensor:
    """int32 cap such that data * 2^exp <= 6.0: 6 * 2^(-exp), saturated to
    127 (exp <= -5 -> 127; exp >= 3 -> 0)."""
    e = exp.to(torch.int32)
    six = torch.full_like(e, 6)
    lo = torch.clamp_max(torch.bitwise_left_shift(six, torch.clamp(-e, 0, 5)), 127)
    hi = six >> torch.clamp(e, 0, 31)
    return torch.where(e <= 0, lo, hi)


def relu6(x: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """Exponent-aware int8 ReLU6: clamp the value to [0, 6.0] in the
    tensor's own power-of-two scale; exponent passthrough."""
    cap = relu6_cap(exp).to(torch.int8)
    return torch.minimum(torch.clamp_min(x, 0), cap)


def _relu6_mask(v: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    # cap == 127: 6.0 is not representable at this exponent, so a value on
    # the rail was saturated, not clipped, and still passes gradient
    cap = relu6_cap(exp).to(torch.int8)
    return (v > 0) & ((v < cap) | (cap == 127))


def relu6_grad(x: torch.Tensor, exp: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Pass gy where the forward input was strictly inside (0, cap)."""
    return torch.where(_relu6_mask(x, exp), gy, torch.zeros_like(gy))


def relu6_grad_from_output(y: torch.Tensor, exp: torch.Tensor,
                           gy: torch.Tensor) -> torch.Tensor:
    """relu6 backward masked by the forward output: 0 < y < cap exactly when
    0 < x < cap, so the layer keeps only its output alive."""
    return torch.where(_relu6_mask(y, exp), gy, torch.zeros_like(gy))
