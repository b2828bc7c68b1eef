"""Fake-quant QAT conv, the reference's `NN::ConvInt8` path (port of
``mandheling_tpu/nn/qat.py``; reference `tools/train/source/nn/NN.cpp:560-780`):

- weights: per-output-channel symmetric fake quant, scale = max(|w|, 1e-6)
  / clamp, w' = clamp(round(w / scale)) * scale;
- activations (input and output): per-tensor asymmetric fake quant with
  min / max observers, updated by moving average (momentum 0.99) or maximum
  (NN.cpp:666-680); the first observation is taken as it is;
- clamp = 2^(bits-1) - 1.

Gradients pass straight through the rounding (the reference's
cast-breaks-grad + ZeroGrad construction) and observer values carry none.
The functions are the JAX package's, on float tensors; NHWC inputs, HWIO
weights.

The scales multiply by the reciprocal of their constant divisor, as XLA
compiles the JAX package's `/ clamp` under jit (its demos jit their steps):
the eager JAX function divides, and at some inputs the two part by a quant
step.

Deliberate difference: the straight-through value is q + (x - x.detach()),
exactly q, where the JAX package computes x + stop_gradient(q - x). The two
are equal (q - x is exact) wherever x lies within twice the quantization
range; past it, for an activation more than twice its observed range, the
JAX value is q give or take an ulp that depends on the last bit of the conv
that made x, and that ulp decides which of a pooling window's clipped, tied
maxima takes the gradient. Exact q makes the port's result independent of
the device's summation order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return q.detach() + (x - x.detach())


def fake_quant_weight_perchannel(w: torch.Tensor, clamp: float = 127.0) -> torch.Tensor:
    """HWIO weights, per-output-channel symmetric fake quant with STE."""
    scale = torch.clamp_min(torch.abs(w).amax(dim=(0, 1, 2), keepdim=True), 1e-6) * (1.0 / clamp)
    q = torch.clamp(torch.round(w / scale), -clamp, clamp) * scale
    return _ste(w, q)


def compute_scale_zeropoint(mn: torch.Tensor, mx: torch.Tensor,
                            clamp: float = 127.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric per-tensor scale and zero point from observed min / max,
    nudged so that 0 is representable (NN.cpp `computeScaleAndZeroPoint`)."""
    mn = torch.clamp_max(mn, 0.0)
    mx = torch.clamp_min(mx, 0.0)
    scale = torch.clamp_min(mx - mn, 1e-6) * (1.0 / (2.0 * clamp))
    zp = torch.clamp(torch.round(-clamp - mn / scale), -clamp, clamp)
    return scale, zp


def fake_quant_feature(x: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                       clamp: float = 127.0) -> torch.Tensor:
    scale, zp = compute_scale_zeropoint(mn, mx, clamp)
    q = torch.clamp(torch.round(x / scale + zp), -clamp, clamp)
    return _ste(x, (q - zp) * scale)


def update_observer(old: torch.Tensor, new: torch.Tensor, initialized: torch.Tensor,
                    method: str = "moving_average", momentum: float = 0.99) -> torch.Tensor:
    """NN.cpp:666-680: moving-average or maximum observer update; while
    `initialized` is 0 the new observation is taken directly."""
    new = new.detach()
    if method == "moving_average":
        blended = old * momentum + new * (1.0 - momentum)
    elif method == "maximum":
        blended = torch.maximum(old, new)
    else:
        raise ValueError(method)
    return torch.where(initialized > 0, blended, new)


def qat_conv_init(shape_hwio, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """{"w": Glorot-normal HWIO float32 weights (std sqrt(2 / (fan_in +
    fan_out))), "b": zeros}, drawn from torch's generator (the JAX package
    draws them with jax.random)."""
    kh, kw, ic, oc = shape_hwio
    std = (2.0 / (ic * kh * kw + oc * kh * kw)) ** 0.5
    return {"w": torch.randn(tuple(shape_hwio), generator=generator) * std,
            "b": torch.zeros((oc,))}


def qat_observer_init() -> Dict[str, torch.Tensor]:
    """A layer's observers, all 0 (`initialized` 0: the first observation
    is taken as it is)."""
    return {k: torch.zeros(()) for k in ("in_min", "in_max", "out_min", "out_max", "initialized")}


def qat_conv_apply(params: Dict[str, torch.Tensor], obs: Dict[str, torch.Tensor],
                   x: torch.Tensor, bits: int = 8,
                   activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                   training: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fake-quant conv forward, stride 1 and VALID (LeNetQAT's; the JAX
    function also takes others) -> (y, updated observers); `obs` itself is
    left as it was."""
    clamp = float(2 ** (bits - 1) - 1)
    w = fake_quant_weight_perchannel(params["w"], clamp)

    new_obs = dict(obs)
    init = obs["initialized"]
    if training:
        new_obs["in_min"] = update_observer(obs["in_min"], torch.amin(x), init)
        new_obs["in_max"] = update_observer(obs["in_max"], torch.amax(x), init)
    x = fake_quant_feature(x, new_obs["in_min"], new_obs["in_max"], clamp)

    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    y = y.permute(0, 2, 3, 1) + params["b"]
    if activation is not None:
        y = activation(y)
    if training:
        new_obs["out_min"] = update_observer(obs["out_min"], torch.amin(y), init)
        new_obs["out_max"] = update_observer(obs["out_max"], torch.amax(y), init)
        new_obs["initialized"] = torch.ones_like(init)
    y = fake_quant_feature(y, new_obs["out_min"], new_obs["out_max"], clamp)
    return y, new_obs
