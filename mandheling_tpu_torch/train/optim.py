"""NITI-SGD, float SGD with momentum and weight decay, ADAM, and the
reference's learning-rate schedules (port of ``mandheling_tpu/train/optim.py``).

The float optimizers update lists of tensors in place, where the JAX package
returns new pytrees. The schedules return Python floats computed in double
precision; the JAX package computes them in float32."""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch

from ..nn.blocks import ParallelAdd, ParallelConcat, ProjectedResidualBlock
from ..nn.module import NITILayer, Sequential
from ..ops.numerics import int8_clip


def _update_weight(layer: NITILayer, g) -> None:
    layer.w.copy_(int8_clip(layer.w.to(torch.int32) - g["w"].data.to(torch.int32)))


def niti_sgd_update(model: Sequential, grads: List) -> None:
    """w <- clip_int8(w - g) for every layer with a weight grad; exponents
    unchanged (`NITI_SGD.hpp:20-57`). Updates the weight buffers in place,
    where the JAX package returns new params: no second copy of the model.
    A block's grads nest as its params do: a ResidualBlock's are its
    branch's list, a Sequential's (used as a layer) its own list, a ParallelConcat's or ParallelAdd's one list per branch,
    a ProjectedResidualBlock's {"branch": [...], "proj": {"w": ...}}; the
    update recurses into them."""
    for layer, g in zip(model.layers, grads):
        if isinstance(layer, ProjectedResidualBlock):
            niti_sgd_update(layer.branch, g["branch"])
            _update_weight(layer.proj, g["proj"])
        elif isinstance(layer, (ParallelAdd, ParallelConcat)):
            for branch, gb in zip(layer.branches, g):
                niti_sgd_update(branch, gb)
        elif isinstance(layer, Sequential):
            niti_sgd_update(layer, g)
        elif isinstance(g, list):
            niti_sgd_update(layer.branch, g)
        elif g:
            _update_weight(layer, g)


def sgd_init(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero velocities, one per parameter."""
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def sgd_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               velocity: List[torch.Tensor], lr: Union[float, torch.Tensor],
               momentum: float = 0.9, weight_decay: float = 5e-4) -> None:
    """Reference float SGD (optimizer/SGD.cpp:79-100): v <- m*v + lr*(g +
    wd*w); w <- w - v. Updates the parameters and velocities in place.

    `lr` is a Python float or a 0-d tensor of the parameters' dtype on
    their device: a captured step (step_graph.py) takes it as a tensor, so
    that its value can change at every replay, as the JAX float step takes
    it as a traced float32 argument. Both give the same bytes: the float is
    rounded to the parameters' dtype before it multiplies."""
    for w, g, v in zip(params, grads, velocity):
        v.copy_(momentum * v + lr * (g + weight_decay * w))
        w.sub_(v)


def adam_init(params: Sequence[torch.Tensor]) -> Dict:
    """Zero first and second moments, one each per parameter, and the step
    count `t`, a 0-d int32 tensor."""
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "t": torch.zeros((), dtype=torch.int32, device=params[0].device)}


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
                lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> None:
    """ADAM with the reference's weight decay folded into the gradient
    (optimizer/ADAM.cpp): g += wd * w; m <- b1 m + (1 - b1) g; v <- b2 v +
    (1 - b2) g^2; w <- w - lr mhat / (sqrt(vhat) + eps). The bias
    corrections 1 - b^t are float32, as the JAX package computes them.
    Updates the parameters and `state` in place."""
    state["t"] += 1
    tf = state["t"].to(torch.float32)
    bc1 = 1 - torch.full_like(tf, b1) ** tf
    bc2 = 1 - torch.full_like(tf, b2) ** tf
    for w, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = g + weight_decay * w
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        w.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


def lr_inv(base_lr: float, step, gamma: float = 1e-4, power: float = 0.75) -> float:
    """inv: lr = base * (1 + gamma*step)^(-power) (MnistUtils.cpp:124).
    NITI-SGD ignores it; logged for parity."""
    return base_lr * (1.0 + gamma * float(step)) ** (-power)


def lr_exp(base_lr: float, step, gamma: float = 0.999) -> float:
    """exp: lr = base * gamma^step."""
    return base_lr * gamma ** float(step)


def lr_multistep(base_lr: float, step, milestones: Sequence[int], gamma: float = 0.1) -> float:
    """multistep: lr = base * gamma^(number of milestones reached)."""
    return base_lr * gamma ** sum(step >= m for m in milestones)
