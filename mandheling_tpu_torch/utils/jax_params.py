"""Weight carrier between the JAX package's params and the port's model.

The JAX package draws its weights with jax.random, which torch cannot
reproduce, so the parity tests carry the params across instead. The JAX
layout is a list with one entry per layer: {"w": (int8 HWIO data, int32
exponent)} for a conv, FC or depthwise layer (the exponent 0-d, or (C,) for
a per-channel depthwise weight), () for a layer without weights, a nested
list for a ResidualBlock (its `branch`'s), and {"branch": [...], "proj":
{"w": ...}} for a ProjectedResidualBlock. A QTensor of JAX arrays unpacks
as the pair, so JAX params can be passed in directly.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from ..nn.blocks import ProjectedResidualBlock, ResidualBlock


def load_jax_params(model, params: List[Any]):
    """Copy JAX-layout params into `model`'s weight buffers; returns the model."""
    if len(params) != len(model.layers):
        raise ValueError(f"{len(params)} param entries for {len(model.layers)} layers")
    for layer, p in zip(model.layers, params):
        if isinstance(layer, ProjectedResidualBlock):
            load_jax_params(layer.branch, p["branch"])
            layer.proj.load_weight(*(np.asarray(a) for a in p["proj"]["w"]))
        elif isinstance(layer, ResidualBlock):
            load_jax_params(layer.branch, p)
        elif p:
            data, exp = p["w"]
            layer.load_weight(np.asarray(data), np.asarray(exp))
    return model


def export_jax_params(model) -> List[Any]:
    """The model's weights in the JAX layout, as numpy arrays."""
    out: List[Any] = []
    for layer in model.layers:
        if isinstance(layer, ProjectedResidualBlock):
            out.append({"branch": export_jax_params(layer.branch),
                        "proj": {"w": layer.proj.weight_numpy()}})
        elif isinstance(layer, ResidualBlock):
            out.append(export_jax_params(layer.branch))
        elif hasattr(layer, "weight_numpy"):
            out.append({"w": layer.weight_numpy()})
        else:
            out.append(())
    return out


def flat_weights(params: List[Any]) -> List[np.ndarray]:
    """Every array of JAX-layout params (data, then exponent, per layer), in
    layer order, nested blocks flattened (a projected block's branch, then
    its projection)."""
    out: List[np.ndarray] = []
    for p in params:
        if isinstance(p, list):
            out += flat_weights(p)
        elif p and "branch" in p:
            out += flat_weights(p["branch"]) + [np.asarray(a) for a in p["proj"]["w"]]
        elif p:
            out += [np.asarray(a) for a in p["w"]]
    return out
