"""Weight carrier between the JAX package's params and the port's model.

The JAX package draws its weights with jax.random, which torch cannot
reproduce, so the parity tests carry the params across instead. The JAX
layout is a list with one entry per layer: {"w": (int8 HWIO data, int32
exponent)} for a conv, FC or depthwise layer (the exponent 0-d, or (C,) for
a per-channel depthwise weight), () for a layer without weights, and a
nested list for a block that holds a Sequential (a ResidualBlock's
`branch`). A QTensor of JAX arrays unpacks as the pair, so JAX params can be
passed in directly.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np


def load_jax_params(model, params: List[Any]):
    """Copy JAX-layout params into `model`'s weight buffers; returns the model."""
    if len(params) != len(model.layers):
        raise ValueError(f"{len(params)} param entries for {len(model.layers)} layers")
    for layer, p in zip(model.layers, params):
        if isinstance(p, list):
            load_jax_params(layer.branch, p)
        elif p:
            data, exp = p["w"]
            layer.load_weight(np.asarray(data), np.asarray(exp))
    return model


def export_jax_params(model) -> List[Any]:
    """The model's weights in the JAX layout, as numpy arrays."""
    out: List[Any] = []
    for layer in model.layers:
        if hasattr(layer, "branch"):
            out.append(export_jax_params(layer.branch))
        elif hasattr(layer, "weight_numpy"):
            out.append({"w": layer.weight_numpy()})
        else:
            out.append(())
    return out


def flat_weights(params: List[Any]) -> List[np.ndarray]:
    """Every array of JAX-layout params (data, then exponent, per layer), in
    layer order, nested lists flattened."""
    out: List[np.ndarray] = []
    for p in params:
        if isinstance(p, list):
            out += flat_weights(p)
        elif p:
            out += [np.asarray(a) for a in p["w"]]
    return out
