"""Weight carrier between the JAX package's params and the port's model.

The JAX package draws its weights with jax.random, which torch cannot
reproduce, so the parity tests carry the params across instead. The JAX
layout is a list with one entry per layer: {"w": (int8 HWIO data, int32
exponent)} for a conv or FC layer, () for the others. A QTensor of JAX
arrays unpacks as that pair, so JAX params can be passed in directly.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np


def load_jax_params(model, params: List[Any]):
    """Copy JAX-layout params into `model`'s weight buffers; returns the model."""
    if len(params) != len(model.layers):
        raise ValueError(f"{len(params)} param entries for {len(model.layers)} layers")
    for layer, p in zip(model.layers, params):
        if p:
            data, exp = p["w"]
            layer.load_weight(np.asarray(data), np.asarray(exp))
    return model


def export_jax_params(model) -> List[Any]:
    """The model's weights in the JAX layout, as numpy arrays."""
    return [
        {"w": layer.weight_numpy()} if hasattr(layer, "weight_numpy") else ()
        for layer in model.layers
    ]
