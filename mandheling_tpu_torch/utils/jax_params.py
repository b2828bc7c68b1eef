"""Weight carrier between the JAX package's params and the port's model.

The JAX package draws its weights with jax.random, which torch cannot
reproduce, so the parity tests carry the params across instead. The JAX
layout is a list with one entry per layer: {"w": (int8 HWIO data, int32
exponent)} for a conv, FC or depthwise layer (the exponent 0-d, or (C,) for
a per-channel depthwise weight), () for a layer without weights, a nested
list for a ResidualBlock (its `branch`'s) and for a Sequential used as a
layer (SqueezeNet's Fire module), a list of the branches' lists
for a ParallelConcat or ParallelAdd, and {"branch": [...], "proj": {"w":
...}} for a ProjectedResidualBlock. A QTensor of JAX arrays unpacks
as the pair, so JAX params can be passed in directly.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from ..nn.blocks import (GlobalAvgPool, NITIAvgPool, ParallelAdd, ParallelConcat,
                         ProjectedResidualBlock, ResidualBlock)
from ..nn.layers import Flatten, NITIMaxPool, NITIRelu, NITIRelu6, SqueezeLogits
from ..nn.module import Sequential

_PARALLEL = (ParallelAdd, ParallelConcat)
# the layers whose JAX params are ()
_WEIGHTLESS = (Flatten, GlobalAvgPool, NITIAvgPool, NITIMaxPool, NITIRelu, NITIRelu6,
               SqueezeLogits)


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
        elif isinstance(layer, Sequential):
            load_jax_params(layer, p)
        elif isinstance(layer, _PARALLEL):
            if len(p) != len(layer.branches):
                raise ValueError(f"{len(p)} param entries for {len(layer.branches)} branches")
            for branch, bp in zip(layer.branches, p):
                load_jax_params(branch, bp)
        elif p:
            data, exp = p["w"]
            layer.load_weight(np.asarray(data), np.asarray(exp))
    return model


def export_jax_params(model) -> List[Any]:
    """The model's weights in the JAX layout, as numpy arrays. Raises on a
    layer it does not know."""
    out: List[Any] = []
    for layer in model.layers:
        if isinstance(layer, ProjectedResidualBlock):
            out.append({"branch": export_jax_params(layer.branch),
                        "proj": {"w": layer.proj.weight_numpy()}})
        elif isinstance(layer, ResidualBlock):
            out.append(export_jax_params(layer.branch))
        elif isinstance(layer, Sequential):
            out.append(export_jax_params(layer))
        elif isinstance(layer, _PARALLEL):
            out.append([export_jax_params(branch) for branch in layer.branches])
        elif hasattr(layer, "weight_numpy"):
            out.append({"w": layer.weight_numpy()})
        elif isinstance(layer, _WEIGHTLESS):
            out.append(())
        else:
            raise TypeError(f"no JAX layout for a {type(layer).__name__} layer")
    return out


def flat_weights(params: List[Any]) -> List[np.ndarray]:
    """Every array of JAX-layout params (data, then exponent, per layer), in
    layer order, nested blocks flattened (a projected block's branch, then
    its projection; a parallel join's branches in order)."""
    out: List[np.ndarray] = []
    for p in params:
        if isinstance(p, list):
            out += flat_weights(p)
        elif p and "branch" in p:
            out += flat_weights(p["branch"]) + [np.asarray(a) for a in p["proj"]["w"]]
        elif p:
            out += [np.asarray(a) for a in p["w"]]
    return out
