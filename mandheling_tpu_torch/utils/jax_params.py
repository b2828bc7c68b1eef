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

The fake-quant LeNetQAT keeps the JAX package's float dicts instead: its
params {"conv1": {"w", "b"}, ...} and one observer dict a layer
(:func:`load_qat_params`, :func:`export_qat_params`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def load_qat_params(model, params: Dict[str, Dict[str, Any]],
                    observers: Optional[Dict[str, Dict[str, Any]]] = None):
    """Copy the JAX package's LeNetQAT params ({"conv1": {"w", "b"}, ...})
    and, if given, its observer dicts ({"conv1": {"in_min", ...}, ...}) into
    `model` (models/lenet_qat.py), in the model's own dtype; returns it."""
    with torch.no_grad():
        for name, layer in model.layers.items():
            for key, dst in layer.items():
                src = torch.from_numpy(np.array(params[name][key]))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}.{key}: shape {tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        for name, obs in (observers or {}).items():
            for key, value in obs.items():
                getattr(model.observers[name], key).fill_(float(np.asarray(value)))
    return model


def export_qat_params(model) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                                      Dict[str, Dict[str, np.ndarray]]]:
    """(params, observers) of a LeNetQAT in the JAX package's layout, as
    numpy arrays."""
    params = {name: {key: p.detach().cpu().numpy() for key, p in layer.items()}
              for name, layer in model.layers.items()}
    observers = {name: {key: v.cpu().numpy() for key, v in obs.as_dict().items()}
                 for name, obs in model.observers.items()}
    return params, observers
