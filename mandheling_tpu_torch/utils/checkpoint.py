"""Checkpoints and inference artifacts (port of
``mandheling_tpu/utils/checkpoint.py``), in the same npz format, so that a
file written by either package loads in the other.

A checkpoint is a flat npz of the params in the JAX layout
(``utils/jax_params.py``): one array per leaf, keyed by its JAX tree path
(``[0]/['w']/.data``, ``[0]/['w']/.exp``, with one more ``[i]/`` level per
residual branch, ``[k]/[b]/[i]/['w']/...`` for layer i of branch b of a
parallel join k, and ``[i]/['branch']/...``, ``[i]/['proj']/['w']/...`` in a
projected residual block), plus ``__meta__``, a JSON record of the step, the schema
version and any extra. Loaders accept every schema up to
:data:`SCHEMA_VERSION`, upgrading older files in memory (v0, written before
the field existed, gains it), and refuse newer ones.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import lenet_niti, mobilenet_v1_niti, mobilenet_v2_niti, resnet18_niti
from ..ops.qtensor import QTensor, quantize_weights
from .jax_params import export_jax_params, load_jax_params

SCHEMA_VERSION = 1

# version -> in-memory upgrade of (meta, arrays); applied in sequence
_MIGRATIONS = {
    # v0 (no schema field) -> v1: no array changes, just the field
    0: lambda meta, arrays: ({**meta, "schema": 1}, arrays),
}


def _flatten_entry(p, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """The leaves of one entry at `prefix` (its tree path, ending in "/")."""
    if isinstance(p, list):
        out.update(flatten_params(p, prefix))
    elif p and "branch" in p:  # a projected block: JAX sorts the dict's keys
        out.update(flatten_params(p["branch"], prefix + "['branch']/"))
        _flatten_entry(p["proj"], prefix + "['proj']/", out)
    elif p:
        data, exp = p["w"]
        out[prefix + "['w']/.data"] = np.asarray(data)
        out[prefix + "['w']/.exp"] = np.asarray(exp)


def flatten_params(params: List[Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """{JAX tree path: array} of JAX-layout params, in tree order."""
    out: Dict[str, np.ndarray] = {}
    for i, p in enumerate(params):
        _flatten_entry(p, f"{prefix}[{i}]/", out)
    return out


def _unflatten_entry(p, arrays: Dict[str, np.ndarray], prefix: str):
    if isinstance(p, list):
        return _unflatten(p, arrays, prefix)
    if p and "branch" in p:
        return {"branch": _unflatten(p["branch"], arrays, prefix + "['branch']/"),
                "proj": _unflatten_entry(p["proj"], arrays, prefix + "['proj']/")}
    if not p:
        return ()
    leaves = []
    for leaf, field in zip(p["w"], ("data", "exp")):
        key = f"{prefix}['w']/.{field}"
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        want = np.asarray(leaf)
        if arrays[key].shape != want.shape:
            raise ValueError(f"shape mismatch at {key}: {arrays[key].shape} vs {want.shape}")
        leaves.append(np.asarray(arrays[key], dtype=want.dtype))
    return {"w": tuple(leaves)}


def _unflatten(template: List[Any], arrays: Dict[str, np.ndarray], prefix: str = "") -> List[Any]:
    return [_unflatten_entry(p, arrays, f"{prefix}[{i}]/") for i, p in enumerate(template)]


def _migrate(meta, arrays):
    v = int(meta.get("schema", 0))
    if v > SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint schema v{v} is newer than this build's "
            f"v{SCHEMA_VERSION}: upgrade the framework to load it"
        )
    while v < SCHEMA_VERSION:
        meta, arrays = _MIGRATIONS[v](meta, arrays)
        v = int(meta["schema"])
    return meta, arrays


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """{JAX tree path: array} of any tree of dicts, lists, tuples and
    QTensors (a float model's params, ``quantize_params_tree``'s output), in
    the order and with the keys of ``jax.tree.flatten_with_path``: dict keys
    sorted as ``['key']``, sequence items ``[i]``, QTensor fields ``.data``
    and ``.exp``."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, QTensor):
            for field in node._fields:
                walk(getattr(node, field), path + [f".{field}"])
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [f"[{k!r}]"])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [f"[{i}]"])
        elif node is not None:
            if isinstance(node, torch.Tensor):
                node = node.detach().cpu().numpy()
            out["/".join(path)] = np.asarray(node)

    walk(tree, [])
    return out


def save_tree(path: str, tree: Any, step: int = 0, extra: Any = None) -> None:
    """Save any params tree (``flatten_tree``) as the JAX package's
    ``save_checkpoint`` saves it."""
    _write(path, flatten_tree(tree), step, extra)


def save_checkpoint(path: str, params: List[Any], step: int = 0, extra: Any = None) -> None:
    """Save JAX-layout params (``export_jax_params(model)``) and the step to
    an npz, atomically through a temporary file."""
    _write(path, flatten_params(params), step, extra)


def _write(path: str, arrays: Dict[str, np.ndarray], step: int, extra: Any) -> None:
    meta = {"step": int(step), "schema": SCHEMA_VERSION}
    if extra is not None:
        meta["extra"] = extra
    tmp = path + ".tmp"
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    # np.savez appends .npz to the temporary name
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str, template: List[Any]) -> Tuple[List[Any], int]:
    """-> (params, step): the file's arrays in the structure and dtypes of
    the JAX-layout params `template` (``export_jax_params(model)``)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    meta, arrays = _migrate(meta, arrays)
    return _unflatten(template, arrays), meta["step"]


def quantize_params_tree(float_params: Any) -> Any:
    """Turn a float weight tree (nested dicts, lists and tuples of tensors or
    arrays) into NITI QTensors, leaf by leaf (`ops.qtensor.quantize_weights`):
    the analog of `Transformer::turnModelToTrainable`
    (transformer/Transformer.cpp:69), which converts a trained or loaded
    float model into int8 trainable state."""
    if isinstance(float_params, dict):
        return {k: quantize_params_tree(v) for k, v in float_params.items()}
    if isinstance(float_params, (list, tuple)):
        return type(float_params)(quantize_params_tree(v) for v in float_params)
    return quantize_weights(torch.as_tensor(float_params))


# ---- inference artifacts: the model's registry name and kwargs beside its
# params (the JAX package's export_inference / load_inference) ----

_MODEL_REGISTRY = {
    "lenet_niti": lenet_niti,
    "mobilenet_v1_niti": mobilenet_v1_niti,
    "mobilenet_v2_niti": mobilenet_v2_niti,
    "resnet18_niti": resnet18_niti,
}


def _constructor(name: Optional[str]):
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name]


def export_inference(path: str, model_name: str, params: List[Any], **model_kwargs) -> None:
    """Save the model's registry name and kwargs with its params."""
    _constructor(model_name)
    save_checkpoint(path, params, step=0, extra={"model": model_name, "kwargs": model_kwargs})


def load_inference(path: str):
    """-> (model, params): the model rebuilt from the registry with the
    artifact's weights loaded (on the CPU; move it with ``.to``)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
    extra = meta.get("extra") or {}
    model = _constructor(extra.get("model"))(**extra.get("kwargs", {}))
    params, _ = load_checkpoint(path, export_jax_params(model))
    return load_jax_params(model, params), params
