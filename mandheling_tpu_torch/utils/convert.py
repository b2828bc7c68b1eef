"""Model converter: import external-framework (PyTorch) weights.

The reference ships a 54k-LoC converter that imports TF/TFLite/ONNX/Caffe/
Torch models into its own format (`tools/converter/`, SURVEY.md section 2.9),
after which `Transformer::turnModelToTrainable` rewrites them for training
(`tools/train/source/transformer/Transformer.cpp:69`). The TPU-native analog
imports a PyTorch `state_dict` (torch is the representative external
framework available in this environment) into this framework's fp32 model
params; from there the existing paths take over — `quantize_params_tree`
(utils/checkpoint.py) for NITI int8 transfer/PTQ, `train/transfer.py` for
turn-trainable.

Layout rules (PyTorch -> here):
- Conv2d weight  OIHW -> HWIO (`transpose(2, 3, 1, 0)`); depthwise (C,1,k,k)
  lands directly in our (k, k, 1, C) layout under the same transpose.
- BatchNorm2d   weight/bias/running_mean/running_var -> scale/bias/mean/var.
- Linear        (out, in) -> 1x1 conv (1, 1, in, out); a linear that follows
  a conv flatten needs the (C,H,W)->(H,W,C) feature permutation (torch
  flattens channel-major, NHWC flattens channel-minor).

Module grouping is order-preserving: `state_dict` iteration order is module
registration order, which for architecture-matched models equals this
framework's spec order.

The port's own copy of ``mandheling_tpu/utils/convert.py``. The adapters
return the fp32 models' params trees as float32 numpy arrays (the JAX
package's trees, held in numpy), which the port's float models take through
`load_params`; torch loads a `state_dict` natively.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def modules_from_state_dict(state_dict) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Group a torch state_dict into an ordered list of
    (kind, arrays) with kind in {"conv", "bn", "linear"}.

    Grouping key is the parameter name minus its last component; kinds are
    recognized by shape signature (4-D weight = conv, 2-D = linear, 1-D
    weight with running stats = batchnorm).
    """
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    order: List[str] = []
    for name, tensor in state_dict.items():
        if name.endswith("num_batches_tracked"):
            continue
        prefix, _, leaf = name.rpartition(".")
        if prefix not in groups:
            groups[prefix] = {}
            order.append(prefix)
        groups[prefix][leaf] = _to_np(tensor)

    modules: List[Tuple[str, Dict[str, np.ndarray]]] = []
    for prefix in order:
        g = groups[prefix]
        w = g.get("weight")
        if w is None:
            raise ValueError(f"module {prefix!r} has no weight: {list(g)}")
        if w.ndim == 4:
            entry = {"w": w.transpose(2, 3, 1, 0)}  # OIHW -> HWIO
            if "bias" in g:
                entry["b"] = g["bias"]
            modules.append(("conv", entry))
        elif w.ndim == 2:
            entry = {"w": w}  # (out, in); adapters reshape
            if "bias" in g:
                entry["b"] = g["bias"]
            modules.append(("linear", entry))
        elif w.ndim == 1 and "running_mean" in g:
            modules.append(
                (
                    "bn",
                    {
                        "scale": g["weight"],
                        "bias": g["bias"],
                        "mean": g["running_mean"],
                        "var": g["running_var"],
                    },
                )
            )
        else:
            raise ValueError(
                f"module {prefix!r}: unrecognized shape {w.shape}"
            )
    return modules


def chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """Feature permutation for a linear following a conv flatten: index i of
    the NHWC flatten (h, w, c order) -> torch's channel-major index."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _linear_to_conv1x1(
    entry: Dict[str, np.ndarray], in_perm: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    w = entry["w"].T  # (in, out)
    if in_perm is not None:
        w = w[in_perm]
    out = {"w": _f32(w.reshape(1, 1, *w.shape))}
    if "b" in entry:
        out["b"] = _f32(entry["b"])
    return out


class _Cursor:
    def __init__(self, modules):
        self.modules = modules
        self.i = 0

    def take(self, kind: str) -> Dict[str, np.ndarray]:
        if self.i >= len(self.modules):
            raise ValueError(f"ran out of torch modules wanting {kind!r}")
        k, entry = self.modules[self.i]
        if k != kind:
            raise ValueError(
                f"torch module #{self.i} is {k!r}, expected {kind!r} — "
                "architecture mismatch"
            )
        self.i += 1
        return entry

    def done(self):
        if self.i != len(self.modules):
            raise ValueError(
                f"{len(self.modules) - self.i} unconsumed torch modules "
                "— architecture mismatch"
            )


def lenet_fp32_from_torch(state_dict) -> Dict[str, Any]:
    """Torch LeNet (Conv2d(1,20,5), Conv2d(20,50,5), Linear(800,500),
    Linear(500,10), flatten after 2x maxpool on 28x28 input) ->
    models.LeNetFP32 params (the reference MnistV2, demo/mnistTrain.cpp:28)."""
    return lenet_fp32_from_modules(modules_from_state_dict(state_dict))


def lenet_fp32_from_modules(modules) -> Dict[str, Any]:
    """Same adapter over an ordered module list from ANY importer
    (modules_from_state_dict, utils/onnx_io.modules_from_onnx)."""
    cur = _Cursor(modules)
    conv1 = cur.take("conv")
    conv2 = cur.take("conv")
    ip1 = cur.take("linear")
    ip2 = cur.take("linear")
    cur.done()
    perm = chw_to_hwc_perm(c=50, h=4, w=4)  # 28->24->12->8->4 spatial
    return {
        "conv1": {k: _f32(v) for k, v in conv1.items() if k != "meta"},
        "conv2": {k: _f32(v) for k, v in conv2.items() if k != "meta"},
        "ip1": _linear_to_conv1x1(ip1, perm),
        "ip2": _linear_to_conv1x1(ip2),
    }


def _bn_params(entry: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: _f32(v) for k, v in entry.items()}


def mobilenet_fp32_from_torch(state_dict, model) -> List[Any]:
    """Torch MobileNet V1/V2 (architecture-matched to
    models.MobileNetV{1,2}FP32's spec, module registration in spec order) ->
    that model's params list."""
    return mobilenet_fp32_from_modules(modules_from_state_dict(state_dict), model)


def mobilenet_fp32_from_modules(modules, model) -> List[Any]:
    """MobileNet adapter over any importer's ordered module list."""
    cur = _Cursor(modules)

    def build(kind, cfg):
        if kind in ("conv_bn", "dw_bn", "pw_bn_linear"):
            conv = cur.take("conv")
            bn = cur.take("bn")
            return {"w": _f32(conv["w"]), "bn": _bn_params(bn)}
        if kind == "bottleneck":
            sub, _ = cfg
            return [build(k, c) for k, c in sub]
        # head: linear after global average pool (1x1 spatial, no perm)
        return _linear_to_conv1x1(cur.take("linear"))

    params = [build(kind, cfg) for kind, cfg in model._spec()]
    cur.done()
    return params


def load_torch_file(path: str):
    """torch.load a .pt/.pth checkpoint; unwraps common 'state_dict' keys."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj
