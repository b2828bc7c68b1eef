"""Float MobileNet V1 / V2 with batch norm (port of
``mandheling_tpu/models/mobilenet_fp32.py``; reference
`tools/train/source/models/MobilenetV2.cpp`, `MobilenetV1.cpp`): the fp32
twins of the NITI MobileNets, trained by autograd (`train_fp32_bn`).

The layout is the JAX package's: NHWC inputs, HWIO weights, and parameters
in its nested tree, one entry per spec item, ``{"w", "bn": {"scale",
"bias", "mean", "var"}}`` for a conv with batch norm, a list of those for a
bottleneck, ``{"w", "b"}`` for the head (:meth:`load_params` and
:meth:`params_numpy` carry it across). The running stats are buffers, so an
optimizer over ``parameters()`` never touches them; a training forward
updates them in place, as the JAX trainer takes them from its forward.

The batch norm is the JAX package's, written out (it is not torch's): the
biased variance both normalises and feeds the running stat, the running
stats keep 0.99 of their old value, and y = (x - mean) * rsqrt(var + 1e-5)
* scale + bias. The convs are cuDNN's (``F.conv2d``), with the TF "SAME"
pads (the odd pixel at the end) added explicitly where they are uneven.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import resolve_padding
from .mobilenet import CIFAR_PLAN, V1_CIFAR_PLAN


def _conv_init(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """He-normal HWIO weight: N(0, 1) * sqrt(2 / (KH * KW * I)), on the CPU."""
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(tuple(shape), generator=generator) * math.sqrt(2.0 / fan_in)


def _bn_init(c: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
            "var": torch.ones(c)}


def _bn_apply(bn: nn.Module, x: torch.Tensor, training: bool,
              momentum: float = 0.99) -> torch.Tensor:
    """Batch norm over N, H, W of an NHWC tensor. In training the batch's
    mean and biased variance normalise, and the running stats `bn.mean`,
    `bn.var` become momentum * old + (1 - momentum) * batch's, in place."""
    if training:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
        with torch.no_grad():
            bn.mean.copy_(momentum * bn.mean + (1 - momentum) * mean)
            bn.var.copy_(momentum * bn.var + (1 - momentum) * var)
    else:
        mean, var = bn.mean, bn.var
    return (x - mean) * torch.rsqrt(var + 1e-5) * bn.scale + bn.bias


def _relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6), as jnp.clip computes it: at a tie (x exactly 0
    or 6, as a batch norm gives for a channel that is constant over the
    batch) the gradient is split in halves between x and the bound, where
    torch.clamp would pass all of it."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC x * HWIO w with "SAME" pads -> NHWC; `groups` = channels for a
    depthwise (KH, KW, 1, C) weight."""
    (pt, pb), (pl, pr) = resolve_padding("SAME", tuple(w.shape[:2]), (stride, stride),
                                         tuple(x.shape[1:3]))
    xn = x.permute(0, 3, 1, 2)
    padding: Tuple[int, int] = (pt, pl)
    if (pt, pl) != (pb, pr):
        xn, padding = F.pad(xn, (pl, pr, pt, pb)), (0, 0)
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


class _Node(nn.Module):
    """One dict of the JAX params tree: tensors by key (the batch norm's
    running "mean" and "var" as buffers, the rest as parameters), nested
    dicts as child nodes."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _Node(value))
            elif key in ("mean", "var"):
                self.register_buffer(key, value.clone())
            else:
                self.register_parameter(key, nn.Parameter(value.clone()))


def _tree_module(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_tree_module(t) for t in tree])
    return _Node(tree)


def _load(module: nn.Module, tree, path: str = "") -> None:
    if isinstance(module, nn.ModuleList):
        if len(tree) != len(module):
            raise ValueError(f"{path or 'params'}: {len(tree)} entries for {len(module)}")
        for i, (m, t) in enumerate(zip(module, tree)):
            _load(m, t, f"{path}[{i}]")
        return
    if set(tree) != set(module.keys):
        raise ValueError(f"{path}: keys {sorted(tree)} != {sorted(module.keys)}")
    for key in module.keys:
        dst = getattr(module, key)
        if isinstance(dst, _Node):
            _load(dst, tree[key], f"{path}.{key}")
            continue
        src = torch.from_numpy(np.array(tree[key], dtype=np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}.{key}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


def _export(module: nn.Module):
    if isinstance(module, nn.ModuleList):
        return [_export(m) for m in module]
    out = {}
    for key in module.keys:
        value = getattr(module, key)
        out[key] = _export(value) if isinstance(value, _Node) else value.detach().cpu().numpy()
    return out


class FP32Tree(nn.Module):
    """Base of the float twins: the params tree `self.params` (an
    nn.ModuleList mirroring the JAX list), drawn by `_init_tree` from seed
    0 until `reset_parameters` or a load."""

    def __init__(self):
        super().__init__()
        self.params = _tree_module(self._init_tree(torch.Generator().manual_seed(0)))

    def _init_tree(self, generator: Optional[torch.Generator]) -> List[Any]:
        raise NotImplementedError

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw the weights from `generator` (CPU), in the JAX init's order;
        batch norms at scale 1, bias 0, mean 0, var 1; zero head bias."""
        _load(self.params, self._init_tree(generator))
        return self

    def load_params(self, params) -> "FP32Tree":
        """Copy a JAX-layout float tree into the parameters and buffers."""
        _load(self.params, params)
        return self

    def params_numpy(self):
        """The parameters and running stats in the JAX layout, as numpy."""
        return _export(self.params)


class MobileNetV2FP32(FP32Tree):
    """CIFAR-scaled float MobileNetV2 (32x32 inputs, CIFAR_PLAN strides):
    conv + BN + relu6 blocks, linear bottleneck outputs, residual where the
    stride is 1 and the widths agree, a global pool and a 1x1 head."""

    def __init__(self, num_classes: int = 10, width_mult: float = 1.0):
        self.num_classes = num_classes
        self.wm = width_mult
        self.spec = self._spec()
        super().__init__()

    def _c(self, ch: int) -> int:
        return max(8, int(ch * self.wm) // 8 * 8)

    def _spec(self) -> List[Tuple[str, Any]]:
        """(kind, cfg) list: kind in {conv_bn, dw_bn, pw_bn_linear,
        bottleneck, head}; a bottleneck's cfg is (sub_spec, residual)."""
        c = self._c
        spec: List[Tuple[str, Any]] = [("conv_bn", (3, c(32), 3, 1))]
        in_c = c(32)
        for expansion, out_c, n, stride in CIFAR_PLAN:
            out_c = c(out_c)
            for i in range(n):
                s = stride if i == 0 else 1
                mid = in_c * expansion
                sub: List[Tuple[str, Any]] = []
                if expansion != 1:
                    sub.append(("conv_bn", (in_c, mid, 1, 1)))
                sub.append(("dw_bn", (mid, 3, s)))
                sub.append(("pw_bn_linear", (mid, out_c, False)))
                spec.append(("bottleneck", (sub, in_c == out_c and s == 1)))
                in_c = out_c
        spec.append(("conv_bn", (in_c, c(1280), 1, 1)))
        spec.append(("head", (c(1280), self.num_classes)))
        return spec

    def _init_entry(self, generator, kind, cfg):
        if kind == "conv_bn":
            ic, oc, k, _ = cfg
            return {"w": _conv_init((k, k, ic, oc), generator), "bn": _bn_init(oc)}
        if kind == "dw_bn":
            ch, k, _ = cfg
            return {"w": _conv_init((k, k, 1, ch), generator), "bn": _bn_init(ch)}
        if kind == "pw_bn_linear":
            ic, oc, _ = cfg
            return {"w": _conv_init((1, 1, ic, oc), generator), "bn": _bn_init(oc)}
        if kind == "bottleneck":
            return [self._init_entry(generator, kd, c) for kd, c in cfg[0]]
        ic, nc = cfg  # head
        return {"w": _conv_init((1, 1, ic, nc), generator), "b": torch.zeros(nc)}

    def _init_tree(self, generator):
        return [self._init_entry(generator, kind, cfg) for kind, cfg in self.spec]

    def _apply_entry(self, p, kind, cfg, x, training):
        if kind == "conv_bn":
            return _relu6(_bn_apply(p.bn, _conv(x, p.w, cfg[3]), training))
        if kind == "dw_bn":
            ch, _, stride = cfg
            return _relu6(_bn_apply(p.bn, _conv(x, p.w, stride, groups=ch), training))
        if kind == "pw_bn_linear":
            return _bn_apply(p.bn, _conv(x, p.w, 1), training)  # linear bottleneck
        if kind == "bottleneck":
            sub, residual = cfg
            y = x
            for sp, (kd, c) in zip(p, sub):
                y = self._apply_entry(sp, kd, c, y, training)
            return x + y if residual else y
        # head: global average pool -> 1x1 conv -> logits
        x = x.mean(dim=(1, 2), keepdim=True)
        return (_conv(x, p.w, 1) + p.b)[:, 0, 0, :]

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        """x: (B, 32, 32, 3) float32 -> logits (B, num_classes). A training
        forward normalises by the batch and updates the running stats."""
        for p, (kind, cfg) in zip(self.params, self.spec):
            x = self._apply_entry(p, kind, cfg, x, training)
        return x


class MobileNetV1FP32(MobileNetV2FP32):
    """CIFAR-scaled float MobileNetV1: depthwise-separable stacks."""

    def _spec(self):
        c = self._c
        spec: List[Tuple[str, Any]] = [("conv_bn", (3, c(32), 3, 1))]
        in_c = c(32)
        for out_c, stride in V1_CIFAR_PLAN:
            out_c = c(out_c)
            spec.append(("dw_bn", (in_c, 3, stride)))
            spec.append(("conv_bn", (in_c, out_c, 1, 1)))
            in_c = out_c
        spec.append(("head", (in_c, self.num_classes)))
        return spec
