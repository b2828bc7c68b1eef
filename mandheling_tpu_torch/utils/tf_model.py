"""Build a trainable NITI model from a TensorFlow frozen graph (GraphDef)
— the TF leg of the reference converter
(`tools/converter/source/tensorflow`, SURVEY.md section 2.9), through the
same whole-graph turnModelToTrainable rewrite as the ONNX/TFLite legs
(`transformer/Transformer.cpp:69`, utils/graph_import.RegionWalker).

Node coverage: Conv2D / DepthwiseConv2dNative / Relu / Relu6 / MaxPool /
AvgPool / Mean(spatial) / MatMul / Reshape / Softmax / Identity / BiasAdd
(zero only) / FusedBatchNorm[V2,V3] (folded into the preceding conv) /
Add|AddV2 and channel-axis ConcatV2 joins (ResidualBlock / ParallelAdd /
ParallelConcat). TF is NHWC native and its conv weights are HWIO — no
layout transposition on activations, none on dense conv weights;
DepthwiseConv2dNative's (kh, kw, C, multiplier=1) reshapes to our
(kh, kw, 1, C).

The port's own copy of ``mandheling_tpu/utils/tf_model.py``: the same float
work in numpy float32, the weights quantized by the port's
`quantize_weights` (byte-identical to the JAX package's import); the model
comes back on the resolved device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.blocks import GlobalAvgPool, NITIAvgPool, NITIDepthwiseConv2D
from ..nn.layers import (
    Flatten,
    NITIConv2D,
    NITIMaxPool,
    NITIRelu,
    NITIRelu6,
    SqueezeLogits,
)
from ..ops.qtensor import QTensor, quantize_weights
from .graph_import import RegionWalker, finish_model
from .tf_graphdef import GraphDef, TFNode, TFTensor, load_graphdef


def _quant(w: np.ndarray) -> QTensor:
    return quantize_weights(torch.tensor(np.asarray(w, np.float32)))


def _base(name: str) -> str:
    return name.split(":")[0]


class _TFShape:
    __slots__ = ("c", "h", "w", "flattened")

    def __init__(self, c, h, w, flattened=False):
        self.c, self.h, self.w = c, h, w
        self.flattened = flattened

    def copy(self) -> "_TFShape":
        return _TFShape(self.c, self.h, self.w, self.flattened)


class _TFGraphOps:
    def __init__(self, g: GraphDef):
        self.g = g
        self.by_name: Dict[str, TFNode] = {n.name: n for n in g.node}
        self.consts: Dict[str, np.ndarray] = {}
        for n in g.node:
            if n.op == "Const":
                t = n.attr.get("value")
                if isinstance(t, TFTensor):
                    self.consts[n.name] = t.data
        self._cons: Dict[str, List[TFNode]] = {}
        for n in g.node:
            for t in self.act_inputs(n):
                self._cons.setdefault(t, []).append(n)

    def _is_const(self, name: str) -> bool:
        return _base(name) in self.consts

    def const(self, name: str) -> np.ndarray:
        arr = self.consts.get(_base(name))
        if arr is None:
            raise ValueError(f"expected constant input {name!r}")
        return arr

    def consumers(self, t):
        return self._cons.get(t, [])

    def outputs(self, node):
        return [node.name]

    def act_inputs(self, node):
        ins = [i for i in node.input if not i.startswith("^")]
        if node.op in ("Conv2D", "DepthwiseConv2dNative", "MatMul",
                       "BiasAdd"):
            ins = ins[:1]
        elif node.op in ("FusedBatchNorm", "FusedBatchNormV2",
                         "FusedBatchNormV3"):
            ins = ins[:1]
        elif node.op in ("Mean", "Reshape"):
            ins = ins[:1]
        elif node.op == "ConcatV2":
            ins = ins[:-1]  # last input is the axis const
        return [_base(i) for i in ins if not self._is_const(i)]

    def join_kind(self, node):
        if node.op in ("Add", "AddV2"):
            return "add"
        if node.op == "ConcatV2":
            axis = int(self.const(node.input[-1]).ravel()[0])
            if axis not in (3, -1):
                raise ValueError("ConcatV2 join supported on channel axis only")
            return "concat"
        return None

    # ------------------------------------------------------- linear nodes

    def convert_node(self, node: TFNode, st: _TFShape,
                     layers: List, params: List) -> str:
        op = node.op
        out = node.name

        def out_dims(k, s, padding):
            if padding == "SAME":
                st.h = -(-st.h // s[0])
                st.w = -(-st.w // s[1])
            else:
                st.h = (st.h - k[0]) // s[0] + 1
                st.w = (st.w - k[1]) // s[1] + 1

        def skip_bias_and_bn(out_name: str, w_hwio: np.ndarray):
            """Fold a following zero BiasAdd and/or FusedBatchNorm."""
            cons = self._cons.get(out_name, [])
            while len(cons) == 1 and cons[0].op in (
                    "BiasAdd", "FusedBatchNorm", "FusedBatchNormV2",
                    "FusedBatchNormV3"):
                nxt = cons[0]
                if nxt.op == "BiasAdd":
                    bias = self.const(nxt.input[1])
                    if np.any(bias != 0):
                        raise ValueError(
                            "non-zero BiasAdd — NITI layers carry no bias")
                else:
                    scale = self.const(nxt.input[1])
                    var = self.const(nxt.input[4])
                    eps = float(nxt.attr.get("epsilon") or 1e-3)
                    w_hwio = w_hwio * (
                        scale / np.sqrt(var + eps))[None, None, None, :]
                out_name = nxt.name
                cons = self._cons.get(out_name, [])
            return out_name, w_hwio

        if op == "Conv2D":
            w = self.const(node.input[1])  # HWIO already
            strides = node.attr.get("strides") or [1, 1, 1, 1]
            padding = node.attr.get("padding")
            padding = (padding.decode() if isinstance(padding, bytes)
                       else str(padding))
            s = (int(strides[1]), int(strides[2]))
            out, w = skip_bias_and_bn(out, w)
            kh, kw, ic, oc = w.shape
            layers.append(NITIConv2D(ic, oc, (kh, kw), s, padding))
            params.append({"w": _quant(w)})
            st.c = oc
            out_dims((kh, kw), s, padding)
            return out
        if op == "DepthwiseConv2dNative":
            w = self.const(node.input[1])  # (kh, kw, C, mult)
            if w.shape[3] != 1:
                raise ValueError("depth multiplier != 1 unsupported")
            strides = node.attr.get("strides") or [1, 1, 1, 1]
            padding = node.attr.get("padding")
            padding = (padding.decode() if isinstance(padding, bytes)
                       else str(padding))
            s = (int(strides[1]), int(strides[2]))
            kh, kw, c, _ = w.shape
            wf = w.reshape(kh, kw, 1, c)
            out, wf = skip_bias_and_bn(out, wf.reshape(kh, kw, 1, c))
            layers.append(NITIDepthwiseConv2D(c, (kh, kw), s, padding))
            params.append({"w": _quant(wf)})
            out_dims((kh, kw), s, padding)
            return out
        if op in ("Relu", "Relu6"):
            layers.append(NITIRelu6() if op == "Relu6" else NITIRelu())
            params.append(())
        elif op in ("MaxPool", "AvgPool"):
            ks = node.attr.get("ksize") or [1, 2, 2, 1]
            strides = node.attr.get("strides") or ks
            padding = node.attr.get("padding")
            padding = (padding.decode() if isinstance(padding, bytes)
                       else str(padding))
            k = (int(ks[1]), int(ks[2]))
            s = (int(strides[1]), int(strides[2]))
            if padding != "VALID":
                raise ValueError(f"{op} SAME padding unsupported")
            if op == "MaxPool":
                layers.append(NITIMaxPool(k, s))
            else:
                layers.append(NITIAvgPool(k, s))
            params.append(())
            out_dims(k, s, "VALID")
        elif op == "Mean":
            axes = self.const(node.input[1]).ravel().tolist()
            if sorted(int(a) for a in axes) != [1, 2]:
                raise ValueError("Mean supported only over spatial axes (1,2)")
            layers.append(GlobalAvgPool())
            params.append(())
            st.h = st.w = 1
        elif op == "Reshape":
            layers.append(Flatten())
            params.append(())
            st.flattened = True
            st.c, st.h, st.w = st.c * st.h * st.w, 1, 1
        elif op == "MatMul":
            w = self.const(node.input[1])  # (in, out) unless transpose_b
            if node.attr.get("transpose_b"):
                w = w.T
            if not st.flattened:
                layers.append(Flatten())
                params.append(())
                st.flattened = True
            # TF flattens NHWC natively — no CHW permutation needed
            layers.append(NITIConv2D(w.shape[0], w.shape[1], (1, 1)))
            params.append({"w": _quant(w.reshape(1, 1, *w.shape))})
            st.c, st.h, st.w = w.shape[1], 1, 1
        elif op in ("Softmax", "Identity", "Placeholder"):
            pass
        else:
            raise ValueError(f"unsupported TF op {op!r} for NITI import")
        return out


def niti_model_from_graphdef(path_or_bytes, input_shape=None,
                             output: Optional[str] = None, device=None):
    """Frozen GraphDef -> (NITI model tree, quantized params): the
    model on `device`, the params its weight buffers in the JAX layout.

    `input_shape` (N, H, W, C); `output` names the logits node (defaults
    to the unique node no other node consumes)."""
    g = (load_graphdef(path_or_bytes)
         if not isinstance(path_or_bytes, GraphDef) else path_or_bytes)
    ops = _TFGraphOps(g)

    placeholders = [n for n in g.node if n.op == "Placeholder"]
    if not placeholders:
        raise ValueError("no Placeholder input in graph")
    inp = placeholders[0].name

    if output is None:
        consumed = {_base(i) for n in g.node for i in n.input
                    if not i.startswith("^")}
        sinks = [n.name for n in g.node
                 if n.name not in consumed and n.op != "Const"]
        if len(sinks) != 1:
            raise ValueError(f"ambiguous graph outputs {sinks}; pass output=")
        output = sinks[0]

    if input_shape is None:
        raise ValueError("input_shape (N, H, W, C) is required")
    _, h, w, c = input_shape

    layers: List = []
    params: List = []
    st = _TFShape(c, h, w)
    walker = RegionWalker(ops)
    walker.build_segment(inp, output, st, layers, params)
    layers.append(SqueezeLogits())
    params.append(())
    return finish_model(layers, params, device)
