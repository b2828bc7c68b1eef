"""Build a trainable NITI model directly from an ONNX graph — the general
`Transformer::turnModelToTrainable` (reference
`tools/train/source/transformer/Transformer.cpp:69`: load an inference
graph, rewrite its conv weights into trainable variables). Here the
rewrite target is a tree of NITI layers (`Sequential` at the top, with
`ResidualBlock`/`ParallelAdd`/`ParallelConcat` at fan-out points) with
NITI-quantized (int8 data, power-of-two exponent) weights, ready for the
integer train step — no architecture-matched adapter required.

Node coverage: Conv (dense or depthwise) / Relu / Clip(min=0) / MaxPool /
AveragePool / GlobalAveragePool / Flatten / Reshape / Gemm / MatMul /
Softmax (dropped — the NITI loss consumes logits) / Dropout / Identity.
BatchNormalization is folded into the preceding conv (inference-style
folding, then quantization).

Topology coverage: arbitrary fan-out/fan-in trees — a tensor consumed by
several chains that reconverge at one Add or Concat becomes a
`ResidualBlock` (identity skip), `ParallelAdd` (all-conv skips, e.g.
ResNet downsample), or `ParallelConcat` (SqueezeNet Fire / Inception
modules); branches nest recursively. This matches the reference
converter's full-graph handling (`tools/converter/`), which the round-2
linear-chain walker rejected.

Shape tracking is NCHW (the ONNX convention); a Gemm following a Flatten
gets the channel-major -> channel-minor feature permutation so imported
weights compute the same function in our NHWC layout
(utils/convert.chw_to_hwc_perm).

The port's own copy of ``mandheling_tpu/utils/onnx_model.py``: BN folding
and the feature permutation in numpy float32 as there, the weights quantized
by the port's `quantize_weights`, so an import is byte-identical to the JAX
package's; the model comes back on the resolved device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.blocks import (
    GlobalAvgPool,
    NITIAvgPool,
    NITIDepthwiseConv2D,
    ParallelAdd,
    ParallelConcat,
    ResidualBlock,
)
from ..nn.layers import (
    Flatten,
    NITIConv2D,
    NITIMaxPool,
    NITIRelu,
    NITIRelu6,
    SqueezeLogits,
)
from ..ops.qtensor import QTensor, quantize_weights
from .convert import chw_to_hwc_perm
from .graph_import import RegionWalker, finish_model
from .onnx_io import _attrs, load_onnx, tensor_to_np


def _quant(w: np.ndarray) -> QTensor:
    return quantize_weights(torch.tensor(np.asarray(w, np.float32)))


def _fold_bn(w_hwio: np.ndarray, bn: dict) -> np.ndarray:
    """Fold inference-mode batchnorm into the preceding conv's weights
    (bias-less: NITI convs carry no bias, so the BN shift is dropped with
    the same effect as the reference's train-mode BN removal — document)."""
    scale = bn["scale"] / np.sqrt(bn["var"] + 1e-5)
    return w_hwio * scale[None, None, None, :]


class _Shape:
    """NCHW shape/layout cursor threaded along each chain."""

    __slots__ = ("c", "h", "w", "flattened", "pending_perm")

    def __init__(self, c, h, w, flattened=False, pending_perm=None):
        self.c, self.h, self.w = c, h, w
        self.flattened = flattened
        self.pending_perm = pending_perm

    def copy(self) -> "_Shape":
        return _Shape(self.c, self.h, self.w, self.flattened,
                      self.pending_perm)


class _Importer:
    def __init__(self, graph):
        self.g = graph
        self.init = {t.name: t for t in graph.initializer}
        self.consumers: Dict[str, List] = {}
        for node in graph.node:
            for name in self._act_inputs(node):
                self.consumers.setdefault(name, []).append(node)

    def _act_inputs(self, node) -> List[str]:
        return [n for n in node.input if n and n not in self.init]

    def _clip_bounds(self, node) -> Tuple[Optional[float], Optional[float]]:
        """(min, max) of a Clip node. Opset <= 10 carries them as node
        attributes; opset 11+ (the torch export default) carries them as
        optional INPUTS backed by initializers (r4 advisor finding — a
        torch ReLU6 exported as Clip was previously unrecognized). Bounds
        that are neither attribute nor initializer stay None."""
        a = _attrs(node)
        lo, hi = a.get("min"), a.get("max")
        ins = list(node.input)
        if lo is None and len(ins) > 1 and ins[1] in self.init:
            lo = float(np.asarray(tensor_to_np(self.init[ins[1]])).reshape(()))
        if hi is None and len(ins) > 2 and ins[2] in self.init:
            hi = float(np.asarray(tensor_to_np(self.init[ins[2]])).reshape(()))
        return (None if lo is None else float(lo),
                None if hi is None else float(hi))

    # ------------------------------------------------------- linear nodes

    def _convert_node(self, node, st: _Shape, layers: List, params: List) -> str:
        """Convert one single-activation-input node; returns its output
        tensor name. Mutates st/layers/params."""
        op = node.op_type
        if op == "Conv":
            wt = tensor_to_np(self.init[node.input[1]])  # OIHW
            if len(node.input) > 2:
                raise ValueError(
                    "NITI convs carry no bias — re-export without bias "
                    f"(node {node.name!r})"
                )
            a = _attrs(node)
            stride = tuple(a.get("strides", [1, 1]))
            pt, pl_, pb, pr = (list(a.get("pads", [0, 0, 0, 0])) + [0] * 4)[:4]
            group = int(a.get("group", 1) or 1)
            w_hwio = wt.transpose(2, 3, 1, 0)
            out = node.output[0]
            # fold a directly-following BatchNormalization (only consumer)
            cons = self.consumers.get(out, [])
            if len(cons) == 1 and cons[0].op_type == "BatchNormalization":
                bnode = cons[0]
                bn = {
                    "scale": tensor_to_np(self.init[bnode.input[1]]),
                    "bias": tensor_to_np(self.init[bnode.input[2]]),
                    "mean": tensor_to_np(self.init[bnode.input[3]]),
                    "var": tensor_to_np(self.init[bnode.input[4]]),
                }
                w_hwio = _fold_bn(w_hwio, bn)
                out = bnode.output[0]
            kh, kw = w_hwio.shape[:2]
            pad = ((pt, pb), (pl_, pr))
            if group == 1:
                layers.append(NITIConv2D(w_hwio.shape[2], w_hwio.shape[3],
                                         (kh, kw), stride, pad))
                params.append({"w": _quant(w_hwio)})
                st.c = w_hwio.shape[3]
            elif group == st.c and wt.shape[1] == 1:
                layers.append(NITIDepthwiseConv2D(st.c, (kh, kw), stride, pad))
                params.append({"w": _quant(w_hwio)})
            else:
                raise ValueError(f"grouped conv (group={group}) unsupported")
            st.h = (st.h + pt + pb - kh) // stride[0] + 1
            st.w = (st.w + pl_ + pr - kw) // stride[1] + 1
            return out
        clip_lo, clip_hi = (self._clip_bounds(node) if op == "Clip"
                            else (None, None))
        if op == "Relu" or (op == "Clip" and clip_lo == 0.0):
            # Clip(0, 6) is torch/ONNX relu6 — the exact exponent-aware
            # NITI analog since r4 (ops/relu.relu6); other Clip(0, max)
            # bounds keep the plain-relu approximation. Bounds resolve
            # from attributes (opset <= 10) or initializer inputs (11+).
            if op == "Clip" and clip_hi == 6.0:
                layers.append(NITIRelu6())
            else:
                layers.append(NITIRelu())
            params.append(())
        elif op == "MaxPool":
            a = _attrs(node)
            k = tuple(a.get("kernel_shape", [2, 2]))
            s = tuple(a.get("strides", k))
            layers.append(NITIMaxPool(k, s))
            params.append(())
            st.h, st.w = (st.h - k[0]) // s[0] + 1, (st.w - k[1]) // s[1] + 1
        elif op == "AveragePool":
            a = _attrs(node)
            k = tuple(a.get("kernel_shape", [2, 2]))
            s = tuple(a.get("strides", k))
            pads = list(a.get("pads", [0, 0, 0, 0])) + [0] * 4
            pt, pl_, pb, pr = pads[:4]
            if len({pt, pl_, pb, pr}) == 1:
                layers.append(NITIAvgPool(k, s, pad=pt))
            elif (pt, pl_, pb, pr) == (0, 0, 0, 0):
                layers.append(NITIAvgPool(k, s))
            else:
                raise ValueError("asymmetric AveragePool padding unsupported")
            # the JAX importer appends no params entry here, which shifts
            # every later layer's params by one; the port appends it
            params.append(())
            st.h = (st.h + pt + pb - k[0]) // s[0] + 1
            st.w = (st.w + pl_ + pr - k[1]) // s[1] + 1
        elif op == "GlobalAveragePool":
            layers.append(GlobalAvgPool())
            params.append(())
            st.h = st.w = 1
        elif op in ("Flatten", "Reshape"):
            layers.append(Flatten())
            params.append(())
            st.pending_perm = (
                chw_to_hwc_perm(st.c, st.h, st.w) if (st.h * st.w) > 1 else None
            )
            st.flattened = True
            st.c, st.h, st.w = st.c * st.h * st.w, 1, 1
        elif op in ("Gemm", "MatMul"):
            a = _attrs(node)
            wt = tensor_to_np(self.init[node.input[1]])
            if op == "Gemm" and not int(a.get("transB", 0) or 0):
                wt = wt.T
            elif op == "MatMul":
                wt = wt.T  # (in, out) -> (out, in)
            if op == "Gemm" and len(node.input) > 2:
                raise ValueError(
                    "NITI FC layers carry no bias — re-export without bias"
                )
            w_in = wt.T  # (in, out)
            if st.pending_perm is not None:
                w_in = w_in[st.pending_perm]
                st.pending_perm = None
            if not st.flattened:
                layers.append(Flatten())
                params.append(())
                st.flattened = True
            layers.append(NITIConv2D(w_in.shape[0], w_in.shape[1], (1, 1)))
            params.append({"w": _quant(w_in.reshape(1, 1, *w_in.shape))})
            st.c, st.h, st.w = w_in.shape[1], 1, 1
        elif op in ("Softmax", "Dropout", "Identity", "BatchNormalization"):
            # standalone BN (not after a conv) has no NITI analog; the
            # reference's transformer likewise strips train-time-only ops
            if op == "BatchNormalization":
                raise ValueError(
                    "BatchNormalization without a preceding Conv unsupported"
                )
        else:
            raise ValueError(f"unsupported ONNX op {op!r} for NITI import")
        return node.output[0]

    # ---------------------------------------------------- GraphOps adapter
    # (the region walking itself lives in utils/graph_import.RegionWalker,
    # shared with the TFLite importer)

    def consumers_of(self, t: str):
        return self.consumers.get(t, [])

    def outputs(self, node):
        return list(node.output)

    def act_inputs(self, node):
        return self._act_inputs(node)

    def join_kind(self, node):
        if node.op_type == "Add":
            return "add"
        if node.op_type == "Concat":
            axis = int(_attrs(node).get("axis", 1) or 1)
            if axis != 1:
                raise ValueError("Concat join supported on channel axis only")
            return "concat"
        return None


class _OnnxGraphOps:
    def __init__(self, imp: _Importer):
        self._imp = imp

    def consumers(self, t):
        return self._imp.consumers_of(t)

    def outputs(self, node):
        return self._imp.outputs(node)

    def act_inputs(self, node):
        return self._imp.act_inputs(node)

    def convert_node(self, node, st, layers, params):
        return self._imp._convert_node(node, st, layers, params)

    def join_kind(self, node):
        return self._imp.join_kind(node)


def niti_model_from_onnx(path_or_model, input_shape=None, device=None):
    """ONNX graph -> (NITI model tree, quantized params): the model on
    `device`, the params its weight buffers in the JAX layout.

    `input_shape` (N, C, H, W) overrides the graph's declared input shape
    (needed when the graph uses dynamic batch)."""
    model = (
        load_onnx(path_or_model) if isinstance(path_or_model, str)
        else path_or_model
    )
    g = model.graph
    imp = _Importer(g)

    if input_shape is None:
        dims = g.input[0].type.tensor_type.shape.dim
        input_shape = tuple(d.dim_value for d in dims)
    _, c, h, w = input_shape

    layers: List = []
    params: List = []
    st = _Shape(c, h, w)
    walker = RegionWalker(_OnnxGraphOps(imp))
    walker.build_segment(g.input[0].name, g.output[0].name, st, layers, params)
    layers.append(SqueezeLogits())
    params.append(())
    return finish_model(layers, params, device)
