"""TFLite model import/export — the TFLite leg of the reference's
converter (`tools/converter/source/tflite`, SURVEY.md section 2.9).

Import: `niti_model_from_tflite` builds a runnable, trainable NITI
`Sequential` straight from a `.tflite` graph (the TFLite analog of
`niti_model_from_onnx` / the reference's `turnModelToTrainable`).
Float32 and quantized (int8/uint8 per-tensor or per-axis) weight tensors
are both accepted — quantized weights are dequantized, then NITI
power-of-two requantized. `modules_from_tflite` yields the same
(kind, arrays) stream as `convert.modules_from_state_dict` for the
architecture-matched fp32 adapters.

Export: `tflite_from_sequential` serializes a trained NITI model as a
float32 `.tflite` graph (weights dequantized by their power-of-two
exponents) for deployment to TFLite-consuming runtimes — the reverse
direction the reference covers by converting into its own `.mnn` format.

Layout notes (TFLite -> here): CONV_2D filters are OHWI -> transpose
(1,2,3,0) to HWIO; DEPTHWISE_CONV_2D filters are (1,kh,kw,C) -> reshape
to our (kh,kw,1,C); FULLY_CONNECTED filters are (out,in) row-major over
an NHWC-flattened feature vector, so no CHW permutation is needed
(unlike torch/ONNX imports, which flatten channel-major).

The port's own copy of ``mandheling_tpu/utils/tflite_model.py``: the float
work is the JAX package's, in numpy float32, and the weights are quantized
by the port's `quantize_weights`, so an import is byte-identical to the JAX
package's. The importer reads the file on the host and returns the model on
the resolved device (the card unless `device="cpu"`).
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
    ProjectedResidualBlock,
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
from ..nn.module import Sequential
from ..ops.qtensor import QTensor, quantize_weights
from . import tflite_io as T
from .graph_import import RegionWalker, finish_model, live_params


def _quant(w: np.ndarray) -> QTensor:
    return quantize_weights(torch.tensor(np.asarray(w, np.float32)))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _padding_str(code: int) -> str:
    return "SAME" if code == T.PAD_SAME else "VALID"


def _check_bias(model: T.TFLModel, op: T.TFLOp) -> None:
    """NITI convs/FCs carry no bias; an all-zero bias tensor is dropped."""
    if len(op.inputs) < 3 or op.inputs[2] < 0:
        return
    bias = model.tensors[op.inputs[2]].dequantized()
    if bias is not None and np.any(bias != 0):
        raise ValueError(
            f"{op.name} carries a non-zero bias — NITI layers have no bias "
            "term; re-export without bias or fold it away"
        )


def _weights(model: T.TFLModel, idx: int) -> np.ndarray:
    w = model.tensors[idx].dequantized()
    if w is None:
        raise ValueError("weight tensor has no constant buffer")
    return w


class _TShape:
    """NHWC shape cursor threaded along each chain (for join checks)."""

    __slots__ = ("c", "h", "w", "flattened")

    def __init__(self, c, h, w, flattened=False):
        self.c, self.h, self.w = c, h, w
        self.flattened = flattened

    def copy(self) -> "_TShape":
        return _TShape(self.c, self.h, self.w, self.flattened)


def _io_dim(size, k, s, pad_code):
    if pad_code == T.PAD_SAME:
        return -(-size // s)
    return (size - k) // s + 1


class _TFLGraphOps:
    """GraphOps adapter for utils/graph_import.RegionWalker over a TFLite
    graph (integer tensor ids; constants are tensors with buffer data)."""

    def __init__(self, m: T.TFLModel):
        self.m = m
        self._cons: Dict[int, List[T.TFLOp]] = {}
        for op in m.ops:
            for t in self.act_inputs(op):
                self._cons.setdefault(t, []).append(op)
        self._emitted_flatten = False

    def _is_const(self, idx: int) -> bool:
        return self.m.tensors[idx].data is not None

    def consumers(self, t):
        return self._cons.get(t, [])

    def outputs(self, op):
        return list(op.outputs)

    def act_inputs(self, op):
        return [t for t in op.inputs if t >= 0 and not self._is_const(t)]

    def join_kind(self, op):
        if op.opcode == T.ADD:
            if op.options.get("fused_activation", 0) != T.ACT_NONE:
                raise ValueError(
                    "fused activation on ADD joins unsupported — re-export "
                    "with a separate RELU"
                )
            return "add"
        if op.opcode == T.CONCATENATION:
            axis = op.options.get("axis", 3)
            if axis not in (3, -1):
                raise ValueError(
                    "CONCATENATION join supported on the channel axis only"
                )
            if op.options.get("fused_activation", 0) != T.ACT_NONE:
                raise ValueError("fused activation on CONCATENATION joins "
                                 "unsupported")
            return "concat"
        return None

    def convert_node(self, op, st: _TShape, layers: List, params: List):
        def emit(layer, p=()):
            layers.append(layer)
            params.append(p)

        def fused_act(code: int, op_name: str):
            if code == T.ACT_NONE:
                return
            if code == T.ACT_RELU:
                emit(NITIRelu())
                return
            if code == T.ACT_RELU6:
                # exact exponent-aware analog since r4 (ops/relu.relu6);
                # earlier rounds approximated RELU6 with plain NITI relu
                emit(NITIRelu6())
                return
            raise ValueError(f"unsupported fused activation {code} on {op_name}")

        m = self.m
        o = op.options
        if op.opcode == T.CONV_2D:
            if o.get("dilation", (1, 1)) != (1, 1):
                raise ValueError("dilated conv unsupported for NITI import")
            _check_bias(m, op)
            w = _weights(m, op.inputs[1]).transpose(1, 2, 3, 0)  # OHWI->HWIO
            emit(
                NITIConv2D(w.shape[2], w.shape[3], w.shape[:2],
                           o["stride"], _padding_str(o["padding"])),
                {"w": _quant(w)},
            )
            fused_act(o.get("fused_activation", 0), op.name)
            st.c = w.shape[3]
            st.h = _io_dim(st.h, w.shape[0], o["stride"][0], o["padding"])
            st.w = _io_dim(st.w, w.shape[1], o["stride"][1], o["padding"])
        elif op.opcode == T.DEPTHWISE_CONV_2D:
            if o.get("depth_multiplier", 1) != 1:
                raise ValueError("depth_multiplier != 1 unsupported")
            _check_bias(m, op)
            w4 = _weights(m, op.inputs[1])  # (1, kh, kw, C)
            kh, kw, c = w4.shape[1], w4.shape[2], w4.shape[3]
            emit(
                NITIDepthwiseConv2D(c, (kh, kw), o["stride"],
                                    _padding_str(o["padding"])),
                {"w": _quant(w4.reshape(kh, kw, 1, c))},
            )
            fused_act(o.get("fused_activation", 0), op.name)
            st.h = _io_dim(st.h, kh, o["stride"][0], o["padding"])
            st.w = _io_dim(st.w, kw, o["stride"][1], o["padding"])
        elif op.opcode == T.FULLY_CONNECTED:
            _check_bias(m, op)
            w = _weights(m, op.inputs[1])  # (out, in)
            w_in = w.T  # (in, out); TFLite flattens NHWC -> no permutation
            if not st.flattened:
                emit(Flatten())
                st.flattened = True
            emit(
                NITIConv2D(w_in.shape[0], w_in.shape[1], (1, 1)),
                {"w": _quant(w_in.reshape(1, 1, *w_in.shape))},
            )
            fused_act(o.get("fused_activation", 0), op.name)
            st.c, st.h, st.w = w_in.shape[1], 1, 1
        elif op.opcode == T.MAX_POOL_2D:
            emit(NITIMaxPool(o["window"], o["stride"]))
            st.h = _io_dim(st.h, o["window"][0], o["stride"][0], o["padding"])
            st.w = _io_dim(st.w, o["window"][1], o["stride"][1], o["padding"])
        elif op.opcode == T.AVERAGE_POOL_2D:
            emit(NITIAvgPool(o["window"], o["stride"]))
            st.h = _io_dim(st.h, o["window"][0], o["stride"][0], o["padding"])
            st.w = _io_dim(st.w, o["window"][1], o["stride"][1], o["padding"])
        elif op.opcode == T.MEAN:
            axes = m.tensors[op.inputs[1]].dequantized()
            if axes is None or sorted(int(a) for a in axes.ravel()) != [1, 2]:
                raise ValueError("MEAN supported only over spatial axes (1,2)")
            emit(GlobalAvgPool())
            st.h = st.w = 1
        elif op.opcode == T.RESHAPE:
            emit(Flatten())
            st.flattened = True
            st.c, st.h, st.w = st.c * st.h * st.w, 1, 1
        elif op.opcode == T.RELU:
            emit(NITIRelu())
        elif op.opcode in (T.SOFTMAX,):
            pass  # the NITI loss consumes logits
        elif op.opcode == T.RELU6:
            emit(NITIRelu6())
        else:
            raise ValueError(
                f"unsupported TFLite op {op.name} for NITI import")
        return op.outputs[0]


def niti_model_from_tflite(path_or_bytes, input_shape=None, device=None):
    """TFLite graph -> (NITI model tree, quantized params): the model holds
    the weights on `device`, and the params are its weight buffers in the
    JAX package's layout (graph_import.live_params).

    Arbitrary fan-out/fan-in topologies are supported through the shared
    region walker (utils/graph_import.RegionWalker): ADD joins become
    ResidualBlock / ParallelAdd, channel-axis CONCATENATION joins become
    ParallelConcat — the TFLite leg of the reference's whole-graph
    turnModelToTrainable (transformer/Transformer.cpp:69).

    `input_shape` (N, H, W, C) overrides the graph's declared input shape
    (TFLite is NHWC natively — no layout transposition happens on
    activations, only on weight tensors)."""
    m = T.load_tflite(path_or_bytes)

    if input_shape is None:
        input_shape = tuple(m.tensors[m.inputs[0]].shape)
    _, h, w, c = input_shape

    ops = _TFLGraphOps(m)
    walker = RegionWalker(ops)
    layers: List = []
    params: List = []
    st = _TShape(c, h, w)
    walker.build_segment(m.inputs[0], m.outputs[0], st, layers, params)
    layers.append(SqueezeLogits())
    params.append(())
    return finish_model(layers, params, device)


def modules_from_tflite(path_or_bytes) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """TFLite graph -> ordered (kind, arrays) module stream, the same
    format `convert.modules_from_state_dict` produces, for the
    architecture-matched fp32 adapters (conv weights HWIO; linear weights
    (out, in))."""
    m = T.load_tflite(path_or_bytes)
    out: List[Tuple[str, Dict[str, np.ndarray]]] = []
    for op in m.ops:
        if op.opcode == T.CONV_2D:
            entry = {"w": _weights(m, op.inputs[1]).transpose(1, 2, 3, 0)}
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                b = m.tensors[op.inputs[2]].dequantized()
                if b is not None:
                    entry["b"] = b
            out.append(("conv", entry))
        elif op.opcode == T.DEPTHWISE_CONV_2D:
            w4 = _weights(m, op.inputs[1])
            kh, kw, c = w4.shape[1], w4.shape[2], w4.shape[3]
            entry = {"w": w4.reshape(kh, kw, 1, c)}
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                b = m.tensors[op.inputs[2]].dequantized()
                if b is not None:
                    entry["b"] = b
            out.append(("conv", entry))
        elif op.opcode == T.FULLY_CONNECTED:
            entry = {"w": _weights(m, op.inputs[1])}
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                b = m.tensors[op.inputs[2]].dequantized()
                if b is not None:
                    entry["b"] = b
            out.append(("linear", entry))
    return out


# ---- export ---------------------------------------------------------------


def _same_pad(padding, kernel, stride, spatial) -> Optional[int]:
    """Map a layer's padding spec to a TFLite padding enum, or None when
    it is neither VALID nor SAME."""
    from ..ops.conv import resolve_padding

    if isinstance(padding, str):
        return T.PAD_VALID if padding.upper() == "VALID" else T.PAD_SAME
    resolved = resolve_padding(padding, kernel, stride, spatial)
    if resolved == ((0, 0), (0, 0)):
        return T.PAD_VALID
    if resolved == resolve_padding("SAME", kernel, stride, spatial):
        return T.PAD_SAME
    return None


def tflite_from_sequential(model: Sequential, params, input_shape) -> bytes:
    """Serialize a NITI Sequential as a float32 TFLite flatbuffer.

    `input_shape` = (N, H, W, C). `params` in the JAX package's layout
    ({"w": (data, exp)} entries: QTensors, tensors or arrays), or None for
    the model's own weights. Weights are dequantized (`data * 2^exp`).
    Unsupported layers raise with the layer type."""
    if params is None:
        params = live_params(model)
    w = T.TFLiteWriter()
    n, h, wd, c = map(int, input_shape)
    cur = w.tensor((n, h, wd, c), name="input")
    spatial = (h, wd)

    def act_out(shape, name):
        return w.tensor(shape, name=name)

    counter = [0]

    def emit_seq(layers_list, params_list, cur, spatial, c, prefix):
        for layer, p in zip(layers_list, params_list):
            cur, spatial, c = emit_layer(layer, p, cur, spatial, c, prefix)
        return cur, spatial, c

    def emit_layer(layer, p, cur, spatial, c, prefix):
        counter[0] += 1
        lname = f"{prefix}l{counter[0]}"
        if isinstance(layer, ResidualBlock):
            out, sp, cc = emit_seq(layer.branch.layers, p, cur, spatial, c,
                                   lname + "/b")
            if (sp, cc) != (spatial, c):
                raise ValueError("residual branch changed shape")
            j = act_out(_shape(n, sp, cc), f"{lname}/add")
            w.op(T.ADD, [out, cur], [j], T.OPT_ADD, {})
            return j, sp, cc
        if isinstance(layer, ParallelAdd):
            outs = []
            sp = cc = None
            for bi, (branch, bp) in enumerate(zip(layer.branches, p)):
                out, sp, cc = emit_seq(branch.layers, bp, cur, spatial, c,
                                       f"{lname}/b{bi}")
                outs.append(out)
            j = outs[0]
            for k, o in enumerate(outs[1:]):
                nj = act_out(_shape(n, sp, cc), f"{lname}/add{k}")
                w.op(T.ADD, [j, o], [nj], T.OPT_ADD, {})
                j = nj
            return j, sp, cc
        if isinstance(layer, ParallelConcat):
            outs, chans = [], []
            sp = None
            for bi, (branch, bp) in enumerate(zip(layer.branches, p)):
                out, sp, cc = emit_seq(branch.layers, bp, cur, spatial, c,
                                       f"{lname}/b{bi}")
                outs.append(out)
                chans.append(cc)
            total = sum(chans)
            j = act_out(_shape(n, sp, total), f"{lname}/cat")
            w.op(T.CONCATENATION, outs, [j], T.OPT_CONCAT, {"axis": 3})
            return j, sp, total
        if isinstance(layer, ProjectedResidualBlock):
            out, sp, cc = emit_seq(layer.branch.layers, p["branch"], cur,
                                   spatial, c, lname + "/b")
            skip, sp2, cc2 = emit_layer(layer.proj, p["proj"], cur, spatial,
                                        c, lname + "/p")
            if (sp, cc) != (sp2, cc2):
                raise ValueError("projected residual branches disagree")
            j = act_out(_shape(n, sp, cc), f"{lname}/add")
            w.op(T.ADD, [out, skip], [j], T.OPT_ADD, {})
            return j, sp, cc
        if isinstance(layer, NITIConv2D) and layer.kernel == (1, 1) and spatial == (1, 1):
            # 1x1 conv on flattened features == FULLY_CONNECTED
            qd, qe = (_host(a) for a in p["w"])
            wf = (np.asarray(qd, np.float32)
                  * float(2.0) ** int(qe)).reshape(qd.shape[2], qd.shape[3])
            wt = w.const(wf.T.astype(np.float32), name=f"{lname}/w")
            cur_flat = cur
            out = act_out((n, wf.shape[1]), f"{lname}/out")
            w.op(T.FULLY_CONNECTED, [cur_flat, wt, -1], [out],
                 T.OPT_FULLY_CONNECTED, {})
            cur = out
            c = wf.shape[1]
        elif isinstance(layer, NITIDepthwiseConv2D):
            qd, qe = (_host(a) for a in p["w"])
            kh, kw = layer.kernel
            pad = _same_pad(layer.padding, layer.kernel, layer.stride, spatial)
            if pad is None:
                raise ValueError("explicit asymmetric padding needs a PAD op "
                                 "— unsupported in this exporter")
            # scalar or per-channel exponent (r4 dw extension): broadcast
            # along the channel axis either way
            wf = (np.asarray(qd, np.float32)
                  * 2.0 ** np.asarray(qe, np.float32))
            wt = w.const(wf.reshape(1, kh, kw, c), name=f"{lname}/w")
            sh, sw = layer.stride
            oh = _out_dim(spatial[0], kh, sh, pad)
            ow = _out_dim(spatial[1], kw, sw, pad)
            out = act_out((n, oh, ow, c), f"{lname}/out")
            w.op(T.DEPTHWISE_CONV_2D, [cur, wt, -1], [out], T.OPT_DEPTHWISE,
                 {"padding": pad, "stride": (sh, sw), "depth_multiplier": 1})
            cur, spatial = out, (oh, ow)
            if getattr(layer, "act", None) == "relu6":
                out = act_out((n, oh, ow, c), f"{lname}/act")
                w.op(T.RELU6, [cur], [out])
                cur = out
        elif isinstance(layer, NITIConv2D):
            qd, qe = (_host(a) for a in p["w"])
            kh, kw = layer.kernel
            pad = _same_pad(layer.padding, layer.kernel, layer.stride, spatial)
            if pad is None:
                raise ValueError("explicit asymmetric padding needs a PAD op "
                                 "— unsupported in this exporter")
            wf = np.asarray(qd, np.float32) * 2.0 ** int(qe)  # HWIO
            wt = w.const(wf.transpose(3, 0, 1, 2), name=f"{lname}/w")  # OHWI
            sh, sw = layer.stride
            oh = _out_dim(spatial[0], kh, sh, pad)
            ow = _out_dim(spatial[1], kw, sw, pad)
            oc = wf.shape[3]
            out = act_out((n, oh, ow, oc), f"{lname}/out")
            w.op(T.CONV_2D, [cur, wt, -1], [out], T.OPT_CONV2D,
                 {"padding": pad, "stride": (sh, sw)})
            cur, spatial, c = out, (oh, ow), oc
            if getattr(layer, "act", None) == "relu6":
                out = act_out((n, oh, ow, oc), f"{lname}/act")
                w.op(T.RELU6, [cur], [out])
                cur = out
        elif isinstance(layer, NITIRelu):
            out = act_out(_shape(n, spatial, c), f"{lname}/out")
            w.op(T.RELU, [cur], [out])
            cur = out
        elif isinstance(layer, NITIRelu6):
            out = act_out(_shape(n, spatial, c), f"{lname}/out")
            w.op(T.RELU6, [cur], [out])
            cur = out
        elif isinstance(layer, NITIMaxPool):
            wh, ww = layer.window
            sh, sw = layer.stride
            oh, ow = (spatial[0] - wh) // sh + 1, (spatial[1] - ww) // sw + 1
            out = act_out((n, oh, ow, c), f"{lname}/out")
            w.op(T.MAX_POOL_2D, [cur], [out], T.OPT_POOL2D,
                 {"padding": T.PAD_VALID, "stride": (sh, sw),
                  "window": (wh, ww)})
            cur, spatial = out, (oh, ow)
        elif isinstance(layer, NITIAvgPool):
            if getattr(layer, "pad", 0):
                raise ValueError(
                    "TFLite export of NITIAvgPool with pad > 0 is not "
                    "supported (would silently drop the padding); use "
                    "pad=0 or an explicit PAD layer"
                )
            wh, ww = layer.window
            sh, sw = layer.stride if layer.stride else layer.window
            oh, ow = (spatial[0] - wh) // sh + 1, (spatial[1] - ww) // sw + 1
            out = act_out((n, oh, ow, c), f"{lname}/out")
            w.op(T.AVERAGE_POOL_2D, [cur], [out], T.OPT_POOL2D,
                 {"padding": T.PAD_VALID, "stride": (sh, sw),
                  "window": (wh, ww)})
            cur, spatial = out, (oh, ow)
        elif isinstance(layer, GlobalAvgPool):
            axes = w.const(np.asarray([1, 2], np.int32), name=f"{lname}/axes")
            out = act_out((n, 1, 1, c), f"{lname}/out")
            w.op(T.MEAN, [cur, axes], [out], T.OPT_REDUCER,
                 {"keep_dims": True})
            cur, spatial = out, (1, 1)
        elif isinstance(layer, Flatten):
            feat = spatial[0] * spatial[1] * c
            shape_t = w.const(np.asarray([n, feat], np.int32),
                              name=f"{lname}/shape")
            out = act_out((n, feat), f"{lname}/out")
            w.op(T.RESHAPE, [cur, shape_t], [out], T.OPT_RESHAPE,
                 {"new_shape": [n, feat]})
            cur, spatial, c = out, (1, 1), feat
        elif isinstance(layer, SqueezeLogits):
            pass  # logits already (N, C) after the FC path
        else:
            raise ValueError(
                f"layer {type(layer).__name__} unsupported by TFLite export"
            )
        return cur, spatial, c

    cur, spatial, c = emit_seq(model.layers, params, cur, spatial, c, "")
    return w.finish([0], [cur])


def _out_dim(size: int, k: int, s: int, pad_code: int) -> int:
    if pad_code == T.PAD_SAME:
        return -(-size // s)
    return (size - k) // s + 1


def _shape(n, spatial, c):
    if spatial == (1, 1):
        return (n, c)
    return (n, spatial[0], spatial[1], c)
