"""Caffe `.caffemodel` (binary NetParameter) import — the Caffe leg of the
reference converter (`tools/converter/source/caffe`, SURVEY.md section
2.9), completing the four-format import story (torch / ONNX / TFLite / TF
/ Caffe) through the shared whole-graph rewrite
(utils/graph_import.RegionWalker, transformer/Transformer.cpp:69).

Wire schema subset (field numbers from the reference's vendored
caffe.proto — the wire contract):

  NetParameter     { name=1, input=3, input_shape=8, layer=100 }
  LayerParameter   { name=1, type=2, bottom=3, top=4, blobs=7,
                     concat_param=104, convolution_param=106,
                     eltwise_param=110, inner_product_param=117,
                     pooling_param=121, batch_norm_param=139,
                     scale_param=142 }
  BlobProto        { shape=7 {dim=1 packed}, data=5 packed float,
                     legacy num/channels/height/width = 1..4 }
  ConvolutionParameter { num_output=1, bias_term=2, pad=3, kernel_size=4,
                     group=5, stride=6, pad_h=9, pad_w=10, kernel_h=11,
                     kernel_w=12, stride_h=13, stride_w=14 }
  PoolingParameter { pool=1 (MAX=0/AVE=1), kernel_size=2, stride=3,
                     pad=4, global_pooling=12 }
  InnerProductParameter { num_output=1, bias_term=2, axis=5 }
  BatchNormParameter { use_global_stats=1, eps=3 }
  ScaleParameter   { axis=1, bias_term=4 }
  EltwiseParameter { operation=1 (SUM=1) }
  ConcatParameter  { axis=2 }

Layer semantics: Convolution weights are OIHW, InnerProduct weights
(out, in) over NCHW-flattened features (the ONNX-style channel-major ->
channel-minor permutation applies); BatchNorm blobs are
[mean, variance, scale_factor] with the stored moments divided by
scale_factor, folded (with a following Scale's gamma) into the preceding
conv like the other importers. Caffe's in-place layers (top == bottom,
ubiquitous for ReLU/BN/Scale) are rewritten to unique tensor names before
region walking.

The port's own copy of ``mandheling_tpu/utils/caffe_model.py``: the same float
work in numpy float32, the weights quantized by the port's
`quantize_weights` (byte-identical to the JAX package's import); the model
comes back on the resolved device.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.blocks import GlobalAvgPool, NITIAvgPool, NITIDepthwiseConv2D
from ..nn.layers import Flatten, NITIConv2D, NITIMaxPool, NITIRelu, SqueezeLogits
from ..ops.qtensor import QTensor, quantize_weights
from .convert import chw_to_hwc_perm
from .graph_import import RegionWalker, finish_model
from .tf_graphdef import _emit_field, _emit_varint, _fields, _read_varint


def _quant(w: np.ndarray) -> QTensor:
    return quantize_weights(torch.tensor(np.asarray(w, np.float32)))


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ------------------------------------------------------------- wire: read


class Blob:
    __slots__ = ("shape", "data")

    def __init__(self, buf: bytes):
        self.shape: List[int] = []
        data = b""
        floats: List[float] = []
        legacy = [0, 0, 0, 0]
        for f, wt, v in _fields(buf):
            if f == 7:
                for f2, wt2, v2 in _fields(v):
                    if f2 == 1 and wt2 == 2:  # packed int64 dims
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            self.shape.append(_signed(d))
                    elif f2 == 1 and wt2 == 0:
                        self.shape.append(_signed(v))
            elif f == 5:
                if wt == 2:  # packed floats
                    data += v
                else:
                    floats.append(struct.unpack("<f", v)[0])
            elif f in (1, 2, 3, 4) and wt == 0:
                legacy[f - 1] = v
        if data:
            self.data = np.frombuffer(data, "<f4")
        else:
            self.data = np.asarray(floats, np.float32)
        if not self.shape and any(legacy):
            self.shape = [d for d in legacy]
        if self.shape:
            self.data = self.data.reshape(self.shape)


def _params_from(buf: bytes, spec: Dict[int, str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for f, wt, v in _fields(buf):
        name = spec.get(f)
        if name is None:
            continue
        if name.endswith("_f32"):
            out[name] = struct.unpack("<f", v)[0]
        elif wt == 0:
            out[name] = v  # repeated scalars: last value wins (square geom)
        elif wt == 2:  # packed repeated varints
            pos = 0
            while pos < len(v):
                iv, pos = _read_varint(v, pos)
                out[name] = iv
    return out


class CaffeLayer:
    __slots__ = ("name", "type", "bottom", "top", "blobs", "params")

    def __init__(self, buf: bytes):
        self.name = ""
        self.type = ""
        self.bottom: List[str] = []
        self.top: List[str] = []
        self.blobs: List[Blob] = []
        self.params: Dict[str, object] = {}
        for f, wt, v in _fields(buf):
            if f == 1:
                self.name = v.decode()
            elif f == 2:
                self.type = v.decode()
            elif f == 3:
                self.bottom.append(v.decode())
            elif f == 4:
                self.top.append(v.decode())
            elif f == 7:
                self.blobs.append(Blob(v))
            elif f == 106:  # ConvolutionParameter
                self.params = _params_from(v, {
                    1: "num_output", 2: "bias_term", 3: "pad",
                    4: "kernel", 5: "group", 6: "stride",
                    9: "pad_h", 10: "pad_w", 11: "kernel_h", 12: "kernel_w",
                    13: "stride_h", 14: "stride_w",
                })
            elif f == 121:  # PoolingParameter
                self.params = _params_from(v, {
                    1: "pool", 2: "kernel", 3: "stride", 4: "pad",
                    12: "global_pooling",
                })
            elif f == 117:  # InnerProductParameter
                self.params = _params_from(v, {
                    1: "num_output", 2: "bias_term", 5: "axis",
                })
            elif f == 139:  # BatchNormParameter
                self.params = _params_from(v, {1: "use_global_stats",
                                               3: "eps_f32"})
            elif f == 142:  # ScaleParameter
                self.params = _params_from(v, {1: "axis", 4: "bias_term"})
            elif f == 110:  # EltwiseParameter
                self.params = _params_from(v, {1: "operation"})
            elif f == 104:  # ConcatParameter
                self.params = _params_from(v, {2: "axis", 1: "concat_dim"})


class CaffeNet:
    def __init__(self, buf: bytes):
        self.name = ""
        self.inputs: List[str] = []
        self.input_shapes: List[List[int]] = []
        self.layers: List[CaffeLayer] = []
        for f, wt, v in _fields(buf):
            if f == 1:
                self.name = v.decode()
            elif f == 3:
                self.inputs.append(v.decode())
            elif f == 8:
                dims = []
                for f2, wt2, v2 in _fields(v):
                    if f2 == 1 and wt2 == 2:
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            dims.append(_signed(d))
                    elif f2 == 1:
                        dims.append(_signed(v2))
                self.input_shapes.append(dims)
            elif f == 100:
                self.layers.append(CaffeLayer(v))


def load_caffemodel(path_or_bytes) -> CaffeNet:
    buf = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
           else open(path_or_bytes, "rb").read())
    net = CaffeNet(bytes(buf))
    _deinplace(net)
    return net


def _deinplace(net: CaffeNet) -> None:
    """Rewrite in-place layers (top == bottom) to unique tensor names."""
    current: Dict[str, str] = {}
    for i, layer in enumerate(net.layers):
        layer.bottom = [current.get(b, b) for b in layer.bottom]
        new_tops = []
        for t in layer.top:
            if t in layer.bottom or t in current.values() or t in current:
                uniq = f"{t}__{i}"
                current[t] = uniq
                new_tops.append(uniq)
            else:
                current[t] = t
                new_tops.append(t)
        layer.top = new_tops


# ------------------------------------------------------------- wire: write


def _blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    dims = bytearray()
    for d in arr.shape:
        dims += _emit_varint(d)
    out = _emit_field(7, 2, _emit_field(1, 2, bytes(dims)))
    out += _emit_field(5, 2, np.ascontiguousarray(arr).tobytes())
    return out


def build_caffemodel(
    layers: List[Tuple[str, str, List[str], List[str], Dict,
                       List[np.ndarray]]],
    inputs: List[str],
    input_shapes: List[List[int]],
) -> bytes:
    """layers: (name, type, bottoms, tops, params, blobs). params keys are
    the subset of each layer's proto fields used by the importer."""
    out = bytearray()
    for name in inputs:
        out += _emit_field(3, 2, name.encode())
    for shape in input_shapes:
        dims = bytearray()
        for d in shape:
            dims += _emit_varint(d)
        out += _emit_field(8, 2, _emit_field(1, 2, bytes(dims)))
    param_fields = {
        "Convolution": (106, {"num_output": 1, "pad": 3, "kernel_size": 4,
                              "group": 5, "stride": 6}),
        "Pooling": (121, {"pool": 1, "kernel_size": 2, "stride": 3,
                          "pad": 4, "global_pooling": 12}),
        "InnerProduct": (117, {"num_output": 1}),
        "BatchNorm": (139, {"use_global_stats": 1}),
        "Scale": (142, {"axis": 1, "bias_term": 4}),
        "Eltwise": (110, {"operation": 1}),
        "Concat": (104, {"axis": 2}),
    }
    for name, ltype, bottoms, tops, params, blobs in layers:
        lb = bytearray()
        lb += _emit_field(1, 2, name.encode())
        lb += _emit_field(2, 2, ltype.encode())
        for b in bottoms:
            lb += _emit_field(3, 2, b.encode())
        for t in tops:
            lb += _emit_field(4, 2, t.encode())
        for arr in blobs:
            lb += _emit_field(7, 2, _blob(arr))
        if ltype in param_fields and params:
            pf, fmap = param_fields[ltype]
            pb = bytearray()
            for k, v in params.items():
                pb += _emit_field(fmap[k], 0, _emit_varint(int(v)))
            lb += _emit_field(pf, 2, bytes(pb))
        out += _emit_field(100, 2, bytes(lb))
    return bytes(out)


# --------------------------------------------------------------- importer


class _CShape:
    __slots__ = ("c", "h", "w", "flattened", "pending_perm")

    def __init__(self, c, h, w, flattened=False, pending_perm=None):
        self.c, self.h, self.w = c, h, w
        self.flattened = flattened
        self.pending_perm = pending_perm

    def copy(self) -> "_CShape":
        return _CShape(self.c, self.h, self.w, self.flattened,
                       self.pending_perm)


class _CaffeGraphOps:
    def __init__(self, net: CaffeNet):
        self.net = net
        self._cons: Dict[str, List[CaffeLayer]] = {}
        for layer in net.layers:
            for b in self.act_inputs(layer):
                self._cons.setdefault(b, []).append(layer)

    def consumers(self, t):
        return self._cons.get(t, [])

    def outputs(self, layer):
        return list(layer.top)

    def act_inputs(self, layer):
        return list(layer.bottom)

    def join_kind(self, layer):
        if layer.type == "Eltwise":
            if int(layer.params.get("operation", 1)) != 1:
                raise ValueError("only Eltwise SUM joins supported")
            return "add"
        if layer.type == "Concat":
            axis = int(layer.params.get("axis",
                                        layer.params.get("concat_dim", 1)))
            if axis != 1:
                raise ValueError("Concat join supported on channel axis only")
            return "concat"
        return None

    def _fold_bn_scale(self, out: str, w_hwio: np.ndarray):
        cons = self._cons.get(out, [])
        while len(cons) == 1 and cons[0].type in ("BatchNorm", "Scale"):
            nxt = cons[0]
            if nxt.type == "BatchNorm":
                mean, var = nxt.blobs[0].data, nxt.blobs[1].data
                sf = float(nxt.blobs[2].data.ravel()[0]) if len(
                    nxt.blobs) > 2 else 1.0
                sf = sf if sf != 0 else 1.0
                eps = float(nxt.params.get("eps_f32", 1e-5) or 1e-5)
                factor = 1.0 / np.sqrt(var / sf + eps)
            else:
                factor = nxt.blobs[0].data
                if nxt.params.get("bias_term") and len(nxt.blobs) > 1:
                    if np.any(nxt.blobs[1].data != 0):
                        raise ValueError(
                            "Scale bias unsupported — NITI layers carry "
                            "no bias")
            w_hwio = w_hwio * np.asarray(factor, np.float32)[
                None, None, None, :]
            out = nxt.top[0]
            cons = self._cons.get(out, [])
        return out, w_hwio

    def convert_node(self, layer: CaffeLayer, st: _CShape,
                     layers: List, params: List) -> str:
        t = layer.type
        out = layer.top[0]
        p = layer.params
        if t == "Convolution":
            w = layer.blobs[0].data  # OIHW (out, in/group, kh, kw)
            if len(layer.blobs) > 1 and np.any(layer.blobs[1].data != 0):
                raise ValueError("non-zero conv bias — NITI layers carry "
                                 "no bias")
            group = int(p.get("group", 1) or 1)
            kh, kw = w.shape[2], w.shape[3]
            s = int(p.get("stride", 1) or 1)
            stride = (int(p.get("stride_h", s) or s),
                      int(p.get("stride_w", s) or s))
            pad = int(p.get("pad", 0) or 0)
            pads = ((int(p.get("pad_h", pad) or pad),) * 2,
                    (int(p.get("pad_w", pad) or pad),) * 2)
            w_hwio = w.transpose(2, 3, 1, 0)
            out, w_hwio = self._fold_bn_scale(out, w_hwio)
            if group == 1:
                layers.append(NITIConv2D(w_hwio.shape[2], w_hwio.shape[3],
                                         (kh, kw), stride, pads))
                params.append({"w": _quant(w_hwio)})
                st.c = w_hwio.shape[3]
            elif group == st.c and w.shape[1] == 1:
                layers.append(NITIDepthwiseConv2D(st.c, (kh, kw), stride,
                                                  pads))
                params.append({"w": _quant(w_hwio)})
            else:
                raise ValueError(f"grouped conv (group={group}) unsupported")
            st.h = (st.h + 2 * pads[0][0] - kh) // stride[0] + 1
            st.w = (st.w + 2 * pads[1][0] - kw) // stride[1] + 1
            return out
        if t == "ReLU":
            layers.append(NITIRelu())
            params.append(())
        elif t == "Pooling":
            if p.get("global_pooling"):
                if int(p.get("pool", 0) or 0) != 1:
                    raise ValueError("global max pooling unsupported")
                layers.append(GlobalAvgPool())
                params.append(())
                st.h = st.w = 1
            else:
                k = int(p.get("kernel", 2) or 2)
                s = int(p.get("stride", 1) or 1)
                pad = int(p.get("pad", 0) or 0)
                if int(p.get("pool", 0) or 0) == 0:
                    if pad:
                        raise ValueError("padded max pool unsupported")
                    layers.append(NITIMaxPool((k, k), (s, s)))
                else:
                    layers.append(NITIAvgPool((k, k), (s, s), pad=pad))
                params.append(())
                # caffe pool output: ceil((in + 2p - k)/s) + 1
                st.h = -(-(st.h + 2 * pad - k) // s) + 1
                st.w = -(-(st.w + 2 * pad - k) // s) + 1
        elif t == "InnerProduct":
            w = layer.blobs[0].data  # (out, in)
            if len(layer.blobs) > 1 and np.any(layer.blobs[1].data != 0):
                raise ValueError("non-zero InnerProduct bias — NITI layers "
                                 "carry no bias")
            w_in = w.T  # (in, out); caffe flattens NCHW (channel-major)
            if st.h * st.w > 1:
                w_in = w_in[chw_to_hwc_perm(st.c, st.h, st.w)]
            if not st.flattened:
                layers.append(Flatten())
                params.append(())
                st.flattened = True
            layers.append(NITIConv2D(w_in.shape[0], w_in.shape[1], (1, 1)))
            params.append({"w": _quant(w_in.reshape(1, 1, *w_in.shape))})
            st.c, st.h, st.w = w_in.shape[1], 1, 1
        elif t in ("Softmax", "Dropout", "Input"):
            pass
        elif t in ("BatchNorm", "Scale"):
            raise ValueError(f"{t} without a preceding Convolution "
                             "unsupported")
        else:
            raise ValueError(f"unsupported Caffe layer type {t!r}")
        return out


def niti_model_from_caffemodel(path_or_bytes, input_shape=None,
                                 output: Optional[str] = None, device=None):
    """Binary caffemodel -> (NITI model tree, quantized params): the
    model on `device`, the params its weight buffers in the JAX layout.

    `input_shape` (N, C, H, W) — taken from the net's input_shape when
    declared; `output` names the logits top (defaults to the unique
    unconsumed top)."""
    net = (load_caffemodel(path_or_bytes)
           if not isinstance(path_or_bytes, CaffeNet) else path_or_bytes)
    ops = _CaffeGraphOps(net)

    if net.inputs:
        inp = net.inputs[0]
    else:
        inputs = [l.top[0] for l in net.layers if l.type == "Input"]
        if not inputs:
            raise ValueError("no net input declared")
        inp = inputs[0]
    if input_shape is None:
        if not net.input_shapes:
            raise ValueError("input_shape (N, C, H, W) is required")
        input_shape = net.input_shapes[0]
    _, c, h, w = input_shape

    if output is None:
        consumed = {b for l in net.layers for b in l.bottom}
        sinks = [l.top[0] for l in net.layers
                 if l.top and l.top[0] not in consumed and l.type != "Input"]
        if len(sinks) != 1:
            raise ValueError(f"ambiguous net outputs {sinks}; pass output=")
        output = sinks[0]

    layers: List = []
    params: List = []
    st = _CShape(c, h, w)
    walker = RegionWalker(ops)
    walker.build_segment(inp, output, st, layers, params)
    layers.append(SqueezeLogits())
    params.append(())
    return finish_model(layers, params, device)
