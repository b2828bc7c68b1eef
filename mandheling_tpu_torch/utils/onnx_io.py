"""ONNX model import/export.

The reference converter imports ONNX (among TF/TFLite/Caffe/Torch) into its
own format (`tools/converter/source/onnx/`, ~54k LoC total, SURVEY.md
section 2.9). Here ONNX joins the torch `state_dict` path: an ONNX graph is
grouped into the same ordered `(kind, arrays)` module list that
utils/convert.py's cursor consumes, so every existing adapter
(LeNet/MobileNetV1/V2 fp32 -> NITI quantize -> fine-tune) works unchanged on
ONNX input.

The `onnx` pip package is not available in this environment, so the wire
format is handled by a vendored protoc-compiled subset of the official
onnx.proto with the ORIGINAL field numbers (utils/onnx_proto/) — files
read/written here are wire-compatible with standard ONNX toolchains.

Import coverage: Conv / Gemm / MatMul(+Add) carry parameters;
BatchNormalization carries running stats; Relu / Clip / MaxPool /
AveragePool / GlobalAveragePool / Flatten / Reshape / Add / Softmax /
Identity / Dropout / Constant are recognized structural ops (no
parameters). Anything else with initializer inputs is an error (explicit
architecture mismatch, like the cursor).

The port's own copy of ``mandheling_tpu/utils/onnx_io.py`` and of its
vendored codec (``utils/onnx_proto/``): the files it writes are the JAX
package's byte for byte.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .onnx_proto import onnx_subset_pb2 as pb

# TensorProto.DataType values from the official schema
_FLOAT, _INT64, _INT32, _INT8 = 1, 7, 6, 3
_STRUCTURAL_OPS = {
    "Relu", "Clip", "MaxPool", "AveragePool", "GlobalAveragePool",
    "Flatten", "Reshape", "Add", "Softmax", "Identity", "Dropout",
    "Constant", "Concat", "Shape", "Gather", "Unsqueeze", "Cast", "Pad",
}


def tensor_to_np(t: pb.TensorProto) -> np.ndarray:
    dims = tuple(t.dims)
    if t.raw_data:
        dt = {_FLOAT: np.float32, _INT64: np.int64, _INT32: np.int32,
              _INT8: np.int8}[t.data_type]
        arr = np.frombuffer(t.raw_data, dtype=np.dtype(dt).newbyteorder("<"))
    elif t.data_type == _FLOAT:
        arr = np.asarray(t.float_data, np.float32)
    elif t.data_type == _INT64:
        arr = np.asarray(t.int64_data, np.int64)
    elif t.data_type == _INT32:
        arr = np.asarray(t.int32_data, np.int32)
    else:
        raise ValueError(f"unsupported tensor data_type {t.data_type}")
    return arr.reshape(dims)


def np_to_tensor(name: str, arr: np.ndarray) -> pb.TensorProto:
    t = pb.TensorProto()
    t.name = name
    t.dims.extend(arr.shape)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        t.data_type = _FLOAT
    elif arr.dtype == np.int64:
        t.data_type = _INT64
    elif arr.dtype == np.int32:
        t.data_type = _INT32
    elif arr.dtype == np.int8:
        t.data_type = _INT8
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    t.raw_data = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    return t


def load_onnx(path: str) -> pb.ModelProto:
    m = pb.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    return m


def save_onnx(model: pb.ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.SerializeToString())


def _attrs(node: pb.NodeProto) -> Dict[str, object]:
    out = {}
    for a in node.attribute:
        if a.ints:
            out[a.name] = list(a.ints)
        elif a.floats:
            out[a.name] = list(a.floats)
        elif a.s:
            out[a.name] = a.s.decode()
        elif a.HasField("t"):
            out[a.name] = tensor_to_np(a.t)
        else:
            # scalar int/float — proto3 can't distinguish unset; type tells
            out[a.name] = a.i if a.type in (2, 0) else a.f
    return out


def modules_from_onnx(model_or_path) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """ONNX graph -> ordered (kind, arrays) module list, torch-layout
    (conv HWIO after the same OIHW transpose; linear (out, in)) so the
    convert.py cursor/adapters apply unchanged. Conv/Gemm attributes are
    attached under "meta" (strides/pads/group) for checking."""
    model = (
        load_onnx(model_or_path) if isinstance(model_or_path, str)
        else model_or_path
    )
    g = model.graph
    init = {t.name: t for t in g.initializer}
    modules: List[Tuple[str, Dict[str, np.ndarray]]] = []
    pending_matmul: Dict[str, Dict[str, np.ndarray]] = {}
    for node in g.node:
        op = node.op_type
        if op == "Conv":
            w = tensor_to_np(init[node.input[1]])  # OIHW
            entry = {"w": w.transpose(2, 3, 1, 0)}
            if len(node.input) > 2 and node.input[2] in init:
                entry["b"] = tensor_to_np(init[node.input[2]])
            a = _attrs(node)
            entry["meta"] = {
                "stride": tuple(a.get("strides", [1, 1])),
                "pads": tuple(a.get("pads", [0, 0, 0, 0])),
                "group": int(a.get("group", 1) or 1),
            }
            modules.append(("conv", entry))
        elif op == "Gemm":
            a = _attrs(node)
            w = tensor_to_np(init[node.input[1]])
            if not int(a.get("transB", 0) or 0):
                w = w.T  # to (out, in)
            entry = {"w": w}
            if len(node.input) > 2 and node.input[2] in init:
                entry["b"] = tensor_to_np(init[node.input[2]])
            modules.append(("linear", entry))
        elif op == "MatMul" and node.input[1] in init:
            w = tensor_to_np(init[node.input[1]])  # (in, out)
            pending_matmul[node.output[0]] = {"w": w.T}
        elif op == "Add" and node.input[0] in pending_matmul and \
                node.input[1] in init:
            entry = pending_matmul.pop(node.input[0])
            entry["b"] = tensor_to_np(init[node.input[1]])
            modules.append(("linear", entry))
        elif op == "BatchNormalization":
            s, b, m_, v = (tensor_to_np(init[i]) for i in node.input[1:5])
            modules.append(
                ("bn", {"scale": s, "bias": b, "mean": m_, "var": v})
            )
        elif op in _STRUCTURAL_OPS:
            continue
        else:
            has_params = any(i in init for i in node.input[1:])
            if has_params:
                raise ValueError(
                    f"unsupported parameterized ONNX op {op!r} "
                    f"(node {node.name!r})"
                )
    # un-consumed MatMuls are bias-less linears
    for entry in pending_matmul.values():
        modules.append(("linear", entry))
    return modules


# ---- export -----------------------------------------------------------------


def build_onnx_sequential(
    ops: Sequence[Tuple[str, Dict]],
    input_shape: Sequence[int],
    path: str = None,
    producer: str = "mandheling_tpu",
) -> pb.ModelProto:
    """Build a linear-chain ONNX model from an op list.

    ops: sequence of (op_type, spec). Parameterized ops carry numpy arrays:
      ("Conv", {"w": OIHW array, "b": optional, "strides": (2,2), "pads": (t,l,b,r)})
      ("Gemm", {"w": (out, in), "b": optional})
      ("BatchNormalization", {"scale","bias","mean","var"})
    Structural ops: ("Relu", {}), ("MaxPool", {"kernel": (2,2), "strides": (2,2)}),
      ("Flatten", {}), ("GlobalAveragePool", {}), ("Clip", {"min":0,"max":6}).
    """
    m = pb.ModelProto()
    m.ir_version = 8
    m.producer_name = producer
    ops_import = m.opset_import.add()
    ops_import.domain = ""
    ops_import.version = 17
    g = m.graph
    g.name = "mandheling_export"

    def vi(name, shape=None):
        v = pb.ValueInfoProto()
        v.name = name
        v.type.tensor_type.elem_type = _FLOAT
        if shape is not None:
            for d in shape:
                v.type.tensor_type.shape.dim.add().dim_value = int(d)
        return v

    g.input.append(vi("input", input_shape))
    cur = "input"
    for idx, (op, spec) in enumerate(ops):
        node = g.node.add()
        node.op_type = op
        node.name = f"{op.lower()}_{idx}"
        out_name = f"act_{idx}"
        if op == "Conv":
            wname = f"{node.name}_w"
            g.initializer.append(np_to_tensor(wname, np.asarray(spec["w"], np.float32)))
            node.input.extend([cur, wname])
            if "b" in spec:
                bname = f"{node.name}_b"
                g.initializer.append(np_to_tensor(bname, np.asarray(spec["b"], np.float32)))
                node.input.append(bname)
            a = node.attribute.add(); a.name = "strides"; a.ints.extend(spec.get("strides", (1, 1)))
            a = node.attribute.add(); a.name = "pads"; a.ints.extend(spec.get("pads", (0, 0, 0, 0)))
            a = node.attribute.add(); a.name = "group"; a.i = int(spec.get("group", 1)); a.type = 2
            kh, kw = np.asarray(spec["w"]).shape[2:]
            a = node.attribute.add(); a.name = "kernel_shape"; a.ints.extend([kh, kw])
        elif op == "Gemm":
            wname = f"{node.name}_w"
            g.initializer.append(np_to_tensor(wname, np.asarray(spec["w"], np.float32)))
            node.input.extend([cur, wname])
            if "b" in spec:
                bname = f"{node.name}_b"
                g.initializer.append(np_to_tensor(bname, np.asarray(spec["b"], np.float32)))
                node.input.append(bname)
            a = node.attribute.add(); a.name = "transB"; a.i = 1; a.type = 2
        elif op == "BatchNormalization":
            names = []
            for key in ("scale", "bias", "mean", "var"):
                n = f"{node.name}_{key}"
                g.initializer.append(np_to_tensor(n, np.asarray(spec[key], np.float32)))
                names.append(n)
            node.input.extend([cur] + names)
        elif op == "MaxPool":
            node.input.append(cur)
            a = node.attribute.add(); a.name = "kernel_shape"; a.ints.extend(spec.get("kernel", (2, 2)))
            a = node.attribute.add(); a.name = "strides"; a.ints.extend(spec.get("strides", (2, 2)))
        elif op == "Clip":
            # opset 11+ (declared 17): min/max are INPUTS, not attributes
            node.input.append(cur)
            for key, default in (("min", 0.0), ("max", 6.0)):
                n = f"{node.name}_{key}"
                g.initializer.append(np_to_tensor(
                    n, np.asarray(float(spec.get(key, default)), np.float32)))
                node.input.append(n)
        else:
            node.input.append(cur)
        node.output.append(out_name)
        cur = out_name
    g.output.append(vi(cur))
    if path:
        save_onnx(m, path)
    return m


def build_onnx_graph(
    nodes: Sequence[Tuple[str, Sequence[str], Sequence[str], Dict]],
    input_shape: Sequence[int],
    output: str,
    path: str = None,
    input_name: str = "input",
    producer: str = "mandheling_tpu",
) -> pb.ModelProto:
    """Build an ONNX model with explicit tensor wiring (branching graphs).

    nodes: sequence of (op_type, activation_inputs, outputs, spec) where
    spec carries the same parameter arrays/attributes as
    build_onnx_sequential ("w"/"b" for Conv/Gemm, "scale"/"bias"/"mean"/
    "var" for BatchNormalization, "kernel"/"strides"/"pads"/"group"
    attributes, "axis" for Concat). Initializer inputs are appended after
    the activation inputs automatically.
    """
    m = pb.ModelProto()
    m.ir_version = 8
    m.producer_name = producer
    ops_import = m.opset_import.add()
    ops_import.domain = ""
    ops_import.version = 17
    g = m.graph
    g.name = "mandheling_graph"

    def vi(name, shape=None):
        v = pb.ValueInfoProto()
        v.name = name
        v.type.tensor_type.elem_type = _FLOAT
        if shape is not None:
            for d in shape:
                v.type.tensor_type.shape.dim.add().dim_value = int(d)
        return v

    g.input.append(vi(input_name, input_shape))
    for idx, (op, ins, outs, spec) in enumerate(nodes):
        node = g.node.add()
        node.op_type = op
        node.name = f"{op.lower()}_{idx}"
        node.input.extend(ins)
        if op in ("Conv", "Gemm", "MatMul"):
            wname = f"{node.name}_w"
            g.initializer.append(
                np_to_tensor(wname, np.asarray(spec["w"], np.float32)))
            node.input.append(wname)
            if "b" in spec:
                bname = f"{node.name}_b"
                g.initializer.append(
                    np_to_tensor(bname, np.asarray(spec["b"], np.float32)))
                node.input.append(bname)
            if op == "Conv":
                a = node.attribute.add(); a.name = "strides"; a.ints.extend(spec.get("strides", (1, 1)))
                a = node.attribute.add(); a.name = "pads"; a.ints.extend(spec.get("pads", (0, 0, 0, 0)))
                a = node.attribute.add(); a.name = "group"; a.i = int(spec.get("group", 1)); a.type = 2
                kh, kw = np.asarray(spec["w"]).shape[2:]
                a = node.attribute.add(); a.name = "kernel_shape"; a.ints.extend([kh, kw])
            elif op == "Gemm":
                a = node.attribute.add(); a.name = "transB"; a.i = 1; a.type = 2
        elif op == "BatchNormalization":
            for key in ("scale", "bias", "mean", "var"):
                n = f"{node.name}_{key}"
                g.initializer.append(
                    np_to_tensor(n, np.asarray(spec[key], np.float32)))
                node.input.append(n)
        elif op in ("MaxPool", "AveragePool"):
            a = node.attribute.add(); a.name = "kernel_shape"; a.ints.extend(spec.get("kernel", (2, 2)))
            a = node.attribute.add(); a.name = "strides"; a.ints.extend(spec.get("strides", spec.get("kernel", (2, 2))))
            if "pads" in spec:
                a = node.attribute.add(); a.name = "pads"; a.ints.extend(spec["pads"])
        elif op == "Concat":
            a = node.attribute.add(); a.name = "axis"; a.i = int(spec.get("axis", 1)); a.type = 2
        elif op == "Clip":
            # opset 11+ (declared 17): min/max are INPUTS, not attributes
            for key, default in (("min", 0.0), ("max", 6.0)):
                n = f"{node.name}_{key}"
                g.initializer.append(np_to_tensor(
                    n, np.asarray(float(spec.get(key, default)), np.float32)))
                node.input.append(n)
        node.output.extend(outs)
    g.output.append(vi(output))
    if path:
        save_onnx(m, path)
    return m
