"""TFLite (.tflite) read/write on the vendored FlatBuffers codec.

Wire-compatible subset of the TFLite schema (file identifier "TFL3",
schema v3) — the ops the reference's TFLite importer handles for the
CNN model families (`tools/converter/source/tflite`, SURVEY.md
section 2.9): conv / depthwise conv / fully-connected / pooling /
reshape / softmax / relu / add / pad / mean.

Field ids below follow the public `tensorflow/lite/schema/schema.fbs`
declaration order (they ARE the wire contract; FlatBuffers ids are
append-only).

Read side returns a plain-Python object model (`TFLModel`), used by
`tflite_model.py` to build trainable NITI models. Write side serializes
a sequential float32 graph (`write_tflite`) so trained models can be
deployed to TFLite-consuming runtimes.

The port's own copy of ``mandheling_tpu/utils/tflite_io.py`` (pure Python and
numpy); the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import flatbuf as fb

# ---- enums (tflite schema) ----------------------------------------------

TENSOR_TYPE_NP = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
    4: np.int64, 7: np.int16, 9: np.int8,
}
NP_TENSOR_TYPE = {np.dtype(np.float32): 0, np.dtype(np.int32): 2,
                  np.dtype(np.uint8): 3, np.dtype(np.int8): 9}

# BuiltinOperator
ADD = 0
AVERAGE_POOL_2D = 1
CONCATENATION = 2
CONV_2D = 3
DEPTHWISE_CONV_2D = 4
FULLY_CONNECTED = 9
MAX_POOL_2D = 17
RELU = 19
RELU6 = 21
RESHAPE = 22
SOFTMAX = 25
PAD = 34
MEAN = 40

OP_NAMES = {
    ADD: "ADD", AVERAGE_POOL_2D: "AVERAGE_POOL_2D",
    CONCATENATION: "CONCATENATION", CONV_2D: "CONV_2D",
    DEPTHWISE_CONV_2D: "DEPTHWISE_CONV_2D", FULLY_CONNECTED: "FULLY_CONNECTED",
    MAX_POOL_2D: "MAX_POOL_2D", RELU: "RELU", RELU6: "RELU6",
    RESHAPE: "RESHAPE", SOFTMAX: "SOFTMAX", PAD: "PAD", MEAN: "MEAN",
}

# BuiltinOptions union member indices (schema union declaration order)
OPT_CONV2D = 1
OPT_DEPTHWISE = 2
OPT_POOL2D = 5
OPT_FULLY_CONNECTED = 8
OPT_SOFTMAX = 9
OPT_CONCAT = 10
OPT_ADD = 11
OPT_RESHAPE = 17
OPT_PAD = 22
OPT_REDUCER = 27

# Padding enum
PAD_SAME, PAD_VALID = 0, 1
# ActivationFunctionType
ACT_NONE, ACT_RELU, ACT_RELU_N1_TO_1, ACT_RELU6 = 0, 1, 2, 3


# ---- object model --------------------------------------------------------


@dataclass
class TFLTensor:
    shape: List[int]
    dtype: int
    name: str = ""
    data: Optional[np.ndarray] = None  # decoded constant, None for activations
    scale: Optional[List[float]] = None
    zero_point: Optional[List[int]] = None
    quantized_dimension: int = 0

    def dequantized(self) -> Optional[np.ndarray]:
        """Constant data as float32, applying per-tensor/axis quantization."""
        if self.data is None:
            return None
        a = self.data.astype(np.float32)
        if not self.scale:
            return a
        s = np.asarray(self.scale, np.float32)
        z = np.asarray(self.zero_point or [0] * len(self.scale), np.float32)
        if len(self.scale) == 1:
            return (a - z[0]) * s[0]
        shape = [1] * a.ndim
        shape[self.quantized_dimension] = -1
        return (a - z.reshape(shape)) * s.reshape(shape)


@dataclass
class TFLOp:
    opcode: int  # BuiltinOperator
    inputs: List[int]
    outputs: List[int]
    options: Dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return OP_NAMES.get(self.opcode, f"BUILTIN_{self.opcode}")


@dataclass
class TFLModel:
    tensors: List[TFLTensor]
    ops: List[TFLOp]
    inputs: List[int]
    outputs: List[int]
    description: str = ""


# ---- reader ---------------------------------------------------------------


def _read_options(opcode: int, opt_type: int, t: Optional[fb.Table]) -> Dict:
    if t is None:
        return {}
    if opt_type in (OPT_CONV2D, OPT_DEPTHWISE):
        d = {
            "padding": t.scalar(0, "i8"),
            "stride": (t.scalar(2, "i32", 1) or 1, t.scalar(1, "i32", 1) or 1),
        }
        if opt_type == OPT_CONV2D:
            d["fused_activation"] = t.scalar(3, "i8")
            d["dilation"] = (t.scalar(5, "i32", 1) or 1,
                             t.scalar(4, "i32", 1) or 1)
        else:
            d["depth_multiplier"] = t.scalar(3, "i32", 1) or 1
            d["fused_activation"] = t.scalar(4, "i8")
            d["dilation"] = (t.scalar(6, "i32", 1) or 1,
                             t.scalar(5, "i32", 1) or 1)
        return d
    if opt_type == OPT_POOL2D:
        return {
            "padding": t.scalar(0, "i8"),
            "stride": (t.scalar(2, "i32", 1) or 1, t.scalar(1, "i32", 1) or 1),
            "window": (t.scalar(4, "i32", 1) or 1, t.scalar(3, "i32", 1) or 1),
            "fused_activation": t.scalar(5, "i8"),
        }
    if opt_type == OPT_FULLY_CONNECTED:
        return {"fused_activation": t.scalar(0, "i8"),
                "keep_num_dims": t.scalar(2, "bool", False)}
    if opt_type == OPT_SOFTMAX:
        return {"beta": t.scalar(0, "f32", 1.0)}
    if opt_type == OPT_ADD:
        return {"fused_activation": t.scalar(0, "i8")}
    if opt_type == OPT_CONCAT:
        return {"axis": t.scalar(0, "i32", 0) or 0,
                "fused_activation": t.scalar(1, "i8")}
    if opt_type == OPT_RESHAPE:
        return {"new_shape": t.scalar_vector(0, "i32")}
    if opt_type == OPT_REDUCER:
        return {"keep_dims": t.scalar(0, "bool", False)}
    return {}


def load_tflite(path_or_bytes) -> TFLModel:
    buf = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    if fb.file_identifier(buf) != "TFL3":
        raise ValueError(
            f"not a TFLite v3 file (identifier {fb.file_identifier(buf)!r})"
        )
    model = fb.root_table(bytes(buf))
    opcodes = []
    for oc in model.table_vector(1):
        dep = oc.scalar(0, "i8")
        builtin = oc.scalar(3, "i32")
        opcodes.append(max(dep, builtin))
    buffers = [b.bytes_vector(0) for b in model.table_vector(4)]
    subgraphs = model.table_vector(2)
    if len(subgraphs) != 1:
        raise ValueError(f"expected exactly 1 subgraph, got {len(subgraphs)}")
    g = subgraphs[0]

    tensors: List[TFLTensor] = []
    for t in g.table_vector(0):
        shape = t.scalar_vector(0, "i32")
        dtype = t.scalar(1, "i8")
        bidx = t.scalar(2, "u32")
        q = t.table(4)
        data = None
        if bidx and bidx < len(buffers) and buffers[bidx]:
            np_dtype = TENSOR_TYPE_NP.get(dtype)
            if np_dtype is None:
                raise ValueError(f"unsupported tensor type {dtype}")
            data = np.frombuffer(buffers[bidx], np_dtype).reshape(shape)
        tensors.append(
            TFLTensor(
                shape=shape,
                dtype=dtype,
                name=t.string(3) or "",
                data=data,
                scale=q.scalar_vector(2, "f32") if q else None,
                zero_point=q.scalar_vector(3, "i64") if q else None,
                quantized_dimension=q.scalar(6, "i32") if q else 0,
            )
        )

    ops: List[TFLOp] = []
    for o in g.table_vector(3):
        opcode = opcodes[o.scalar(0, "u32")]
        ops.append(
            TFLOp(
                opcode=opcode,
                inputs=o.scalar_vector(1, "i32"),
                outputs=o.scalar_vector(2, "i32"),
                options=_read_options(opcode, o.scalar(3, "u8"), o.table(4)),
            )
        )
    return TFLModel(
        tensors=tensors,
        ops=ops,
        inputs=g.scalar_vector(1, "i32"),
        outputs=g.scalar_vector(2, "i32"),
        description=model.string(3) or "",
    )


# ---- writer ---------------------------------------------------------------


class TFLiteWriter:
    """Builds a single-subgraph float32 TFLite file.

    Usage: add tensors (activations or constants), then ops in execution
    order, then `finish(inputs, outputs)`.
    """

    def __init__(self, description: str = "mandheling_tpu export"):
        self.tensors: List[Tuple[List[int], int, str, Optional[np.ndarray]]] = []
        self.ops: List[Tuple[int, List[int], List[int], int, Dict]] = []
        self.description = description

    def tensor(self, shape, dtype=np.float32, name="",
               data: Optional[np.ndarray] = None) -> int:
        code = NP_TENSOR_TYPE[np.dtype(dtype)]
        if data is not None:
            data = np.ascontiguousarray(data, dtype)
        self.tensors.append((list(map(int, shape)), code, name, data))
        return len(self.tensors) - 1

    def const(self, arr: np.ndarray, name="") -> int:
        return self.tensor(arr.shape, arr.dtype, name, data=arr)

    def op(self, opcode: int, inputs, outputs, opt_type: int = 0,
           options: Optional[Dict] = None) -> None:
        self.ops.append(
            (opcode, list(inputs), list(outputs), opt_type, options or {})
        )

    # -- serialization --
    @staticmethod
    def _options_fields(opcode: int, opt_type: int, o: Dict, b: fb.Builder):
        f = []
        if opt_type in (OPT_CONV2D, OPT_DEPTHWISE):
            sh, sw = o.get("stride", (1, 1))
            f = [(0, "i8", o.get("padding", PAD_VALID)),
                 (1, "i32", sw), (2, "i32", sh)]
            if opt_type == OPT_CONV2D:
                f.append((3, "i8", o.get("fused_activation", ACT_NONE)))
            else:
                f += [(3, "i32", o.get("depth_multiplier", 1)),
                      (4, "i8", o.get("fused_activation", ACT_NONE))]
        elif opt_type == OPT_POOL2D:
            sh, sw = o.get("stride", (1, 1))
            wh, ww = o.get("window", (1, 1))
            f = [(0, "i8", o.get("padding", PAD_VALID)),
                 (1, "i32", sw), (2, "i32", sh),
                 (3, "i32", ww), (4, "i32", wh),
                 (5, "i8", o.get("fused_activation", ACT_NONE))]
        elif opt_type == OPT_RESHAPE and o.get("new_shape") is not None:
            f = [(0, "offset", b.scalar_vector("i32", o["new_shape"]))]
        elif opt_type == OPT_SOFTMAX:
            f = [(0, "f32", o.get("beta", 1.0))]
        elif opt_type == OPT_REDUCER:
            f = [(0, "bool", o.get("keep_dims", False))]
        elif opt_type == OPT_CONCAT:
            f = [(0, "i32", o.get("axis", 3)),
                 (1, "i8", o.get("fused_activation", ACT_NONE))]
        elif opt_type == OPT_ADD:
            f = [(0, "i8", o.get("fused_activation", ACT_NONE))]
        return f

    def finish(self, inputs, outputs) -> bytes:
        b = fb.Builder()
        # buffers: index 0 is the conventional empty sentinel
        buffer_pos = [b.table([])]
        tensor_buffer_idx = []
        for shape, code, name, data in self.tensors:
            if data is None:
                tensor_buffer_idx.append(0)
            else:
                data_pos = b.bytes_vector(data.tobytes())
                buffer_pos.append(b.table([(0, "offset", data_pos)]))
                tensor_buffer_idx.append(len(buffer_pos) - 1)
        buffers_vec = b.offset_vector(buffer_pos)

        tensor_pos = []
        for (shape, code, name, data), bidx in zip(
            self.tensors, tensor_buffer_idx
        ):
            fields = [(0, "offset", b.scalar_vector("i32", shape))]
            if code:
                fields.append((1, "i8", code))
            if bidx:
                fields.append((2, "u32", bidx))
            if name:
                fields.append((3, "offset", b.string(name)))
            tensor_pos.append(b.table(fields))
        tensors_vec = b.offset_vector(tensor_pos)

        # one operator_code per distinct builtin opcode
        code_order = sorted({op[0] for op in self.ops})
        code_index = {c: i for i, c in enumerate(code_order)}
        opcode_pos = [
            b.table(
                [(0, "i8", min(c, 127)), (2, "i32", 1), (3, "i32", c)]
            )
            for c in code_order
        ]
        opcodes_vec = b.offset_vector(opcode_pos)

        op_pos = []
        for opcode, ins, outs, opt_type, options in self.ops:
            fields = []
            if code_index[opcode]:
                fields.append((0, "u32", code_index[opcode]))
            fields.append((1, "offset", b.scalar_vector("i32", ins)))
            fields.append((2, "offset", b.scalar_vector("i32", outs)))
            if opt_type:
                opt_fields = self._options_fields(opcode, opt_type, options, b)
                fields.append((3, "u8", opt_type))
                fields.append((4, "offset", b.table(opt_fields)))
            op_pos.append(b.table(fields))
        ops_vec = b.offset_vector(op_pos)

        subgraph = b.table(
            [
                (0, "offset", tensors_vec),
                (1, "offset", b.scalar_vector("i32", list(inputs))),
                (2, "offset", b.scalar_vector("i32", list(outputs))),
                (3, "offset", ops_vec),
            ]
        )
        subgraphs_vec = b.offset_vector([subgraph])
        root = b.table(
            [
                (0, "u32", 3),
                (1, "offset", opcodes_vec),
                (2, "offset", subgraphs_vec),
                (3, "offset", b.string(self.description)),
                (4, "offset", buffers_vec),
            ]
        )
        return b.finish(root, "TFL3")


def write_tflite(path: str, writer_result: bytes) -> None:
    with open(path, "wb") as f:
        f.write(writer_result)
