"""TensorFlow frozen-graph (GraphDef) wire codec — reader + minimal writer.

The reference converter's TensorFlow leg ingests frozen GraphDef protos
(`tools/converter/source/tensorflow`); this is the TPU-rebuild analog.
Hand-rolled proto field parsing (same approach as utils/xplane.py and the
vendored ONNX codec): the GraphDef schema subset needed for CNN inference
graphs —

  GraphDef    { node: repeated NodeDef = 1 }
  NodeDef     { name=1, op=2, input=3 (repeated string), attr=5 (map) }
  AttrValue   { s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8, list=1 }
  TensorProto { dtype=1, tensor_shape=2, tensor_content=4, float_val=5,
                int_val=6 }
  TensorShapeProto { dim=2 { size=1 } }

Only float32/int32 tensors are decoded (the converter quantizes weights
itself). Writer emits the same subset for round-trip tests.

The port's own copy of ``mandheling_tpu/utils/tf_graphdef.py`` (pure Python and
numpy); the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

DT_FLOAT = 1
DT_INT32 = 3

# ---------------------------------------------------------------- wire layer


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _emit_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _emit_field(field: int, wt: int, payload: bytes) -> bytes:
    if wt == 2:
        return _emit_varint((field << 3) | 2) + _emit_varint(len(payload)) + payload
    if wt == 0:
        return _emit_varint(field << 3) + payload  # payload is pre-varinted
    if wt == 5:
        return _emit_varint((field << 3) | 5) + payload  # 32-bit fixed
    raise ValueError(wt)


# ------------------------------------------------------------- object model


class TFTensor:
    __slots__ = ("dtype", "shape", "data")

    def __init__(self, dtype: int, shape: List[int], data: Optional[np.ndarray]):
        self.dtype = dtype
        self.shape = shape
        self.data = data

    @classmethod
    def parse(cls, buf: bytes) -> "TFTensor":
        dtype, shape, content = 0, [], b""
        scalars: List[float] = []
        iscalars: List[int] = []
        for f, wt, v in _fields(buf):
            if f == 1:
                dtype = v
            elif f == 2:  # tensor_shape
                for f2, _, v2 in _fields(v):
                    if f2 == 2:  # dim
                        for f3, _, v3 in _fields(v2):
                            if f3 == 1:
                                shape.append(v3 - (1 << 64) if v3 >= (1 << 63)
                                             else v3)
            elif f == 4:
                content = v
            elif f == 5:
                scalars.append(struct.unpack("<f", v)[0] if wt == 5 else 0.0)
            elif f == 6:
                iscalars.append(v)
        if dtype == DT_FLOAT:
            if content:
                arr = np.frombuffer(content, "<f4").reshape(shape)
            elif scalars:
                arr = np.broadcast_to(
                    np.asarray(scalars, np.float32),
                    shape or [len(scalars)]).copy()
            else:
                arr = np.zeros(shape, np.float32)
        elif dtype == DT_INT32:
            if content:
                arr = np.frombuffer(content, "<i4").reshape(shape)
            elif iscalars:
                arr = np.broadcast_to(
                    np.asarray(iscalars, np.int32),
                    shape or [len(iscalars)]).copy()
            else:
                arr = np.zeros(shape, np.int32)
        else:
            arr = None
        return cls(dtype, list(map(int, shape)), arr)

    def emit(self) -> bytes:
        out = bytearray()
        out += _emit_field(1, 0, _emit_varint(self.dtype))
        dims = bytearray()
        for d in self.shape:
            dims += _emit_field(2, 2, _emit_field(1, 0, _emit_varint(d)))
        out += _emit_field(2, 2, bytes(dims))
        if self.data is not None:
            out += _emit_field(4, 2, np.ascontiguousarray(self.data).tobytes())
        return bytes(out)


class AttrValue:
    """Decoded attr: one of s/i/f/b/type/tensor/list(i|s)."""

    @staticmethod
    def parse(buf: bytes) -> object:
        for f, wt, v in _fields(buf):
            if f == 2:
                return v.decode("utf-8", "replace")
            if f == 3:
                return v - (1 << 64) if v >= (1 << 63) else v
            if f == 4:
                return struct.unpack("<f", v)[0]
            if f == 5:
                return bool(v)
            if f == 6:
                return ("dtype", v)
            if f == 8:
                return TFTensor.parse(v)
            if f == 1:  # list
                ints: List[int] = []
                strs: List[str] = []
                for f2, wt2, v2 in _fields(v):
                    if f2 == 2 and wt2 == 2:
                        strs.append(v2.decode("utf-8", "replace"))
                    elif f2 == 3 and wt2 == 0:
                        ints.append(v2 - (1 << 64) if v2 >= (1 << 63) else v2)
                    elif f2 == 3 and wt2 == 2:
                        # packed repeated varints (TF's own serialization)
                        pos = 0
                        while pos < len(v2):
                            iv, pos = _read_varint(v2, pos)
                            ints.append(iv - (1 << 64) if iv >= (1 << 63)
                                        else iv)
                return strs or ints
        return None


class TFNode:
    __slots__ = ("name", "op", "input", "attr")

    def __init__(self, name="", op="", input=None, attr=None):
        self.name = name
        self.op = op
        self.input: List[str] = list(input or [])
        self.attr: Dict[str, object] = dict(attr or {})

    @classmethod
    def parse(cls, buf: bytes) -> "TFNode":
        node = cls()
        for f, wt, v in _fields(buf):
            if f == 1:
                node.name = v.decode()
            elif f == 2:
                node.op = v.decode()
            elif f == 3:
                node.input.append(v.decode())
            elif f == 5:  # map<string, AttrValue>
                key, val = "", None
                for f2, _, v2 in _fields(v):
                    if f2 == 1:
                        key = v2.decode()
                    elif f2 == 2:
                        val = AttrValue.parse(v2)
                node.attr[key] = val
        return node


class GraphDef:
    def __init__(self, nodes: Optional[List[TFNode]] = None):
        self.node = list(nodes or [])

    @classmethod
    def parse(cls, buf: bytes) -> "GraphDef":
        g = cls()
        for f, wt, v in _fields(buf):
            if f == 1:
                g.node.append(TFNode.parse(v))
        return g


def load_graphdef(path_or_bytes) -> GraphDef:
    buf = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
           else open(path_or_bytes, "rb").read())
    return GraphDef.parse(bytes(buf))


# ----------------------------------------------------------------- writer


def _attr(key: str, wt_field: int, payload: bytes) -> bytes:
    inner = _emit_field(1, 2, key.encode()) + payload
    return _emit_field(5, 2, inner)


def _attr_value(field: int, wt: int, payload: bytes) -> bytes:
    return _emit_field(2, 2, _emit_field(field, wt, payload))


def build_graphdef(nodes: List[Tuple[str, str, List[str], Dict]]) -> bytes:
    """nodes: (name, op, inputs, attrs) where attrs values may be:
    int, str(bytes-attr), bool, ("dtype", int), np.ndarray (tensor),
    list[int] (int list), list[str] (str list)."""
    out = bytearray()
    for name, op, inputs, attrs in nodes:
        nb = bytearray()
        nb += _emit_field(1, 2, name.encode())
        nb += _emit_field(2, 2, op.encode())
        for i in inputs:
            nb += _emit_field(3, 2, i.encode())
        for key, val in attrs.items():
            if isinstance(val, np.ndarray):
                t = TFTensor(DT_FLOAT if val.dtype == np.float32 else DT_INT32,
                             list(val.shape), val)
                nb += _attr(key, 2, _attr_value(8, 2, t.emit()))
            elif isinstance(val, tuple) and val[0] == "dtype":
                nb += _attr(key, 0, _attr_value(6, 0, _emit_varint(val[1])))
            elif isinstance(val, bool):
                nb += _attr(key, 0, _attr_value(5, 0, _emit_varint(int(val))))
            elif isinstance(val, float):
                nb += _attr(key, 2, _attr_value(
                    4, 5, struct.pack("<f", val)))
            elif isinstance(val, int):
                nb += _attr(key, 0, _attr_value(3, 0, _emit_varint(val)))
            elif isinstance(val, str):
                nb += _attr(key, 2, _attr_value(2, 2, val.encode()))
            elif isinstance(val, (list, tuple)):
                lb = bytearray()
                for item in val:
                    if isinstance(item, str):
                        lb += _emit_field(2, 2, item.encode())
                    else:
                        lb += _emit_field(3, 0, _emit_varint(int(item)))
                nb += _attr(key, 2, _attr_value(1, 2, bytes(lb)))
            else:
                raise ValueError(f"unsupported attr {key}={val!r}")
        out += _emit_field(1, 2, bytes(nb))
    return bytes(out)
