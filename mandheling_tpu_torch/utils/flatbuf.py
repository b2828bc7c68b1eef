"""Minimal FlatBuffers wire-format reader + builder (dependency-free).

The reference's converter consumes FlatBuffers twice over: its own model
format is FlatBuffers (`schema/default/MNN.fbs`) and its TFLite importer
parses `.tflite` files (`tools/converter/source/tflite`, SURVEY.md
section 2.9). This module implements just the wire format — vtables,
tables, vectors, strings, scalars — so `tflite_io.py` can read and write
real `.tflite` files without a flatbuffers dependency (not in this image).

Reader: absolute-offset accessors over a bytes object.
Builder: back-to-front construction with positions measured from the end
of the buffer (the standard FlatBuffers build order). Alignment follows
the spec: objects are aligned by their position-from-end, and `finish`
pads the front so the total size is a multiple of the largest alignment
used — making every field absolutely aligned, as strict C++ verifiers
require. O(n) prepends make this a small-model builder (fine: model
metadata is KBs; big weight buffers are appended as single blobs).

The port's own copy of ``mandheling_tpu/utils/flatbuf.py`` (pure Python and
numpy); the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------- reader

_SCALAR = {
    "u8": ("<B", 1), "i8": ("<b", 1), "u16": ("<H", 2), "i16": ("<h", 2),
    "u32": ("<I", 4), "i32": ("<i", 4), "u64": ("<Q", 8), "i64": ("<q", 8),
    "f32": ("<f", 4), "f64": ("<d", 8), "bool": ("<B", 1),
}


def _read(buf: bytes, pos: int, kind: str):
    fmt, size = _SCALAR[kind]
    return struct.unpack_from(fmt, buf, pos)[0]


class Table:
    """Read-side table accessor: field ids per the .fbs declaration order."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    def _field_pos(self, fid: int) -> Optional[int]:
        vt = self.pos - _read(self.buf, self.pos, "i32")
        vt_size = _read(self.buf, vt, "u16")
        entry = 4 + 2 * fid
        if entry + 2 > vt_size:
            return None
        off = _read(self.buf, vt + entry, "u16")
        return self.pos + off if off else None

    def scalar(self, fid: int, kind: str, default=0):
        p = self._field_pos(fid)
        if p is None:
            return default
        v = _read(self.buf, p, kind)
        return bool(v) if kind == "bool" else v

    def _indirect(self, fid: int) -> Optional[int]:
        p = self._field_pos(fid)
        if p is None:
            return None
        return p + _read(self.buf, p, "u32")

    def table(self, fid: int) -> Optional["Table"]:
        t = self._indirect(fid)
        return None if t is None else Table(self.buf, t)

    def string(self, fid: int) -> Optional[str]:
        v = self._indirect(fid)
        if v is None:
            return None
        n = _read(self.buf, v, "u32")
        return self.buf[v + 4 : v + 4 + n].decode("utf-8")

    def vector_len(self, fid: int) -> int:
        v = self._indirect(fid)
        return 0 if v is None else _read(self.buf, v, "u32")

    def scalar_vector(self, fid: int, kind: str) -> List:
        v = self._indirect(fid)
        if v is None:
            return []
        n = _read(self.buf, v, "u32")
        fmt, size = _SCALAR[kind]
        return list(struct.unpack_from(f"<{n}{fmt[1]}", self.buf, v + 4))

    def bytes_vector(self, fid: int) -> bytes:
        v = self._indirect(fid)
        if v is None:
            return b""
        n = _read(self.buf, v, "u32")
        return bytes(self.buf[v + 4 : v + 4 + n])

    def table_vector(self, fid: int) -> List["Table"]:
        v = self._indirect(fid)
        if v is None:
            return []
        n = _read(self.buf, v, "u32")
        out = []
        for i in range(n):
            p = v + 4 + 4 * i
            out.append(Table(self.buf, p + _read(self.buf, p, "u32")))
        return out


def root_table(buf: bytes) -> Table:
    return Table(buf, _read(buf, 0, "u32"))


def file_identifier(buf: bytes) -> str:
    return buf[4:8].decode("ascii", errors="replace")


# --------------------------------------------------------------- builder


class Builder:
    """Back-to-front FlatBuffers builder.

    All offsets handed around are positions from the END of the buffer
    (`pos`); absolute address = total_size - pos, and `finish` pads the
    total size to the largest alignment so pos-alignment implies
    address-alignment.
    """

    def __init__(self):
        self.data = bytearray()
        self.minalign = 4

    # -- low-level ----------------------------------------------------
    def _pad_for(self, payload_len: int, align: int, skip: int = 0):
        """Prepend zeros so that after prepending `payload_len` bytes, the
        position-from-end of (payload start + skip) is `align`-aligned —
        `skip=4` aligns a vector's *elements* (which sit after the 4-byte
        length prefix; the prefix itself is then 4-aligned too whenever
        align is a multiple of 4), `skip=0` aligns the object start."""
        self.minalign = max(self.minalign, align)
        while (len(self.data) + payload_len - skip) % align:
            self.data[0:0] = b"\x00"

    def _prepend(self, b: bytes) -> int:
        self.data[0:0] = b
        return len(self.data)

    # -- objects ------------------------------------------------------
    def bytes_vector(self, raw: bytes, elem_size: int = 1) -> int:
        """Vector of scalars from packed bytes; returns its pos."""
        payload = struct.pack("<I", len(raw) // elem_size) + raw
        # length prefix 4-aligned AND elements elem_size-aligned
        self._pad_for(len(payload), max(4, elem_size), skip=4)
        return self._prepend(payload)

    def scalar_vector(self, kind: str, values: Sequence) -> int:
        fmt, size = _SCALAR[kind]
        raw = struct.pack(f"<{len(values)}{fmt[1]}", *values)
        return self.bytes_vector(raw, size)

    def offset_vector(self, positions: Sequence[int]) -> int:
        """Vector of uoffsets to already-written objects."""
        n = len(positions)
        payload_len = 4 + 4 * n
        self._pad_for(payload_len, 4)
        total_after = len(self.data) + payload_len
        parts = [struct.pack("<I", n)]
        for i, target in enumerate(positions):
            field_pos = total_after - 4 - 4 * i
            parts.append(struct.pack("<I", field_pos - target))
        return self._prepend(b"".join(parts))

    def string(self, s: str) -> int:
        raw = s.encode("utf-8") + b"\x00"
        payload = struct.pack("<I", len(raw) - 1) + raw
        self._pad_for(len(payload), 4, skip=4)
        return self._prepend(payload)

    def table(
        self,
        fields: Sequence[Tuple[int, str, Union[int, float, bool]]],
    ) -> int:
        """Write a table. `fields` = (field_id, kind, value) where kind is
        a scalar kind or "offset" (value = child pos). Fields equal to
        their schema default must simply be omitted by the caller."""
        if fields:
            max_id = max(f[0] for f in fields)
        else:
            max_id = -1
        # lay out the table data area: soffset at 0, fields packed by
        # descending size so natural alignment holds within the table
        order = sorted(
            fields,
            key=lambda f: -( _SCALAR[f[1]][1] if f[1] != "offset" else 4),
        )
        offsets: Dict[int, int] = {}
        cur = 4
        align = 4
        for fid, kind, _ in order:
            size = _SCALAR[kind][1] if kind != "offset" else 4
            cur = (cur + size - 1) // size * size
            offsets[fid] = cur
            cur += size
            align = max(align, size)
        table_len = cur
        self._pad_for(table_len, align)
        total_after = len(self.data) + table_len
        table_pos = total_after  # pos of table start after prepend
        body = bytearray(table_len)
        for fid, kind, value in fields:
            off = offsets[fid]
            if kind == "offset":
                field_pos = table_pos - off
                struct.pack_into("<I", body, off, field_pos - value)
            else:
                fmt, _ = _SCALAR[kind]
                if kind == "bool":
                    value = int(value)
                struct.pack_into(fmt, body, off, value)
        self._prepend(bytes(body))
        # vtable in front of the table (lower address): soffset > 0
        vt_fields = b"".join(
            struct.pack("<H", offsets.get(i, 0)) for i in range(max_id + 1)
        )
        vt = struct.pack("<HH", 4 + len(vt_fields), table_len) + vt_fields
        self._pad_for(len(vt), 2)
        vt_pos = self._prepend(vt)
        soffset = vt_pos - table_pos  # table_addr - vtable_addr
        idx = len(self.data) - table_pos
        struct.pack_into("<i", self.data, idx, soffset)
        return table_pos

    def finish(self, root_pos: int, identifier: Optional[str] = None) -> bytes:
        prefix = 8 if identifier else 4
        # pad so total size is a multiple of minalign
        while (len(self.data) + prefix) % self.minalign:
            self.data[0:0] = b"\x00"
        total = len(self.data) + prefix
        head = struct.pack("<I", total - root_pos)
        if identifier:
            head += identifier.encode("ascii")
        return bytes(head + self.data)
