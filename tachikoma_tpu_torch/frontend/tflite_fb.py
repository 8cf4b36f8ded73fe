"""In-tree FlatBuffers reader for the TFLite schema (port of
`tachikoma_tpu/frontend/tflite_fb.py`, copied: numpy and struct only).

It implements the small part of the FlatBuffers binary format the TFLite
schema needs (tables with vtables, scalar and struct fields, strings,
vectors of scalars and offsets) plus typed accessors for the TFLite tables,
with field slots and enum values pinned against the official generated
schema, so no tflite, flatbuffers or TensorFlow package is needed.

FlatBuffers layout (flatbuffers.dev/internals):
  * root: uoffset32 at byte 0 -> root table; bytes 4-8 file id ("TFL3")
  * table: soffset32 at table start pointing BACK to its vtable;
    vtable = [u16 vtable_bytes, u16 table_bytes, u16 field_off...] where
    field_off is relative to the table start (0 = field absent/default)
  * scalars stored inline; strings/vectors/tables stored as uoffset32
    (relative to the field's own location)
  * vector: u32 length followed by elements; string: u32 length + bytes
"""

from __future__ import annotations

import struct

import numpy as np


def _u8(b, o):
    return b[o]


def _u16(b, o):
    return struct.unpack_from("<H", b, o)[0]


def _i32(b, o):
    return struct.unpack_from("<i", b, o)[0]


def _u32(b, o):
    return struct.unpack_from("<I", b, o)[0]


_SCALAR = {
    "u8": ("<B", 1), "i8": ("<b", 1), "u16": ("<H", 2), "i16": ("<h", 2),
    "u32": ("<I", 4), "i32": ("<i", 4), "u64": ("<Q", 8), "i64": ("<q", 8),
    "f32": ("<f", 4), "f64": ("<d", 8), "bool": ("<B", 1),
}

_NP = {"u8": np.uint8, "i8": np.int8, "i32": np.int32, "i64": np.int64,
       "f32": np.float32, "u32": np.uint32}


class Table:
    """Generic FlatBuffers table accessor."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos

    def _field(self, slot: int) -> int | None:
        """Absolute offset of field data, or None if absent (default)."""
        vtab = self.pos - _i32(self.buf, self.pos)
        vsize = _u16(self.buf, vtab)
        off = 4 + 2 * slot
        if off >= vsize:
            return None
        rel = _u16(self.buf, vtab + off)
        return self.pos + rel if rel else None

    def scalar(self, slot: int, kind: str, default=0):
        o = self._field(slot)
        if o is None:
            return default
        fmt, _ = _SCALAR[kind]
        v = struct.unpack_from(fmt, self.buf, o)[0]
        return bool(v) if kind == "bool" else v

    def table(self, slot: int) -> "Table | None":
        o = self._field(slot)
        if o is None:
            return None
        return Table(self.buf, o + _u32(self.buf, o))

    def union(self, slot: int) -> "Table | None":
        # union value fields are stored like table fields
        return self.table(slot)

    def string(self, slot: int, default: str = "") -> str:
        o = self._field(slot)
        if o is None:
            return default
        v = o + _u32(self.buf, o)
        n = _u32(self.buf, v)
        return bytes(self.buf[v + 4:v + 4 + n]).decode("utf-8")

    def _vec(self, slot: int):
        o = self._field(slot)
        if o is None:
            return None, 0
        v = o + _u32(self.buf, o)
        return v + 4, _u32(self.buf, v)

    def vec_len(self, slot: int) -> int:
        return self._vec(slot)[1]

    def vec_scalars(self, slot: int, kind: str) -> np.ndarray:
        start, n = self._vec(slot)
        if start is None:
            return np.zeros((0,), dtype=_NP.get(kind, np.int64))
        itemsize = _SCALAR[kind][1]
        raw = bytes(self.buf[start:start + n * itemsize])
        return np.frombuffer(raw, dtype=_NP[kind]).copy()

    def vec_tables(self, slot: int) -> list["Table"]:
        start, n = self._vec(slot)
        out = []
        for k in range(n):
            o = start + 4 * k
            out.append(Table(self.buf, o + _u32(self.buf, o)))
        return out

    def vec_bytes(self, slot: int) -> bytes:
        start, n = self._vec(slot)
        if start is None:
            return b""
        return bytes(self.buf[start:start + n])


def root(buf) -> Table:
    return Table(buf, _u32(buf, 0))


def file_identifier(buf) -> str:
    return bytes(buf[4:8]).decode("latin1")


# ---------------------------------------------------------------------------
# TFLite schema tables (slots verified against schema_py_generated.py)
# ---------------------------------------------------------------------------

class Model(Table):
    def version(self):
        return self.scalar(0, "u32", 0)

    def operator_codes(self):
        return [OperatorCode(t.buf, t.pos) for t in self.vec_tables(1)]

    def subgraphs(self):
        return [SubGraph(t.buf, t.pos) for t in self.vec_tables(2)]

    def description(self):
        return self.string(3)

    def buffers(self):
        return [BufferTab(t.buf, t.pos) for t in self.vec_tables(4)]


class OperatorCode(Table):
    def builtin_code(self) -> int:
        # schema_util: max of the deprecated i8 field and the new i32 field
        return max(self.scalar(0, "i8", 0), self.scalar(3, "i32", 0))

    def custom_code(self):
        return self.string(1)

    def version(self):
        return self.scalar(2, "i32", 1)


class SubGraph(Table):
    def tensors(self):
        return [Tensor(t.buf, t.pos) for t in self.vec_tables(0)]

    def inputs(self):
        return self.vec_scalars(1, "i32")

    def outputs(self):
        return self.vec_scalars(2, "i32")

    def operators(self):
        return [Operator(t.buf, t.pos) for t in self.vec_tables(3)]

    def name(self):
        return self.string(4)


class Tensor(Table):
    def shape(self):
        return self.vec_scalars(0, "i32")

    def type(self) -> int:
        return self.scalar(1, "i8", 0)

    def buffer(self) -> int:
        return self.scalar(2, "u32", 0)

    def name(self):
        return self.string(3)

    def quantization(self):
        t = self.table(4)
        return None if t is None else Quantization(t.buf, t.pos)


class Quantization(Table):
    def scale(self) -> np.ndarray:
        return self.vec_scalars(2, "f32")

    def zero_point(self) -> np.ndarray:
        return self.vec_scalars(3, "i64")

    def quantized_dimension(self) -> int:
        return self.scalar(6, "i32", 0)


class BufferTab(Table):
    def data(self) -> bytes:
        return self.vec_bytes(0)


class Operator(Table):
    def opcode_index(self) -> int:
        return self.scalar(0, "u32", 0)

    def inputs(self):
        return self.vec_scalars(1, "i32")

    def outputs(self):
        return self.vec_scalars(2, "i32")

    def builtin_options_type(self) -> int:
        return self.scalar(3, "u8", 0)

    def builtin_options(self) -> Table | None:
        return self.union(4)


# enums (subset; pinned against BuiltinOperator/BuiltinOptions/TensorType)
class Op:
    ADD = 0
    AVERAGE_POOL_2D = 1
    CONCATENATION = 2
    CONV_2D = 3
    DEPTHWISE_CONV_2D = 4
    DEPTH_TO_SPACE = 5
    DEQUANTIZE = 6
    FULLY_CONNECTED = 9
    LOGISTIC = 14
    MAX_POOL_2D = 17
    MUL = 18
    RELU = 19
    RELU6 = 21
    RESHAPE = 22
    RESIZE_BILINEAR = 23
    SOFTMAX = 25
    SPACE_TO_DEPTH = 26
    TANH = 28
    PAD = 34
    TRANSPOSE = 39
    MEAN = 40
    SUB = 41
    SQUEEZE = 43
    STRIDED_SLICE = 45
    SPLIT = 49
    RESIZE_NEAREST_NEIGHBOR = 97
    LEAKY_RELU = 98
    QUANTIZE = 114
    HARD_SWISH = 117


class TType:
    FLOAT32 = 0
    FLOAT16 = 1
    INT32 = 2
    UINT8 = 3
    INT64 = 4
    BOOL = 6
    INT16 = 7
    INT8 = 9
    FLOAT64 = 10


NP_DTYPE = {
    TType.FLOAT32: np.float32, TType.FLOAT16: np.float16,
    TType.INT32: np.int32, TType.UINT8: np.uint8, TType.INT64: np.int64,
    TType.BOOL: np.bool_, TType.INT16: np.int16, TType.INT8: np.int8,
    TType.FLOAT64: np.float64,
}


class Act:
    NONE = 0
    RELU = 1
    RELU_N1_TO_1 = 2
    RELU6 = 3
    TANH = 4


PAD_SAME, PAD_VALID = 0, 1
