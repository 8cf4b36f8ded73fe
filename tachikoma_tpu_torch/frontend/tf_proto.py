"""Minimal TensorFlow GraphDef protobuf codec: schema-driven wire-format
decode and encode, in the manner of `frontend/onnx_proto.py`.

No `tensorflow` package is needed: the module reads and writes the protobuf
wire format against a hand-written schema of the field numbers of
graph.proto, node_def.proto, attr_value.proto, tensor.proto and
tensor_shape.proto, which TensorFlow keeps stable.  Decoding gives light
`Message` objects with the attribute surface of TensorFlow's own messages
that `frontend/tensorflow.py` reads (`node.name / op / input`,
`node.attr[key].s / i / f / b / type / shape.dim[].size / list.i / tensor`);
`make_ndarray` has `tf.make_ndarray`'s semantics.  Encoding lets
`models/keras_resnet.py` write frozen graphs without TensorFlow.

The schema names only the fields the importer and the writer use.  The
others (a graph's function library, a node's debug info, a list attr's
strings) are kept as their raw records and written back as they came, so a
decoded graph re-encodes to a message TensorFlow parses equal to the
original.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

# kind: "int" (signed varint: int32, int64 and enums, a negative value as ten
# bytes of two's complement) | "uint" | "bool" | "float" | "double" | "bytes"
# | "string" | "msg:<Name>" | "map:<Name>" (map<string, Name>)
SCHEMAS: dict[str, dict[int, tuple[str, str, bool]]] = {
    "GraphDef": {
        1: ("node", "msg:NodeDef", True),
        4: ("versions", "msg:VersionDef", False),
    },
    "VersionDef": {
        1: ("producer", "int", False),
    },
    "NodeDef": {
        1: ("name", "string", False),
        2: ("op", "string", False),
        3: ("input", "string", True),
        4: ("device", "string", False),
        5: ("attr", "map:AttrValue", False),
    },
    "AttrValue": {
        1: ("list", "msg:ListValue", False),
        2: ("s", "bytes", False),
        3: ("i", "int", False),
        4: ("f", "float", False),
        5: ("b", "bool", False),
        6: ("type", "int", False),
        7: ("shape", "msg:TensorShapeProto", False),
        8: ("tensor", "msg:TensorProto", False),
    },
    "ListValue": {
        3: ("i", "int", True),
    },
    "TensorProto": {
        1: ("dtype", "int", False),
        2: ("tensor_shape", "msg:TensorShapeProto", False),
        4: ("tensor_content", "bytes", False),
        5: ("float_val", "float", True),
        6: ("double_val", "double", True),
        7: ("int_val", "int", True),
        10: ("int64_val", "int", True),
        11: ("bool_val", "bool", True),
        13: ("half_val", "int", True),
        16: ("uint32_val", "uint", True),
        17: ("uint64_val", "uint", True),
    },
    "TensorShapeProto": {
        2: ("dim", "msg:TensorShapeProto.Dim", True),
    },
    "TensorShapeProto.Dim": {
        1: ("size", "int", False),
    },
}
_BY_NAME = {t: {name: (no, kind, rep) for no, (name, kind, rep) in s.items()}
            for t, s in SCHEMAS.items()}
_SCALAR_DEFAULTS = {"int": 0, "uint": 0, "bool": False, "float": 0.0, "double": 0.0,
                    "bytes": b"", "string": ""}

# TensorFlow's DataType enum -> numpy dtype string (the JAX package's
# frontend/tensorflow.py _DTYPES)
TF_DTYPES = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
    6: "int8", 9: "int64", 10: "bool", 14: "bfloat16", 17: "uint16",
    19: "float16", 22: "uint32", 23: "uint64",
}
_TF_ENUMS = {v: k for k, v in TF_DTYPES.items()}


def np_dtype(enum: int) -> str:
    """The numpy dtype name of a DataType enum; an enum outside TF_DTYPES
    raises NotImplementedError, as the JAX importer's `_np_dtype` does."""
    try:
        return TF_DTYPES[enum]
    except KeyError:
        raise NotImplementedError(f"TF dtype enum {enum}") from None


class Message:
    """One decoded (or built) message: its present fields as attributes.
    An absent field reads as its default (0, "", b"", False, an empty list,
    an empty message) without becoming present; `encode` writes exactly the
    present fields, so a oneof member set to its default (an AttrValue's
    `b: false`) survives a round trip."""

    def __init__(self, _type: str, **fields):
        object.__setattr__(self, "_type", _type)
        object.__setattr__(self, "_unknown", [])
        for k, v in fields.items():
            setattr(self, k, v)

    def __setattr__(self, name: str, value):
        if name not in _BY_NAME[self._type]:
            raise AttributeError(f"{self._type} has no field {name}")
        object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        spec = _BY_NAME[object.__getattribute__(self, "_type")].get(name)
        if spec is None:
            raise AttributeError(name)
        _, kind, rep = spec
        if rep:
            return []
        if kind.startswith("msg:"):
            return Message(kind[4:])
        if kind.startswith("map:"):
            return {}
        return _SCALAR_DEFAULTS[kind]

    def fields(self) -> dict[str, Any]:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def __eq__(self, other) -> bool:
        return (isinstance(other, Message) and self._type == other._type
                and self.fields() == other.fields() and self._unknown == other._unknown)

    def __repr__(self) -> str:
        return f"{self._type}({', '.join(f'{k}={v!r}' for k, v in self.fields().items())})"

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf's name)
        return encode(self)


# -- decoding ----------------------------------------------------------------

def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _scalar(kind: str, v: int):
    if kind == "int":
        return _signed(v)
    if kind == "bool":
        return bool(v)
    return v


def _packed(buf, kind: str) -> list:
    if kind == "float":
        return np.frombuffer(buf, "<f4").tolist()
    if kind == "double":
        return np.frombuffer(buf, "<f8").tolist()
    vals, pos, n = [], 0, len(buf)
    while pos < n:
        v, pos = _read_varint(buf, pos)
        vals.append(_scalar(kind, v))
    return vals


def decode(buf, type_name: str) -> Message:
    """Decode one message of `type_name` from `buf` (bytes or memoryview)."""
    buf = memoryview(buf)
    msg = Message(type_name)
    fields = vars(msg)
    schema = SCHEMAS[type_name]
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        no, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        spec = schema.get(no)
        if spec is None:
            msg._unknown.append((no, wire, bytes(val) if wire == 2 else val))
            continue
        name, kind, rep = spec
        if kind.startswith("map:"):
            entry = {}
            p, m = 0, len(val)
            while p < m:
                k, p = _read_varint(val, p)
                ln, p = _read_varint(val, p)
                entry[k >> 3] = val[p:p + ln]
                p += ln
            key_s = bytes(entry.get(1, b"")).decode("utf-8")
            fields.setdefault(name, {})[key_s] = decode(entry.get(2, b""), kind[4:])
            continue
        if kind.startswith("msg:"):
            val = decode(val, kind[4:])
        elif kind == "string":
            val = bytes(val).decode("utf-8")
        elif kind == "bytes":
            val = bytes(val)
        elif wire == 2:  # packed repeated scalars
            vals = _packed(val, kind)
            if rep:
                fields.setdefault(name, []).extend(vals)
            elif vals:
                fields[name] = vals[-1]
            continue
        elif kind == "float":
            (val,) = struct.unpack("<f", val)
        elif kind == "double":
            (val,) = struct.unpack("<d", val)
        else:
            val = _scalar(kind, val)
        if rep:
            fields.setdefault(name, []).append(val)
        else:
            fields[name] = val
    return msg


def parse_graph_def(data) -> Message:
    return decode(data, "GraphDef")


def load_graph_def(path_or_bytes) -> Message:
    """A GraphDef from serialized bytes or from a `.pb` file's path."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return parse_graph_def(path_or_bytes)
    with open(os.fspath(path_or_bytes), "rb") as f:
        return parse_graph_def(f.read())


# -- encoding ----------------------------------------------------------------

def _write_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _record(no: int, wire: int, payload: bytes) -> bytes:
    if wire == 2:
        return _write_varint((no << 3) | 2) + _write_varint(len(payload)) + payload
    return _write_varint((no << 3) | wire) + payload


def _scalar_payload(kind: str, v) -> tuple[int, bytes]:
    if kind == "float":
        return 5, struct.pack("<f", float(v))
    if kind == "double":
        return 1, struct.pack("<d", float(v))
    if kind in ("bytes", "string"):
        return 2, v.encode("utf-8") if isinstance(v, str) else bytes(v)
    return 0, _write_varint(int(v))


def encode(msg: Message) -> bytes:
    """Serialize `msg`: its present fields in field-number order (repeated
    numeric fields packed, as protobuf 3 writes them), then the records
    the schema does not name, as they came."""
    schema = SCHEMAS[msg._type]
    present = msg.fields()
    out = bytearray()
    for no in sorted(schema):
        name, kind, rep = schema[no]
        if name not in present:
            continue
        value = present[name]
        if kind.startswith("map:"):
            for key, v in value.items():
                entry = _record(1, 2, key.encode("utf-8")) + _record(2, 2, encode(v))
                out += _record(no, 2, entry)
        elif kind.startswith("msg:"):
            for v in (value if rep else [value]):
                out += _record(no, 2, encode(v))
        elif rep and kind not in ("bytes", "string"):
            if len(value):
                if kind == "float":
                    payload = np.asarray(value, "<f4").tobytes()
                elif kind == "double":
                    payload = np.asarray(value, "<f8").tobytes()
                else:
                    payload = b"".join(_write_varint(int(v)) for v in value)
                out += _record(no, 2, payload)
        else:
            for v in (value if rep else [value]):
                wire, payload = _scalar_payload(kind, v)
                out += _record(no, wire, payload)
    for no, wire, val in msg._unknown:
        out += _record(no, wire, _write_varint(val) if wire == 0 else val)
    return bytes(out)


# -- tensors -----------------------------------------------------------------

def _numpy_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        import ml_dtypes  # TensorFlow's own bfloat16 numpy type

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


_VAL_FIELDS = {
    "float32": "float_val", "float64": "double_val", "int64": "int64_val",
    "bool": "bool_val", "uint32": "uint32_val", "uint64": "uint64_val",
    "int32": "int_val", "uint8": "int_val", "uint16": "int_val", "int16": "int_val",
    "int8": "int_val",
}


def make_ndarray(tensor: Message) -> np.ndarray:
    """`tf.make_ndarray`: `tensor_content` read as raw little-endian bytes;
    otherwise the typed `*_val` list, where an empty list means zeros and a
    list shorter than the shape repeats its last value (float16 and
    bfloat16 come as bit patterns in `half_val`)."""
    shape = [int(d.size) for d in tensor.tensor_shape.dim]
    num_elements = int(np.prod(shape, dtype=np.int64))
    name = np_dtype(tensor.dtype)
    dtype = _numpy_dtype(name)
    if tensor.tensor_content:
        return np.frombuffer(tensor.tensor_content, dtype=dtype).copy().reshape(shape)
    if name in ("float16", "bfloat16"):
        values = np.asarray(tensor.half_val, np.int64).astype(np.uint16).view(dtype)
    else:
        values = np.asarray(getattr(tensor, _VAL_FIELDS[name]), dtype)
    if values.size == 0:
        return np.zeros(shape, dtype)
    if values.size != num_elements:
        values = np.pad(values, (0, num_elements - values.size), "edge")
    return values.reshape(shape)


def make_tensor_proto(arr) -> Message:
    """A TensorProto of a numpy array as TensorFlow writes a constant: a
    0-d value in its `*_val` field, any other in `tensor_content`."""
    arr = np.asarray(arr)
    name = str(arr.dtype)
    t = Message("TensorProto", dtype=_TF_ENUMS[name], tensor_shape=shape_proto(arr.shape))
    if arr.ndim == 0:
        if name in ("float16", "bfloat16"):
            t.half_val = [int(arr.reshape(1).view(np.uint16)[0])]
        else:
            t.__setattr__(_VAL_FIELDS[name], [arr.item()])
    else:
        t.tensor_content = np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()
    return t


def shape_proto(shape) -> Message:
    return Message("TensorShapeProto",
                   dim=[Message("TensorShapeProto.Dim", size=int(d)) for d in shape])
