"""Minimal ONNX protobuf codec: schema-driven wire-format decode and encode
(port of `tachikoma_tpu/frontend/onnx_proto.py`, copied).

No `onnx` package is needed: the module reads and writes the protobuf wire
format (varint, 64-bit, length-delimited and 32-bit records) against a
hand-written schema of ONNX's field numbers, which onnx.proto freezes.
Decoding gives plain nested dicts; encoding lets the tests and
`chip_smoke.py` write .onnx models with neither torch.onnx nor onnx.
"""

from __future__ import annotations

import struct
from typing import Any

# kind: "varint" | "float" | "double" | "bytes" | "string" | "msg:<Name>"
# (packed repeated scalar fields are handled automatically for varint kinds)
SCHEMAS: dict[str, dict[int, tuple[str, str, bool]]] = {
    "ModelProto": {
        1: ("ir_version", "varint", False),
        2: ("producer_name", "string", False),
        3: ("producer_version", "string", False),
        5: ("model_version", "varint", False),
        7: ("graph", "msg:GraphProto", False),
        8: ("opset_import", "msg:OperatorSetIdProto", True),
    },
    "OperatorSetIdProto": {
        1: ("domain", "string", False),
        2: ("version", "varint", False),
    },
    "GraphProto": {
        1: ("node", "msg:NodeProto", True),
        2: ("name", "string", False),
        5: ("initializer", "msg:TensorProto", True),
        11: ("input", "msg:ValueInfoProto", True),
        12: ("output", "msg:ValueInfoProto", True),
        13: ("value_info", "msg:ValueInfoProto", True),
    },
    "NodeProto": {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", "msg:AttributeProto", True),
        7: ("domain", "string", False),
    },
    "AttributeProto": {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "varint", False),
        4: ("s", "bytes", False),
        5: ("t", "msg:TensorProto", False),
        7: ("floats", "float", True),
        8: ("ints", "varint", True),
        9: ("strings", "bytes", True),
        10: ("tensors", "msg:TensorProto", True),
        20: ("type", "varint", False),
    },
    "TensorProto": {
        1: ("dims", "varint", True),
        2: ("data_type", "varint", False),
        4: ("float_data", "float", True),
        5: ("int32_data", "varint", True),
        6: ("string_data", "bytes", True),
        7: ("int64_data", "varint", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
        10: ("double_data", "double", True),
        11: ("uint64_data", "varint", True),
    },
    "ValueInfoProto": {
        1: ("name", "string", False),
        2: ("type", "msg:TypeProto", False),
    },
    "TypeProto": {
        1: ("tensor_type", "msg:TypeProto.Tensor", False),
    },
    "TypeProto.Tensor": {
        1: ("elem_type", "varint", False),
        2: ("shape", "msg:TensorShapeProto", False),
    },
    "TensorShapeProto": {
        1: ("dim", "msg:TensorShapeProto.Dimension", True),
    },
    "TensorShapeProto.Dimension": {
        1: ("dim_value", "varint", False),
        2: ("dim_param", "string", False),
    },
}

# ONNX TensorProto.DataType -> numpy dtype string
ONNX_DTYPES = {
    1: "float32", 2: "uint8", 3: "int8", 4: "uint16", 5: "int16",
    6: "int32", 7: "int64", 9: "bool", 10: "float16", 11: "float64",
    12: "uint32", 13: "uint64", 16: "bfloat16",
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
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


def decode(buf: bytes, schema_name: str) -> dict[str, Any]:
    """Decode one message into {field_name: value-or-list}."""
    schema = SCHEMAS[schema_name]
    out: dict[str, Any] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_no, wire = key >> 3, key & 7
        spec = schema.get(field_no)
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            val = _signed(val)
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif wire == 5:
            (val,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if spec is None:
            continue  # unknown field: skip
        name, kind, repeated = spec
        if kind.startswith("msg:"):
            val = decode(val, kind[4:])
        elif kind == "string" and isinstance(val, (bytes, bytearray)):
            val = val.decode("utf-8", "replace")
        elif kind == "varint" and wire == 2:
            # packed repeated varints
            vals = []
            p2 = 0
            while p2 < len(val):
                v, p2 = _read_varint(val, p2)
                vals.append(_signed(v))
            if repeated:
                out.setdefault(name, []).extend(vals)
                continue
            val = vals[-1] if vals else 0
        elif kind == "float" and wire == 2:
            vals = list(struct.unpack(f"<{len(val)//4}f", val))
            out.setdefault(name, []).extend(vals)
            continue
        elif kind == "double" and wire == 2:
            vals = list(struct.unpack(f"<{len(val)//8}d", val))
            out.setdefault(name, []).extend(vals)
            continue
        if repeated:
            out.setdefault(name, []).append(val)
        else:
            out[name] = val
    return out


# -- encoding (for tests / the exporter) -------------------------------------

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


def encode(msg: dict[str, Any], schema_name: str) -> bytes:
    schema = SCHEMAS[schema_name]
    by_name = {name: (no, kind, rep) for no, (name, kind, rep) in schema.items()}
    out = bytearray()
    for name, value in msg.items():
        if name not in by_name:
            raise KeyError(f"{schema_name} has no field {name}")
        no, kind, rep = by_name[name]
        values = value if rep else [value]
        for v in values:
            if kind.startswith("msg:"):
                payload = encode(v, kind[4:])
                out += _write_varint((no << 3) | 2) + _write_varint(len(payload)) + payload
            elif kind == "varint":
                out += _write_varint((no << 3) | 0) + _write_varint(int(v))
            elif kind == "float":
                out += _write_varint((no << 3) | 5) + struct.pack("<f", float(v))
            elif kind == "double":
                out += _write_varint((no << 3) | 1) + struct.pack("<d", float(v))
            elif kind in ("bytes", "string"):
                b = v.encode() if isinstance(v, str) else bytes(v)
                out += _write_varint((no << 3) | 2) + _write_varint(len(b)) + b
            else:
                raise ValueError(kind)
    return bytes(out)


def tensor_to_np(t: dict):
    import numpy as np

    dims = tuple(t.get("dims", []))
    dtype = ONNX_DTYPES.get(t.get("data_type", 1), "float32")
    raw = t.get("raw_data")
    if raw:
        if dtype == "bfloat16":
            a = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
            return a.view(np.float32).reshape(dims).astype(np.float32)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(dims).copy()
    for key, np_dt in (("float_data", np.float32), ("int32_data", np.int32),
                       ("int64_data", np.int64), ("double_data", np.float64),
                       ("uint64_data", np.uint64)):
        if t.get(key):
            return np.asarray(t[key], dtype=np_dt).reshape(dims)
    return np.zeros(dims, dtype=np.dtype(dtype))


def np_to_tensor(name: str, arr) -> dict:
    import numpy as np

    arr = np.asarray(arr)
    shape = list(arr.shape)  # before ascontiguousarray, which promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    code = {v: k for k, v in ONNX_DTYPES.items()}[str(arr.dtype)]
    return {"name": name, "dims": shape, "data_type": code,
            "raw_data": arr.tobytes()}


def load_model(path_or_bytes) -> dict:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return decode(bytes(path_or_bytes), "ModelProto")
    with open(path_or_bytes, "rb") as f:
        return decode(f.read(), "ModelProto")
