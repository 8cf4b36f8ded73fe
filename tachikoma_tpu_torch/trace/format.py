"""tachikoma-standard trace binary format — deterministic serialization
(port of `tachikoma_tpu/trace/format.py`, kept byte for byte the same: the
port imports nothing of the JAX package, so it holds its own copy).

A trace serializes, per operator, its inputs, params, expected output, attrs
and op identifier, for a zero-knowledge-proof prover to ingest.  The format
is designed for:

  * determinism: fixed topological record order, fixed little-endian widths,
    canonical JSON attrs, C-contiguous tensor bytes — byte-identical output
    for identical (graph, inputs) on every backend;
  * random access: a trailing index allows mmap readers to seek per-op;
  * integrity: per-record CRC32 + whole-file CRC in the footer.

Layout (all integers little-endian):

  header:  magic 'TKTRACE1' | version u32 | flags u32 | graph_hash 32B
           | num_records u64 | meta_len u32 | meta (canonical JSON utf8)
  records: repeated, in topological node order:
           record_len u64 (bytes AFTER this field, incl. crc)
           node_id u32 | op_id u32
           name_len u16 | name | op_name_len u16 | op_name
           attrs_len u32 | canonical attrs JSON
           num_tensors u16
           per tensor: role u8 (0 input, 1 param, 2 output)
                       dtype u8 | ndim u8 | dims u32*ndim
                       data_len u64 | raw bytes (C order)
           crc32 u32 (of the record bytes before the crc field)
  index:   num_records entries of (node_id u32, file_offset u64)
  footer:  index_offset u64 | file_crc u32 | magic 'TKEND\\0\\0\\0'

The op_id vocabulary is frozen (append only) and equal to the JAX package's;
unknown ops get ids from a stable hash (bit 31 set).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from ..utils import dtypes as dt

MAGIC = b"TKTRACE1"
END_MAGIC = b"TKEND\x00\x00\x00"
VERSION = 1

# stable dtype codes
DTYPE_CODES = {
    "int8": 0, "uint8": 1, "int16": 2, "uint16": 3,
    "int32": 4, "uint32": 5, "int64": 6, "uint64": 7,
    "float16": 8, "float32": 9, "float64": 10, "bool": 11, "bfloat16": 12,
}
DTYPE_NAMES = {v: k for k, v in DTYPE_CODES.items()}

ROLE_INPUT, ROLE_PARAM, ROLE_OUTPUT = 0, 1, 2

# Stable op-id vocabulary: the trace op codes a ZKP consumer dispatches on.
# Order/values are frozen — append only.
OP_IDS = {
    # core integer vocabulary (cvm pattern set + qnn dialect)
    "qnn.conv2d": 1,
    "qnn.dense": 2,
    "qnn.requantize": 3,
    "qnn.quantize": 4,
    "qnn.dequantize": 5,
    "qnn.add": 6,
    "qnn.mul": 7,
    "qnn.subtract": 8,
    "qnn.concatenate": 9,
    "qnn.batch_matmul": 10,
    "qnn.avg_pool2d": 11,
    "qnn.leaky_relu": 12,
    "qnn.conv2d_transpose": 13,
    "nn.bias_add": 14,
    "nn.relu": 15,
    "clip": 16,
    "nn.max_pool2d": 17,
    "nn.avg_pool2d": 18,
    "nn.global_avg_pool2d": 19,
    "nn.global_max_pool2d": 20,
    "nn.adaptive_avg_pool2d": 21,
    "add": 22,
    "subtract": 23,
    "multiply": 24,
    "nn.batch_flatten": 25,
    "reshape": 26,
    "transpose": 27,
    "concatenate": 28,
    "split": 29,
    "squeeze": 30,
    "expand_dims": 31,
    "strided_slice": 32,
    "nn.pad": 33,
    "cast": 34,
    "fixed_point_multiply": 35,
    "fixed_point_multiply_per_axis": 36,
    "qnn.softmax": 37,
    "qnn.lut": 38,
    "qnn.attention": 39,
    "tk.conv2d_rq": 40,
    "tk.dense_rq": 41,
    "tk.bmm_rq": 42,
    "tk.conv2d_chain": 43,
    # float-side ops that may appear at graph boundaries
    "nn.conv2d": 64,
    "nn.dense": 65,
    "nn.batch_matmul": 66,
    "nn.softmax": 67,
    "nn.log_softmax": 68,
    "nn.batch_norm": 69,
    "nn.layer_norm": 70,
    "nn.conv2d_transpose": 71,
    "nn.leaky_relu": 72,
    "nn.gelu": 73,
    "nn.dropout": 74,
    "sigmoid": 75,
    "tanh": 76,
    "erf": 77,
    "nn.silu": 78,
    "nn.depth_to_space": 79,
    "nn.space_to_depth": 80,
    "image.resize2d": 81,
    "one_hot": 82,
    "take": 83,
    "gather": 84,
    "where": 85,
    "broadcast_to": 86,
    "tile": 87,
    "maximum": 88,
    "minimum": 89,
    "divide": 90,
    "power": 91,
    "sum": 92,
    "mean": 93,
    "max": 94,
    "min": 95,
    "argmax": 96,
    "nn.prelu": 97,
}


def op_id(op_name: str) -> int:
    v = OP_IDS.get(op_name)
    if v is not None:
        return v
    # stable fallback for ops outside the frozen vocabulary
    return (zlib.crc32(op_name.encode()) & 0x7FFFFFFF) | 0x80000000


def canonical_attrs(attrs: dict) -> bytes:
    def default(v):
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, tuple):
            return list(v)
        raise TypeError(f"bad attr {v!r}")

    return json.dumps(attrs, sort_keys=True, separators=(",", ":"), default=default).encode()


def _np_to_bytes(arr: np.ndarray) -> bytes:
    a = dt.c_contig(arr)
    if a.dtype == np.bool_:
        a = a.astype(np.uint8)
    return a.tobytes()


@dataclass
class TensorRecord:
    role: int
    dtype: str
    shape: tuple[int, ...]
    data: bytes

    @classmethod
    def from_array(cls, role: int, arr: np.ndarray) -> "TensorRecord":
        return cls(role, str(arr.dtype), tuple(arr.shape), _np_to_bytes(arr))

    def to_array(self) -> np.ndarray:
        npdt = np.uint8 if self.dtype == "bool" else np.dtype(self.dtype)
        a = np.frombuffer(self.data, dtype=npdt).reshape(self.shape)
        if self.dtype == "bool":
            a = a.astype(np.bool_)
        return a


@dataclass
class OpRecord:
    node_id: int
    name: str
    op_name: str
    attrs: dict
    tensors: list[TensorRecord]

    @property
    def inputs(self) -> list[TensorRecord]:
        return [t for t in self.tensors if t.role == ROLE_INPUT]

    @property
    def params(self) -> list[TensorRecord]:
        return [t for t in self.tensors if t.role == ROLE_PARAM]

    @property
    def output(self) -> TensorRecord:
        outs = [t for t in self.tensors if t.role == ROLE_OUTPUT]
        assert len(outs) >= 1
        return outs[0]

    def encode(self) -> bytes:
        buf = io.BytesIO()
        name_b = self.name.encode()
        op_b = self.op_name.encode()
        attrs_b = canonical_attrs(self.attrs)
        buf.write(struct.pack("<II", self.node_id, op_id(self.op_name)))
        buf.write(struct.pack("<H", len(name_b)))
        buf.write(name_b)
        buf.write(struct.pack("<H", len(op_b)))
        buf.write(op_b)
        buf.write(struct.pack("<I", len(attrs_b)))
        buf.write(attrs_b)
        buf.write(struct.pack("<H", len(self.tensors)))
        for t in self.tensors:
            buf.write(struct.pack("<BBB", t.role, DTYPE_CODES[t.dtype], len(t.shape)))
            for d in t.shape:
                buf.write(struct.pack("<I", d))
            buf.write(struct.pack("<Q", len(t.data)))
            buf.write(t.data)
        body = buf.getvalue()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        payload = body + struct.pack("<I", crc)
        return struct.pack("<Q", len(payload)) + payload

    @classmethod
    def decode(cls, payload: bytes) -> "OpRecord":
        body, crc_stored = payload[:-4], struct.unpack("<I", payload[-4:])[0]
        crc = zlib.crc32(body) & 0xFFFFFFFF
        if crc != crc_stored:
            raise TraceCorrupt(f"record CRC mismatch: {crc:#x} != {crc_stored:#x}")
        off = 0

        def take(fmt):
            nonlocal off
            sz = struct.calcsize(fmt)
            vals = struct.unpack_from(fmt, body, off)
            off += sz
            return vals

        node_id, _opid = take("<II")
        (nlen,) = take("<H")
        name = body[off : off + nlen].decode()
        off += nlen
        (olen,) = take("<H")
        op_name = body[off : off + olen].decode()
        off += olen
        (alen,) = take("<I")
        attrs = json.loads(body[off : off + alen].decode())
        off += alen
        (ntens,) = take("<H")
        tensors = []
        for _ in range(ntens):
            role, dcode, ndim = take("<BBB")
            dims = tuple(take(f"<{ndim}I")) if ndim else ()
            (dlen,) = take("<Q")
            data = body[off : off + dlen]
            off += dlen
            tensors.append(TensorRecord(role, DTYPE_NAMES[dcode], dims, data))
        return cls(node_id, name, op_name, attrs, tensors)


class TraceCorrupt(Exception):
    pass


class TraceWriter:
    """Streaming writer; see module docstring for layout."""

    def __init__(self, f: BinaryIO, graph_hash: bytes, meta: dict | None = None):
        assert len(graph_hash) == 32
        self.f = f
        self.graph_hash = graph_hash
        self.meta = canonical_attrs(meta or {})
        self.index: list[tuple[int, int]] = []
        self.num_records = 0
        self._crc = 0
        self._header_written = False
        self._offset = 0

    def _w(self, b: bytes):
        self.f.write(b)
        self._crc = zlib.crc32(b, self._crc) & 0xFFFFFFFF
        self._offset += len(b)

    def _write_header(self, num_records: int):
        self._w(MAGIC)
        self._w(struct.pack("<II", VERSION, 0))
        self._w(self.graph_hash)
        self._w(struct.pack("<Q", num_records))
        self._w(struct.pack("<I", len(self.meta)))
        self._w(self.meta)
        self._header_written = True

    def write(self, rec: OpRecord):
        if not self._header_written:
            raise RuntimeError("call begin(num_records) first")
        self.index.append((rec.node_id, self._offset))
        self._w(rec.encode())
        self.num_records += 1

    def begin(self, num_records: int):
        self._write_header(num_records)

    def finish(self):
        index_offset = self._offset
        for node_id, off in self.index:
            self._w(struct.pack("<IQ", node_id, off))
        self._w(struct.pack("<Q", index_offset))
        # file CRC covers everything written so far
        self.f.write(struct.pack("<I", self._crc))
        self.f.write(END_MAGIC)
        self.f.flush()


class TraceReader:
    def __init__(self, f: BinaryIO, verify_crc: bool = True):
        self.f = f
        data = f.read()
        if data[:8] != MAGIC:
            raise TraceCorrupt("bad magic")
        if data[-8:] != END_MAGIC:
            raise TraceCorrupt("bad end magic")
        (file_crc,) = struct.unpack_from("<I", data, len(data) - 12)
        body = data[: len(data) - 12]
        if verify_crc and (zlib.crc32(body) & 0xFFFFFFFF) != file_crc:
            raise TraceCorrupt("file CRC mismatch")
        (index_offset,) = struct.unpack_from("<Q", data, len(data) - 20)
        off = 8
        self.version, self.flags = struct.unpack_from("<II", data, off)
        off += 8
        self.graph_hash = data[off : off + 32]
        off += 32
        (self.num_records,) = struct.unpack_from("<Q", data, off)
        off += 8
        (mlen,) = struct.unpack_from("<I", data, off)
        off += 4
        self.meta = json.loads(data[off : off + mlen].decode()) if mlen else {}
        off += mlen
        self._data = data
        self._first_record = off
        self.index = []
        ioff = index_offset
        for _ in range(self.num_records):
            nid, roff = struct.unpack_from("<IQ", data, ioff)
            self.index.append((nid, roff))
            ioff += 12

    def record_at(self, file_offset: int) -> OpRecord:
        (rlen,) = struct.unpack_from("<Q", self._data, file_offset)
        payload = self._data[file_offset + 8 : file_offset + 8 + rlen]
        return OpRecord.decode(payload)

    def __iter__(self):
        for _, off in self.index:
            yield self.record_at(off)

    def __len__(self):
        return self.num_records

    def __getitem__(self, i: int) -> OpRecord:
        return self.record_at(self.index[i][1])
