"""ctypes binding to the native (C++) trace writer and verifier (port of
`tachikoma_tpu/trace/native.py`).

Record encoding, CRCs and file IO run in the repository's shared writer,
`native/trace_writer.cpp`, read as it is; Python only hands over raw
buffers.  The library is built at first use with
`g++ -O2 -shared -fPIC ... -lz` into `tachikoma_tpu_torch/_build/`
(git-ignored), under a name that carries a hash of the source, so an edited
source is rebuilt.  Output is byte-identical to `format.TraceWriter`; where
the library cannot be built, `native_available()` is False and the emitter
uses the Python writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils import dtypes as dt
from .format import DTYPE_CODES, TraceCorrupt, canonical_attrs, op_id

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "trace_writer.cpp"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib = None
_lib_error: str | None = None


def library_path() -> Path:
    """Where the shared library is built: `_build/`, named by a hash of the
    writer's source."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtktrace-{digest}.so"


def _compile() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE), "-lz"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, lib)
    return lib


def get_lib():
    """Load (building if needed) the writer; returns None if it cannot be
    built here."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            path = _compile()
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
            _lib_error = f"native build failed: {e}"
            return None
        lib = ctypes.CDLL(str(path))
        lib.tk_writer_open.restype = ctypes.c_void_p
        lib.tk_writer_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint32, ctypes.c_uint64,
        ]
        lib.tk_record_begin.restype = ctypes.c_int
        lib.tk_record_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint16,
            ctypes.c_char_p, ctypes.c_uint16,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint16,
        ]
        lib.tk_record_tensor.restype = ctypes.c_int
        lib.tk_record_tensor.argtypes = [
            ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p, ctypes.c_uint64,
        ]
        lib.tk_record_end.restype = ctypes.c_int
        lib.tk_record_end.argtypes = [ctypes.c_void_p]
        lib.tk_writer_finish.restype = ctypes.c_int
        lib.tk_writer_finish.argtypes = [ctypes.c_void_p]
        lib.tk_trace_verify.restype = ctypes.c_int64
        lib.tk_trace_verify.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


class NativeTraceWriter:
    """The streaming interface of format.TraceWriter, to a file path."""

    def __init__(self, path: str, graph_hash: bytes, meta: dict | None = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native trace writer unavailable: {_lib_error}")
        self._lib = lib
        self._meta = canonical_attrs(meta or {})
        self._path = str(path)
        self._graph_hash = graph_hash
        self._handle = None

    def begin(self, num_records: int):
        h = self._lib.tk_writer_open(
            self._path.encode(), self._graph_hash, self._meta, len(self._meta), num_records)
        if not h:
            raise OSError(f"cannot open trace file {self._path}")
        self._handle = h

    def _record(self, node_id: int, name: str, op_name: str, attrs: dict, tensors):
        """tensors: (role, dtype code, shape, address or bytes, nbytes) per
        tensor."""
        lib = self._lib
        name_b, op_b, attrs_b = name.encode(), op_name.encode(), canonical_attrs(attrs)
        rc = lib.tk_record_begin(self._handle, node_id, op_id(op_name), name_b, len(name_b),
                                 op_b, len(op_b), attrs_b, len(attrs_b), len(tensors))
        if rc != 0:
            raise RuntimeError(f"tk_record_begin failed: {rc}")
        for role, code, shape, ptr, nbytes in tensors:
            dims = (ctypes.c_uint32 * len(shape))(*shape)
            rc = lib.tk_record_tensor(self._handle, role, code, len(shape), dims, ptr, nbytes)
            if rc != 0:
                raise RuntimeError(f"tk_record_tensor failed: {rc}")
        rc = lib.tk_record_end(self._handle)
        if rc != 0:
            raise RuntimeError(f"tk_record_end failed: {rc}")

    def write(self, rec):
        """Write one format.OpRecord."""
        self._record(rec.node_id, rec.name, rec.op_name, rec.attrs,
                     [(t.role, DTYPE_CODES[t.dtype], t.shape, t.data, len(t.data))
                      for t in rec.tensors])

    def write_node(self, node_id: int, node, in_arrays, out_arrays):
        """Zero-copy record write: each (role, ndarray) buffer goes to the C
        writer as it is (no .tobytes() copies, no TensorRecord objects)."""
        arrays = []
        for role, arr in [*in_arrays, *out_arrays]:
            a = dt.c_contig(arr)
            if a.dtype == np.bool_:
                a, code = a.astype(np.uint8), DTYPE_CODES["bool"]
            else:
                code = DTYPE_CODES[str(a.dtype)]
            arrays.append((role, code, a))
        self._record(node_id, node.name, node.op, dict(node.attrs),
                     [(role, code, a.shape, a.ctypes.data, a.nbytes) for role, code, a in arrays])

    def finish(self):
        rc = self._lib.tk_writer_finish(self._handle)
        self._handle = None
        if rc != 0:
            raise OSError(f"tk_writer_finish failed: {rc}")


def native_verify(path: str) -> int:
    """CRC-verify a trace file natively; returns the record count.  Raises
    TraceCorrupt on any integrity failure."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native verifier unavailable: {_lib_error}")
    rc = lib.tk_trace_verify(str(path).encode())
    if rc < 0:
        reasons = {-1: "io error", -2: "bad magic", -3: "file CRC mismatch",
                   -4: "record CRC mismatch", -5: "malformed structure"}
        raise TraceCorrupt(f"{path}: {reasons.get(rc, rc)}")
    return int(rc)


def emit_trace_native(graph, inputs, path: str, backend: str = "torch", device="cuda",
                      meta: dict | None = None) -> int:
    """Trace emission that must use the native writer: `TraceEmitter.emit_to`,
    which raises here instead of falling back to the Python writer."""
    from .emitter import TraceEmitter

    if not native_available():
        raise RuntimeError(f"native trace writer unavailable: {_lib_error}")
    return TraceEmitter(graph, backend=backend, device=device, meta=meta).emit_to(inputs, path)
