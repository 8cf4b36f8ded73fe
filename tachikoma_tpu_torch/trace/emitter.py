"""Trace-emitting executor + trace verifier (port of
`tachikoma_tpu/trace/emitter.py`).

Execute the integer graph — on the numpy oracle, or on a torch device through
`TorchExecutor` or `SegmentedExecutor` with every node captured — and stream
per-operator records
(op id, attrs, input values, param values, expected output) into the
tachikoma-standard binary format (`format.py`).

Determinism: record order is the graph's topological node order; tensor bytes
are C-contiguous little-endian; integer records are byte-identical on every
backend, and equal to the JAX package's, because the integer op semantics are
bit-exact.  Float records (a dequantize head, a float softmax) agree within
rtol 1e-5, atol 1e-6.

On a CUDA device the captured tensors come to the host packed: each is viewed
as bytes on the device and concatenated, and the host slices views back out
of one pinned buffer, allocated once per emitter.  `emit_to` streams: it
packs about six node-aligned groups, copies each to the pinned buffer on a
side stream with one CUDA event per group, and writes the records of group i
while group i + 1 is still in flight.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import time
from typing import BinaryIO, Mapping

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, Node
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..runtime.executor import TorchExecutor
from ..runtime.interpreter import Interpreter
from .format import (ROLE_INPUT, ROLE_OUTPUT, ROLE_PARAM, OpRecord, TensorRecord, TraceReader,
                     TraceWriter)
from .native import NativeTraceWriter, native_available

BACKENDS = ("torch", "torch-segmented", "oracle")
STREAM_GROUPS = 6

_NP_DTYPES = {torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
              torch.uint8: np.dtype(np.uint8), torch.int16: np.dtype(np.int16),
              torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
              torch.float16: np.dtype(np.float16), torch.float32: np.dtype(np.float32),
              torch.float64: np.dtype(np.float64)}


def _graph_hash(graph: Graph) -> bytes:
    return hashlib.sha256(graph.structural_bytes(include_params=True)).digest()


def _computational(graph: Graph):
    return [n for n in graph.nodes if n.op not in (VAR, CONST, TUPLE, TUPLE_GET_ITEM)]


def _build_records(graph: Graph, values: dict[str, np.ndarray]):
    """Yield OpRecords in topological order given all node values."""
    for node_id, n in enumerate(graph.nodes):
        if n.op in (VAR, CONST, TUPLE, TUPLE_GET_ITEM):
            continue
        tensors = []
        for i in n.inputs:
            role = ROLE_PARAM if graph[i].is_const else ROLE_INPUT
            tensors.append(TensorRecord.from_array(role, np.asarray(values[i])))
        out = values[n.name]
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            tensors.append(TensorRecord.from_array(ROLE_OUTPUT, np.asarray(o)))
        yield OpRecord(node_id, n.name, n.op, dict(n.attrs), tensors)


def _flatten(names, outs):
    """(flat tensors, spec, node_end): spec is (name, index in the node's
    output list or None, numpy dtype, shape) per tensor, node-major;
    node_end[name] is the spec index just past the node's tensors."""
    flat, spec, node_end = [], [], {}
    for nm, o in zip(names, outs):
        items = list(enumerate(o)) if isinstance(o, (list, tuple)) else [(None, o)]
        for j, t in items:
            if not isinstance(t, torch.Tensor) or t.dtype not in _NP_DTYPES:
                raise TypeError(f"{nm}: cannot pack a captured "
                                f"{getattr(t, 'dtype', type(t).__name__)}")
            flat.append(t)
            spec.append((nm, j, _NP_DTYPES[t.dtype], tuple(t.shape)))
        node_end[nm] = len(spec)
    return flat, spec, node_end


def _nbytes(dtype: np.dtype, shape) -> int:
    # scalars () contribute 1 element; zero-element shapes contribute 0 bytes
    return (int(np.prod(shape)) if shape else 1) * dtype.itemsize


def _pack(tensors, device) -> torch.Tensor:
    """One uint8 tensor on `device`: the bytes of every tensor, in order."""
    if not tensors:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _slice(buf: np.ndarray, spec, values: dict) -> None:
    """Cut the packed host bytes `buf` of `spec`'s tensors back into views."""
    off = 0
    for nm, j, dtype, shape in spec:
        nbytes = _nbytes(dtype, shape)
        arr = buf[off:off + nbytes].view(dtype).reshape(shape)
        off += nbytes
        if j is None:
            values[nm] = arr
        else:
            values.setdefault(nm, []).append(arr)


def _pack_groups(spec, node_end, names, chunks: int):
    """Contiguous spec-index ranges of about equal byte volume, cut at node
    boundaries."""
    prefix = list(itertools.accumulate((_nbytes(d, s) for _, _, d, s in spec), initial=0))
    goal = max(prefix[-1] // max(chunks, 1), 1)
    cuts = []
    for nm in names:
        end = node_end[nm]
        if prefix[end] >= goal * (len(cuts) + 1) and end < len(spec):
            cuts.append(end)
    bounds = [0] + cuts + [len(spec)]
    return [(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if lo < hi]


class TraceEmitter:
    """Emit a trace for (graph, inputs) with the numpy oracle or with
    `TorchExecutor` on `device`.

    backend="torch" (the default) runs the unfused graph on `device` ("cuda"
    by default: with no card it raises; pass device="cpu" for the CPU) with
    every computational node captured; backend="torch-segmented" runs it
    through `runtime/segmented.py SegmentedExecutor` (one program per
    structural key, no scan: every node is captured), the counterpart of the
    JAX package's "jax-segmented"; backend="oracle" runs the numpy
    interpreter.  Every backend writes the same bytes."""

    def __init__(self, graph: Graph, backend: str = "torch", device="cuda",
                 meta: dict | None = None, require_integer: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: the port has {BACKENDS}")
        self.graph = infer_types(graph) if any(
            n.shape is None and n.dtype != "tuple" for n in graph.nodes) else graph
        self.backend = backend
        self.meta = dict(meta or {})
        self.last_timings: dict = {}
        self._names = [n.name for n in _computational(self.graph)]
        self._executor = None
        self._pinned: torch.Tensor | None = None
        self._copy_stream = None
        # ZKP-consumer mode: integer records are byte-exact, float-tail
        # records (dequantize head, float softmax) verify with allclose only;
        # require_integer rejects graphs that would emit any float record.
        if require_integer:
            floaty = [n.name for n in _computational(self.graph)
                      if str(n.dtype).startswith(("float", "bfloat"))]
            if floaty:
                raise ValueError(
                    "require_integer: graph has float computational nodes "
                    f"(first 8: {floaty[:8]}); quantize with integer_softmax"
                    "/lut_ops and dequantize_outputs=False for a fully "
                    "bitwise-pinned trace")
            self.meta.setdefault("integer_only", True)
        if backend == "torch":
            self._executor = TorchExecutor(self.graph, capture=self._names, device=device,
                                           fuse=False)
        elif backend == "torch-segmented":
            from ..runtime.segmented import SegmentedExecutor

            self._executor = SegmentedExecutor(self.graph, capture=self._names, device=device)
        self.device = self._executor.device if self._executor else torch.device("cpu")

    # -- values ---------------------------------------------------------------

    def _values(self, inputs) -> dict:
        if self.backend == "oracle":
            return self._values_oracle(inputs)
        return self._values_torch(inputs)

    def _values_oracle(self, inputs) -> dict[str, np.ndarray]:
        values: dict[str, np.ndarray] = {}

        def hook(name, op, args, out):
            values[name] = out

        Interpreter(self.graph).run(self._feeds(inputs), intercept=hook)
        self._fill_structural(values, inputs)
        return values

    def _feeds(self, inputs) -> dict[str, np.ndarray]:
        g = self.graph
        if isinstance(inputs, (np.ndarray, torch.Tensor)):
            inputs = [inputs]
        if not isinstance(inputs, Mapping):
            inputs = dict(zip([n.name for n in g.inputs], inputs))
        feeds = {}
        for n in g.inputs:
            v = inputs[n.name]
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            feeds[n.name] = v.astype(n.dtype) if str(v.dtype) != n.dtype else v
        return feeds

    def _fill_structural(self, values, inputs):
        g = self.graph
        values.update(self._feeds(inputs))
        for n in g.nodes:
            if n.op == CONST:
                values[n.name] = g.params[n.name]
            elif n.op == TUPLE:
                values[n.name] = [values[i] for i in n.inputs]
            elif n.op == TUPLE_GET_ITEM:
                values[n.name] = values[n.inputs[0]][int(n.attrs["index"])]

    def _values_torch(self, inputs) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        outs = self._executor.run_device(inputs)
        t1 = time.perf_counter()
        values = self._fetch_packed(outs)
        self.last_timings = {"dispatch_s": t1 - t0, "fetch_s": time.perf_counter() - t1}
        self._fill_structural(values, inputs)
        return values

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        """The pinned host buffer, grown only when a trace needs more."""
        if self._pinned is None or self._pinned.numel() < nbytes:
            self._pinned = None
            self._pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self._pinned

    def _fetch_packed(self, outs) -> dict[str, np.ndarray]:
        """Every captured tensor in one device-to-host copy: a device-side
        byte pack, copied once into the pinned buffer, sliced into views."""
        spec, groups, bufs, events = self._stream_groups(outs, 1)
        values: dict = {}
        for (lo, hi), buf, ev in zip(groups, bufs, events):
            if ev is not None:
                ev.synchronize()
            _slice(buf, spec[lo:hi], values)
        return values

    # -- emission -------------------------------------------------------------

    def emit(self, inputs, f: BinaryIO) -> int:
        """Write a trace for one batch of inputs; returns the record count."""
        values = self._values(inputs)
        w = TraceWriter(f, _graph_hash(self.graph), self.meta)
        w.begin(len(self._names))
        for rec in _build_records(self.graph, values):
            w.write(rec)
        w.finish()
        return len(self._names)

    def emit_bytes(self, inputs) -> bytes:
        buf = io.BytesIO()
        self.emit(inputs, buf)
        return buf.getvalue()

    def _stream_groups(self, outs, chunks: int):
        """(spec, groups, host buffers, events): the captured tensors packed
        in about `chunks` node-aligned groups; on CUDA each group's copy to
        the pinned buffer is queued on a side stream, with an event to wait
        on."""
        flat, spec, node_end = _flatten(self._names, outs)
        groups = _pack_groups(spec, node_end, self._names, chunks)
        packed = [_pack(flat[lo:hi], self.device) for lo, hi in groups]
        if self.device.type == "cpu":
            return spec, groups, [p.numpy() for p in packed], [None] * len(packed)
        host = self._host_buffer(sum(p.numel() for p in packed))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        bufs, events, off = [], [], 0
        with torch.cuda.stream(side):
            for p in packed:
                p.record_stream(side)  # its memory is not reused before the copy ends
                dst = host[off:off + p.numel()]
                dst.copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
                bufs.append(dst.numpy())
                events.append(ev)
                off += p.numel()
        return spec, groups, bufs, events

    def emit_to(self, inputs, path: str) -> int:
        """Write a trace file, streaming: the records of one packed group are
        written while the next group is still being copied to the host.  The
        native (C++) writer is used where it builds, else the Python writer
        (the same bytes); `last_timings["writer"]` says which."""
        g = self.graph
        values: dict = {}
        if self.backend == "oracle":
            values = self._values_oracle(inputs)
            t_dispatch, spec, groups, bufs, events = 0.0, [], [(0, 0)], [None], [None]
        else:
            t0 = time.perf_counter()
            outs = self._executor.run_device(inputs)
            t_dispatch = time.perf_counter() - t0
            spec, groups, bufs, events = self._stream_groups(outs, STREAM_GROUPS)
            values.update(self._feeds(inputs))
            values.update((n.name, g.params[n.name]) for n in g.consts)
        fetched_bytes = sum(b.nbytes for b in bufs if b is not None)

        f = None
        if native_available():
            w, writer = NativeTraceWriter(path, _graph_hash(g), self.meta), "native"
            write_node = w.write_node
        else:
            f = open(path, "wb")
            w, writer = TraceWriter(f, _graph_hash(g), self.meta), "python"

            def write_node(node_id, n, ins, outs_):
                w.write(OpRecord(node_id, n.name, n.op, dict(n.attrs),
                                 [TensorRecord.from_array(r, a) for r, a in [*ins, *outs_]]))
        try:
            w.begin(len(self._names))
            node_iter = iter(enumerate(g.nodes))
            pending = None

            def write_ready():
                """Write records in node order until one whose value has not
                arrived yet."""
                nonlocal pending
                while True:
                    node_id, n = pending or next(node_iter, (None, None))
                    pending = None
                    if n is None:
                        return
                    if n.op in (VAR, CONST):
                        continue
                    if n.op == TUPLE:
                        if any(i not in values for i in n.inputs):
                            pending = (node_id, n)
                            return
                        values[n.name] = [values[i] for i in n.inputs]
                        continue
                    if n.op == TUPLE_GET_ITEM:
                        if n.inputs[0] not in values:
                            pending = (node_id, n)
                            return
                        values[n.name] = values[n.inputs[0]][int(n.attrs["index"])]
                        continue
                    if n.name not in values:
                        pending = (node_id, n)
                        return
                    ins = [(ROLE_PARAM if g[i].is_const else ROLE_INPUT, np.asarray(values[i]))
                           for i in n.inputs]
                    out = values[n.name]
                    outs_ = [(ROLE_OUTPUT, np.asarray(o))
                             for o in (out if isinstance(out, (list, tuple)) else [out])]
                    write_node(node_id, n, ins, outs_)

            group_waits, group_walks = [], []
            for (lo, hi), buf, ev in zip(groups, bufs, events):
                t1 = time.perf_counter()
                if ev is not None:
                    ev.synchronize()
                group_waits.append(time.perf_counter() - t1)
                if buf is not None:
                    _slice(buf, spec[lo:hi], values)
                t2 = time.perf_counter()
                write_ready()
                group_walks.append(time.perf_counter() - t2)
            t3 = time.perf_counter()
            w.finish()
            t_finish = time.perf_counter() - t3
        finally:
            if f is not None:
                f.close()
        self.last_timings = {"dispatch_s": t_dispatch, "fetch_s": sum(group_waits),
                             "serialize_s": sum(group_walks) + t_finish,
                             "fetched_bytes": fetched_bytes, "group_waits": group_waits,
                             "group_walks": group_walks, "writer": writer}
        return len(self._names)


def emit_trace(graph: Graph, inputs, path: str | None = None, backend: str = "torch",
               device="cuda", meta: dict | None = None,
               require_integer: bool = False) -> bytes | int:
    """The trace of (graph, inputs): its bytes, or, with `path`, its record
    count after writing it there."""
    em = TraceEmitter(graph, backend=backend, device=device, meta=meta,
                      require_integer=require_integer)
    if path is None:
        return em.emit_bytes(inputs)
    return em.emit_to(inputs, path)


def verify_trace(trace: bytes | str, graph: Graph | None = None) -> dict:
    """Re-execute every record with the numpy oracle and compare its output
    (integers ==, floats allclose rtol 1e-5, atol 1e-6): the fake trace
    consumer, in the role of a ZKP circuit's witness check.

    Returns {'records': N, 'verified': N_ok, 'mismatches': [(name, why)]}.
    """
    if isinstance(trace, str):
        with open(trace, "rb") as f:
            reader = TraceReader(f)
    else:
        reader = TraceReader(io.BytesIO(trace))

    if graph is not None and _graph_hash(graph) != reader.graph_hash:
        raise ValueError("trace graph hash does not match supplied graph")

    mismatches = []
    n_ok = 0
    for rec in reader:
        op = get_op(rec.op_name)
        if op.np_impl is None:
            mismatches.append((rec.name, "no oracle impl"))
            continue
        args = [t.to_array() for t in rec.tensors if t.role in (ROLE_INPUT, ROLE_PARAM)]
        shadow = Node(rec.name, rec.op_name, tuple(f"i{k}" for k in range(len(args))),
                      {k: tuple(v) if isinstance(v, list) else v for k, v in rec.attrs.items()})
        try:
            out = op.np_impl(*args, node=shadow)
        except Exception as e:  # a record the oracle cannot run is reported, not raised
            mismatches.append((rec.name, f"exec error: {e}"))
            continue
        want = rec.output.to_array()
        got = np.asarray(out[0] if isinstance(out, (list, tuple)) else out)
        if want.dtype.kind in "fc":
            ok = np.allclose(got.astype(np.float64), want.astype(np.float64),
                             rtol=1e-5, atol=1e-6)
        else:
            ok = got.shape == want.shape and bool((got == want).all())
        if ok:
            n_ok += 1
        else:
            mismatches.append((rec.name, "output mismatch"))
    return {"records": len(reader), "verified": n_ok, "mismatches": mismatches}
