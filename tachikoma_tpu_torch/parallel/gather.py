"""Deterministic multi-rank trace gather (port of
`tachikoma_tpu/parallel/gather.py`).

  * the model runs over the mesh (ShardedExecutor), every rank on its slices;
  * every captured node value comes back GLOBAL (the executor gathers it over
    'tp' and 'dp');
  * only the coordinator (rank 0) writes the trace, iterating records in
    topological node order — so the bytes are identical to a single-device
    emission regardless of mesh shape or rank count;
  * every step is wrapped in retry-with-backoff (the failure-detection role
    the JAX package gives the same helper).
"""

from __future__ import annotations

import hashlib
import io
import time
from typing import BinaryIO

import numpy as np
import torch
import torch.distributed as dist

from ..ir.graph import Graph
from ..runtime.executor import computational_nodes
from ..trace.emitter import TraceEmitter, _build_records, _graph_hash
from ..trace.format import TraceWriter
from ..utils.logging import get_logger
from .mesh import Mesh
from .shard import ShardedExecutor

log = get_logger("gather")


def _with_retry(fn, what: str, retries: int = 3, backoff: float = 0.5):
    last = None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:  # retried, then re-raised with its cause
            last = e
            log.warning("gather step %s failed (attempt %d/%d): %s",
                        what, attempt + 1, retries, e)
            time.sleep(backoff * (2 ** attempt))
    raise RuntimeError(f"gather step {what} failed after {retries} attempts") from last


def global_array(x) -> np.ndarray:
    """A value on the host: the sharded executor's captured values are
    global already, so this only copies a device tensor back."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class ShardedTraceEmitter:
    """Trace emission from a sharded (dp x tp) run.

    Bytes are identical to TraceEmitter's single-device output for the same
    (graph, inputs): sharding is invisible in the trace."""

    def __init__(self, graph: Graph, mesh: Mesh, meta: dict | None = None,
                 param_specs=None, input_specs=None):
        self.graph = graph
        self.meta = dict(meta or {})
        self._names = computational_nodes(graph)
        self._ex = ShardedExecutor(graph, mesh, capture=self._names,
                                   param_specs=param_specs, input_specs=input_specs)

    def values(self, inputs) -> dict:
        """Every node's global value on the host (the structural ones too)."""
        return self._host_values(self._run(inputs), inputs)

    def _run(self, inputs) -> list:
        return _with_retry(lambda: self._ex.run_device(inputs), "execute")

    def _host_values(self, outs, inputs) -> dict:
        values = {}
        for name, val in zip(self._names, outs):
            values[name] = _with_retry(lambda v=val: global_array(v), f"gather:{name}")
        em = TraceEmitter(self._ex.graph, backend="oracle", meta=self.meta)
        em._fill_structural(values, inputs)
        return values

    def emit(self, inputs, f: BinaryIO | None) -> dict:
        """Run sharded, gather deterministically, write on the coordinator.

        Returns a manifest {records, bytes, chunk_hashes} on the coordinator
        (chunk_hashes = per-record sha256 — the content-addressed integrity
        index); other ranks get {'records': N} only (every value reached
        them inside the run: they copy none to the host)."""
        outs = self._run(inputs)
        if not is_coordinator():
            return {"records": len(self._names)}
        if f is None:
            raise ValueError("the coordinator needs an output stream")
        values = self._host_values(outs, inputs)
        w = TraceWriter(f, _graph_hash(self._ex.graph), self.meta)
        w.begin(len(self._names))
        hashes = []
        n_bytes = 0
        for rec in _build_records(self._ex.graph, values):
            enc = rec.encode()
            hashes.append(hashlib.sha256(enc).hexdigest())
            n_bytes += len(enc)
            w.write(rec)
        w.finish()
        return {"records": len(self._names), "bytes": n_bytes, "chunk_hashes": hashes}

    def emit_bytes(self, inputs) -> bytes:
        buf = io.BytesIO()
        self.emit(inputs, buf)
        return buf.getvalue()


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize the default process group over gloo (the JAX package's
    `jax.distributed.initialize`): `coordinator` is "host:port" or a torch
    init method ("tcp://host:port", "file:///path"); a mesh's subgroups name
    their own backend (mesh.simple_mesh).  A group of one process is made
    too.  No-op when already initialized or without a coordinator."""
    if coordinator is None or dist.is_initialized():
        return
    method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=method, world_size=num_processes or 1,
                            rank=process_id or 0)


def _rank_main(rank: int, world: int, init_method: str, fn, args, results):
    init_distributed(init_method, world, rank)
    try:
        results.put((rank, fn(rank, world, *args)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(world: int, fn, args=(), *, init_method: str, timeout: float = 600.0) -> list:
    """Run `fn(rank, world, *args)` in `world` spawned processes that share
    the default process group over gloo (init_distributed; `init_method`:
    "localhost:port", "tcp://localhost:port" or a "file://" store); returns each rank's result, in rank order.  `fn` and its
    arguments and result must pickle.  Raises if a rank fails or the run
    outlasts `timeout` seconds; every process is ended before it returns."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, init_method, fn, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, res = results.get(timeout=1.0)
                got[rank] = res
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"launch: a rank exited with code {dead[0]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {world} ranks outlasted {timeout} s")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
