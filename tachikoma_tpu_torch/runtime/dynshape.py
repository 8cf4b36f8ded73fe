"""Dispatch-time specialization for data-dependent shapes (port of
`tachikoma_tpu/runtime/dynshape.py`).

A graph whose output shape depends on a tensor VALUE (`dyn.reshape` of an
input shape, `dyn.topk` of an input k) has no static form until the value
is known.  At dispatch time `DynShapeExecutor`

  1. evaluates each dyn op's shape-feeding subgraph with the port's numpy
     oracle on the request's inputs (`_eval_subset`: the shape inputs and
     their ancestors only, read to the host), which gives the key: the
     dyn nodes' names with their folded values, the JAX package's key;
  2. on a miss, rewrites every dyn op into its static twin through the
     fold registry the oracle and the torch impls share (`specialize`,
     ops/dyn.py `DYN_FOLDERS`), infers the static graph's types and builds
     a `TorchExecutor` of it, which it keeps under the key;
  3. on a hit, runs the kept executor: no fold, no type inference, no
     executor build.

Every specialization's executor shares one device copy of the graph's
parameters, made at construction: however many keys were seen, the card
holds each weight once, and a kernel's packed weight (K1-K4 pack each
weight tensor once, keyed by the tensor) is packed at the first request
for all of them.

Bounded dyn ops (`dyn.nonzero`) need no specialization: their padded
outputs are static, and a graph with no other dyn op runs as it is.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..ops.dyn import DYN_FOLDERS, fold_to_static, to_host
from .executor import TorchExecutor, resolve_device, to_device


def has_dynamic_shapes(graph: Graph) -> bool:
    return any(n.op in DYN_FOLDERS for n in graph.nodes)


def _eval_subset(graph: Graph, targets: set, feeds: dict) -> dict:
    """Oracle-evaluate only `targets` and their ancestors."""
    need: set = set()
    stack = list(targets)
    while stack:
        nm = stack.pop()
        if nm in need:
            continue
        need.add(nm)
        stack.extend(graph[nm].inputs)
    env: dict = {}
    for n in graph.nodes:
        if n.name not in need:
            continue
        if n.op == VAR:
            env[n.name] = to_host(feeds[n.name])
        elif n.op == CONST:
            env[n.name] = graph.params[n.name]
        elif n.op == TUPLE:
            env[n.name] = [env[i] for i in n.inputs]
        elif n.op == TUPLE_GET_ITEM:
            env[n.name] = env[n.inputs[0]][int(n.attrs["index"])]
        else:
            env[n.name] = get_op(n.op).np_impl(*[env[i] for i in n.inputs], node=n)
    return {t: env[t] for t in targets}


def _feeds(graph: Graph, inputs) -> dict:
    if isinstance(inputs, (np.ndarray, torch.Tensor)):
        inputs = [inputs]
    if not isinstance(inputs, dict):
        inputs = dict(zip([n.name for n in graph.inputs], inputs))
    return inputs


def _shape_sources(graph: Graph) -> set:
    return {n.inputs[p] for n in graph.nodes if n.op in DYN_FOLDERS
            for p in DYN_FOLDERS[n.op][0]}


def _key(graph: Graph, vals: dict) -> tuple:
    """The JAX package's key: (dyn node, folded values) in graph order."""
    return tuple((n.name, tuple(tuple(np.asarray(vals[n.inputs[p]]).ravel().tolist())
                                for p in DYN_FOLDERS[n.op][0]))
                 for n in graph.nodes if n.op in DYN_FOLDERS)


def _fold(graph: Graph, vals: dict) -> Graph:
    """Every dyn node replaced by its static twin, dead code removed (the
    shape-feeding nodes die when nothing else reads them)."""
    nodes = [fold_to_static(n, [vals[n.inputs[p]] for p in DYN_FOLDERS[n.op][0]])[0]
             if n.op in DYN_FOLDERS else n for n in graph.nodes]
    return Graph(nodes, list(graph.outputs), dict(graph.params),
                 graph.name).dead_code_eliminate()


def specialize(graph: Graph, inputs) -> tuple[Graph, tuple]:
    """(static graph, shape key) for the concrete `inputs`: every dyn.* node
    becomes its STATIC twin through the fold registry it shares with the
    oracle and torch impls (`ops/dyn.py DYN_FOLDERS`)."""
    if not has_dynamic_shapes(graph):
        return graph, ()
    vals = _eval_subset(graph, _shape_sources(graph), _feeds(graph, inputs))
    return infer_types(_fold(graph, vals)), _key(graph, vals)


class DynShapeExecutor:
    """Run a graph with dyn.* shape-from-tensor ops by per-key
    specialization, one cached executor per key.

    backend "torch" runs each specialization with `TorchExecutor` on
    `device` ("cuda" by default: with no card present it raises, as
    `resolve_device` does); backend "oracle" runs it with the numpy
    interpreter.  `misses` and `hits` count the requests; `miss_seconds` holds each
    miss's host seconds for the fold, the type inference and the executor
    build."""

    def __init__(self, graph: Graph, backend: str = "torch", device="cuda"):
        if backend not in ("torch", "oracle"):
            raise ValueError(f"DynShapeExecutor: backend {backend!r} is not 'torch' or 'oracle'")
        self.graph = graph
        self.backend = backend
        self.device = resolve_device(device, "DynShapeExecutor") if backend == "torch" else None
        self._sources = _shape_sources(graph)
        # one device copy of the parameters, shared by every specialization
        self._params = {} if self.device is None else {
            k: to_device(v, self.device) for k, v in graph.params.items()}
        self._cache: dict = {}
        self.misses = self.hits = 0
        self.miss_seconds: list[dict] = []

    def entry(self, inputs):
        """(the key's cached executor or static graph, feeds), built on a miss."""
        feeds = _feeds(self.graph, inputs)
        vals = _eval_subset(self.graph, self._sources, feeds) if self._sources else {}
        key = _key(self.graph, vals)
        entry = self._cache.get(key)
        if entry is not None:
            self.hits += 1
            return entry, feeds
        self.misses += 1
        t0 = time.perf_counter()
        g = _fold(self.graph, vals) if self._sources else self.graph
        t1 = time.perf_counter()
        g = infer_types(g)
        t2 = time.perf_counter()
        entry = g if self.backend == "oracle" else TorchExecutor(
            g, device=self.device, params=self._params)
        t3 = time.perf_counter()
        self.miss_seconds.append({"fold": t1 - t0, "infer": t2 - t1, "build": t3 - t2})
        self._cache[key] = entry
        return entry, feeds

    def run_device(self, inputs) -> list[torch.Tensor]:
        """Run and return tensors on the device (backend "torch")."""
        entry, feeds = self.entry(inputs)
        return entry.run_device(feeds)

    def run(self, inputs) -> list[np.ndarray]:
        entry, feeds = self.entry(inputs)
        if self.backend == "oracle":
            from .interpreter import run_graph

            return run_graph(entry, {k: to_host(v) for k, v in feeds.items()})
        return entry.run(feeds)
