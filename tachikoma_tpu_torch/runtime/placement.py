"""Per-op heterogeneous device placement (port of
`tachikoma_tpu/runtime/placement.py`).

A node opts into a device with the node attr ``device=<int>`` (set at build
time via ``GraphBuilder.annotate`` or by a transform).  ``plan_devices``
propagates the annotations to every node; ``HeterogeneousExecutor`` splits
the graph into maximal same-device segments, runs each segment's nodes
through their torch impls on its torch device, and moves boundary tensors
with ``Tensor.to`` -- transfers are explicit and counted.

Device ids index a list of torch devices: by default the visible CUDA
devices (none visible raises), or what the caller passes, e.g.
``("cuda:0", "cpu")``, the CPU-offload layout (embedding tables on the host),
or ``("cpu",) * n`` on a machine without a card.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..utils import dtypes as dt
from .executor import check_torch_impls, graph_feeds, resolve_device


def plan_devices(graph: Graph, default_device: int = 0) -> dict[str, int]:
    """Propagate ``device`` annotations to a total per-node assignment.

    Rules (mirroring the reference's DeviceDomain unification defaults):
      * an annotated node keeps its device;
      * an unannotated node inherits the device of its first annotated
        input (computation stays where its data is);
      * vars/consts with no annotated consumer land on ``default_device``;
      * remaining nodes get ``default_device``.
    """
    assign: dict[str, int] = {}
    for n in graph.nodes:
        d = n.attrs.get("device") if n.attrs else None
        if d is not None:
            assign[n.name] = int(d)
    # forward inheritance: computation follows annotated producers
    for n in graph.nodes:
        if n.name in assign:
            continue
        for i in n.inputs:
            if i in assign:
                assign[n.name] = assign[i]
                break
    # backward: vars/consts follow their first assigned consumer
    users = graph.users()
    for n in graph.nodes:
        if n.name in assign:
            continue
        if n.op in (VAR, CONST):
            for u in users.get(n.name, ()):
                if u in assign:
                    assign[n.name] = assign[u]
                    break
    for n in graph.nodes:
        assign.setdefault(n.name, default_device)
    return assign


def _segments(graph: Graph, plan: Mapping[str, int]) -> list[tuple[int, list]]:
    """Topological split into maximal contiguous same-device runs.

    graph.nodes is already topological; a segment closes when the device
    changes.  Vars/consts are bound as segment inputs."""
    segs: list[tuple[int, list]] = []
    cur_dev, cur = None, []
    for n in graph.nodes:
        if n.op in (VAR, CONST):
            continue
        d = plan[n.name]
        if cur_dev is None or d == cur_dev:
            cur_dev = d
            cur.append(n)
        else:
            segs.append((cur_dev, cur))
            cur_dev, cur = d, [n]
    if cur:
        segs.append((cur_dev, cur))
    return segs


def _on(v, dev: torch.device):
    return [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)


def _indexed(dev: torch.device) -> torch.device:
    """"cuda" as the current CUDA device's index ("cuda:0"), which is what a
    tensor's `.device` says."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_cuda_devices() -> list[torch.device]:
    """The visible CUDA devices, in index order; none visible raises."""
    resolve_device("cuda", "HeterogeneousExecutor")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class HeterogeneousExecutor:
    """Executes a Graph across several torch devices per a placement plan.

    Each segment runs its nodes' torch impls on its device; values crossing a
    segment boundary are moved to the consumer's device with ``Tensor.to``
    (``transfers`` counts them on the last run, by index into ``devices``,
    so two entries naming one torch device still count as two; graph
    inputs, fed from the host, are not counted).  The result is bit-identical to the
    single-device executor on integer graphs (same op impls, same order) --
    only placement and transfers differ."""

    def __init__(self, graph: Graph, plan: Mapping[str, int] | None = None,
                 devices: Sequence | None = None, default_device: int = 0):
        g = graph
        if any(n.shape is None and n.dtype != "tuple" for n in g.nodes):
            g = infer_types(g)
        check_torch_impls(g)
        self.graph = g
        self.plan = dict(plan) if plan is not None else plan_devices(g, default_device)
        self.devices = ([_indexed(resolve_device(d, "HeterogeneousExecutor")) for d in devices]
                        if devices is not None else visible_cuda_devices())
        self.segments = _segments(g, self.plan)
        self.transfers = 0  # boundary tensors moved on the last run
        self._var_names = [n.name for n in g.inputs]

        self._const_vals = {
            n.name: torch.from_numpy(np.array(dt.c_contig(g.params[n.name]))).to(
                self.devices[self._slot(self.plan[n.name])])
            for n in g.nodes if n.op == CONST}

        # per segment: (device, input names, [(node, impl)])
        self._compiled = []
        for dev_id, nodes in self.segments:
            names = {n.name for n in nodes}
            need: list[str] = []
            for n in nodes:
                for i in n.inputs:
                    if i not in names and i not in need:
                        need.append(i)
            steps = [(n, None if n.op in (TUPLE, TUPLE_GET_ITEM) else get_op(n.op).torch_impl)
                     for n in nodes]
            self._compiled.append((self._slot(dev_id), need, steps))

    def _slot(self, dev_id: int) -> int:
        """The index into `devices` of device id `dev_id`."""
        return dev_id % len(self.devices)

    def run_device(self, inputs) -> list:
        """Run; each output stays on the device of the node that made it."""
        feeds = graph_feeds(self.graph, self._var_names, inputs, "cpu")
        env: dict[str, Any] = dict(self._const_vals)
        slot = {k: self._slot(self.plan[k]) for k in self._const_vals}
        self.transfers = 0
        for dev_slot, need, steps in self._compiled:
            dev = self.devices[dev_slot]
            local: dict[str, Any] = {}
            for i in need:
                if i in feeds:
                    local[i] = feeds[i].to(dev)
                elif slot[i] != dev_slot:
                    local[i] = _on(env[i], dev)
                    self.transfers += 1
                else:
                    local[i] = env[i]
            for node, impl in steps:
                if node.op == TUPLE:
                    local[node.name] = [local[i] for i in node.inputs]
                elif node.op == TUPLE_GET_ITEM:
                    local[node.name] = local[node.inputs[0]][int(node.attrs["index"])]
                else:
                    local[node.name] = impl(*[local[i] for i in node.inputs], node=node)
                env[node.name], slot[node.name] = local[node.name], dev_slot
        return [env[o] for o in self.graph.outputs]

    def run(self, inputs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self.run_device(inputs)]


def embeddings_on_host(graph: Graph, host: int = 1, device: int = 0) -> Graph:
    """`graph` with its embedding lookups (`take`) annotated to device id
    `host` and each node that reads one back on `device`: the CPU-offload
    layout of an embedding table, with `devices=("cuda:0", "cpu")`."""
    takes = {n.name for n in graph.nodes if n.op == "take"}
    nodes = []
    for n in graph.nodes:
        if n.name in takes:
            n = n.with_(attrs={**n.attrs, "device": host})
        elif any(i in takes for i in n.inputs):
            n = n.with_(attrs={**n.attrs, "device": device})
        nodes.append(n)
    return Graph(nodes, list(graph.outputs), dict(graph.params), graph.name)
