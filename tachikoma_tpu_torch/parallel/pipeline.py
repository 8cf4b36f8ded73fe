"""Pipeline-parallel inference executor (port of
`tachikoma_tpu/parallel/pipeline.py`).

A model splits into stages of about equal FLOPs over the topological order
(`split_stages`, the JAX package's stages from the same FLOPs); microbatches
stream through them.  JAX overlaps stage i of microbatch m with stage i+1 of
microbatch m-1 through asynchronous dispatch; here each stage runs on its
own CUDA stream, and an event orders stage s+1 after stage s for each
microbatch, so the card may run stage s of microbatch m while stage s+1
works on microbatch m-1.  `devices` may repeat a device (stages on one card
overlap on their streams).  On the CPU the stages run in order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, GraphBuilder
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..runtime.bucketed import with_batch
from ..runtime.executor import TorchExecutor, resolve_device


@dataclass
class Stage:
    graph: Graph
    inputs: list[str]     # names (in original graph) this stage consumes
    outputs: list[str]    # names (in original graph) this stage produces


def _node_flops(g: Graph, node) -> int:
    od = get_op(node.op) if node.op not in (VAR, CONST, TUPLE, TUPLE_GET_ITEM) else None
    if od is None or od.flops is None:
        return 1
    try:
        in_types = [(g[i].shape, g[i].dtype) for i in node.inputs]
        return max(int(od.flops(node, in_types)), 1)
    except Exception:  # an op whose count does not apply to these types costs 1
        return 1


def split_stages(graph: Graph, num_stages: int) -> list[Stage]:
    """Partition the graph into contiguous (topological) stages of roughly
    equal FLOPs.  Constants replicate into the stage that uses them."""
    g = infer_types(graph) if any(n.shape is None and n.dtype != "tuple" for n in graph.nodes) else graph
    comp = [n for n in g.nodes if n.op not in (VAR, CONST)]
    flops = [_node_flops(g, n) for n in comp]
    total = sum(flops)
    target = total / num_stages

    # assign each computational node a stage id
    stage_of: dict[str, int] = {}
    acc, sid = 0, 0
    for n, f in zip(comp, flops):
        # close the stage when its budget is met (keep at least one node)
        if acc >= target * (sid + 1) and sid < num_stages - 1:
            sid += 1
        acc += f
        stage_of[n.name] = sid
    num_stages = sid + 1

    stages: list[Stage] = []
    produced_by: dict[str, int] = {}
    for n in g.nodes:
        if n.op == VAR:
            produced_by[n.name] = -1
        elif n.op == CONST:
            produced_by[n.name] = -2  # replicated
        else:
            produced_by[n.name] = stage_of[n.name]

    users = g.users()
    for s in range(num_stages):
        b = GraphBuilder(f"{g.name}_stage{s}")
        mapping: dict[str, str] = {}
        stage_inputs: list[str] = []
        stage_outputs: list[str] = []
        for n in g.nodes:
            owner = produced_by[n.name]
            if owner != s:
                continue  # vars/consts materialize on demand at use sites
            # materialize inputs
            ins = []
            for i in n.inputs:
                if i in mapping:
                    ins.append(mapping[i])
                    continue
                src = g[i]
                if src.is_const:
                    mapping[i] = b.const(g.params[i], name=i)
                else:
                    # produced by an earlier stage or a graph input
                    mapping[i] = b.var(i, src.shape, src.dtype)
                    stage_inputs.append(i)
                ins.append(mapping[i])
            mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
            # is this value needed outside the stage?
            needed_out = n.name in g.outputs or any(
                produced_by[u] != s for u in users[n.name]
            )
            if needed_out:
                stage_outputs.append(n.name)
        stages.append(Stage(b.build([mapping[o] for o in stage_outputs]),
                            stage_inputs, stage_outputs))
    return stages


class PipelineExecutor:
    """Run stages on `devices` (every visible card by default; a device may
    repeat) with microbatch streaming, each stage on its own CUDA stream."""

    def __init__(self, graph: Graph, num_stages: int, devices=None, fuse: bool = False):
        if devices is None:
            resolve_device("cuda", "PipelineExecutor")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d, "PipelineExecutor") for d in devices]
        self.stages = split_stages(graph, num_stages)
        if len(self.stages) > len(devices):
            raise ValueError(
                f"{len(self.stages)} stages need that many devices, have {len(devices)}"
            )
        self.devices = devices[: len(self.stages)]
        self.graph = graph
        self._executors = [
            TorchExecutor(st.graph, device=dev, fuse=fuse)
            for st, dev in zip(self.stages, self.devices)
        ]
        self._fuse = fuse
        # microbatch size -> the stages' executors at that batch (the
        # weights on each device shared with the full-batch executors)
        self._by_batch = {self._batch(self._executors): self._executors}
        self._streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                         for dev in self.devices]
        self._graph_outputs = list(graph.outputs)
        # (stage, microbatch, start event, end event) of the last run on CUDA
        self._events: list = []

    def _batch(self, executors) -> int:
        return executors[0].graph[self.stages[0].inputs[0]].shape[0]

    def executors_for(self, b: int) -> list[TorchExecutor]:
        """The stages' executors at microbatch size `b` (every stage input
        is batch-major), built at the first microbatch of that size."""
        exs = self._by_batch.get(b)
        if exs is None:
            exs = [TorchExecutor(with_batch(st.graph, b), device=dev, fuse=self._fuse,
                                 params=ex._params)
                   for st, dev, ex in zip(self.stages, self.devices, self._executors)]
            self._by_batch[b] = exs
        return exs

    def run_microbatches(self, batches: list) -> list[list[np.ndarray]]:
        """Feed a list of microbatch input dicts; returns outputs per batch.
        Every stage of every microbatch is enqueued before the first wait, so
        stages overlap across microbatches."""
        inflight = []
        self._events = []
        for m, mb in enumerate(batches):
            env = dict(mb) if isinstance(mb, dict) else {self.graph.inputs[0].name: mb}
            ready = None  # the event after which this microbatch's values exist
            executors = self.executors_for(np.shape(env[self.stages[0].inputs[0]])[0])
            for s, (st, ex, dev, stream) in enumerate(zip(self.stages, executors,
                                                         self.devices, self._streams)):
                if stream is None:
                    outs = ex.run_device({k: env[k] for k in st.inputs})
                    env.update(zip(st.outputs, outs))
                    continue
                with torch.cuda.stream(stream):
                    if ready is not None:
                        stream.wait_event(ready)
                    ins = {}
                    for k in st.inputs:
                        v = torch.as_tensor(env[k]).to(dev, non_blocking=True)
                        if v.is_cuda:
                            v.record_stream(stream)  # made on another stream
                        ins[k] = v
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record(stream)
                    outs = ex.run_device(ins)
                    end.record(stream)
                self._events.append((s, m, start, end))
                ready = end
                env.update(zip(st.outputs, outs))
            inflight.append([env[o] for o in self._graph_outputs])
        for dev, stream in zip(self.devices, self._streams):
            if stream is not None:  # the copies below follow every stage's work
                torch.cuda.current_stream(dev).wait_stream(stream)
        return [[torch.as_tensor(o).cpu().numpy() for o in outs] for outs in inflight]

    def intervals(self) -> list[tuple[int, int, float, float]]:
        """(stage, microbatch, start ms, end ms) of the last run's stages on
        CUDA streams, from the first stage's start (CUDA events)."""
        if not self._events:
            return []
        for _, _, _, end in self._events:
            end.synchronize()
        t0 = self._events[0][2]
        return [(s, m, t0.elapsed_time(a), t0.elapsed_time(b)) for s, m, a, b in self._events]

    def run(self, inputs, num_microbatches: int = 1) -> list[np.ndarray]:
        """Split the batch into microbatches along axis 0, stream, reassemble."""
        if not isinstance(inputs, dict):
            inputs = {self.graph.inputs[0].name: inputs}
        names = list(inputs)
        n = np.shape(inputs[names[0]])[0]
        if n % num_microbatches:
            raise ValueError(f"batch {n} does not split into {num_microbatches} microbatches")
        step = n // num_microbatches
        batches = [
            {k: v[i * step : (i + 1) * step] for k, v in inputs.items()}
            for i in range(num_microbatches)
        ]
        per = self.run_microbatches(batches)
        return [
            np.concatenate([outs[j] for outs in per], axis=0)
            for j in range(len(self._graph_outputs))
        ]
