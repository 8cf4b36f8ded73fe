"""Per-op profiler and cut-point ablation (port of
`tachikoma_tpu/runtime/profiler.py`).

The role of the reference's debug graph executor (`RunIndividual`,
`src/runtime/graph_executor/debug/graph_executor_debug.cc:70`) and profiling
report (`include/tvm/runtime/profiling.h:259 Report`): a table / CSV / JSON
report with FLOP-derived throughput.

Two modes, both on a torch device ("cuda" by default: with no card present
they raise; pass device="cpu" for the CPU), timed on the host clock around a
call and a `torch.cuda.synchronize`:
  * profile_graph: each op run alone on its captured inputs, best of
    `repeats` (attributable, but each op runs warm and without its
    neighbours), plus the whole graph through TorchExecutor;
  * ablate_graph: the graph cut at the segmented executor's cut points
    (`runtime/segmented.py partition`), each prefix run through
    TorchExecutor, the median of `repeats`; consecutive differences give
    per-stage costs in context.
"""

from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph
from ..ir.infer import infer_types
from ..ir.registry import get_op
from ..ops.nn import _dtype_name
from .executor import TorchExecutor, computational_nodes, resolve_device

# Peak numbers for roofline fractions (per device), keyed by
# torch.cuda.get_device_name: the H100 SXM's data sheet (dense int8 and
# bf16 tensor-core rates, HBM3 bandwidth).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops": 1979e12, "bf16_flops": 989.4e12, "hbm_gbps": 3350.0},
    "cpu": {"int8_ops": 1e12, "bf16_flops": 5e11, "hbm_gbps": 50.0},
}


@dataclass
class OpProfile:
    name: str
    op: str
    shape: tuple
    dtype: str
    time_s: float
    flops: int
    bytes: int

    @property
    def gops(self) -> float:
        return self.flops / self.time_s / 1e9 if self.time_s > 0 else 0.0


@dataclass
class Report:
    entries: list[OpProfile]
    total_time_s: float
    whole_graph_time_s: float | None = None
    device: str = ""

    def table(self, top: int | None = None) -> str:
        rows = sorted(self.entries, key=lambda e: -e.time_s)
        if top:
            rows = rows[:top]
        out = [f"{'name':<28} {'op':<18} {'time_ms':>9} {'%':>6} {'GOPS':>9} {'shape'}"]
        for e in rows:
            pct = 100 * e.time_s / self.total_time_s if self.total_time_s else 0
            out.append(f"{e.name[:28]:<28} {e.op[:18]:<18} {e.time_s*1e3:>9.3f} "
                       f"{pct:>6.1f} {e.gops:>9.1f} {e.dtype}{list(e.shape)}")
        out.append(f"total per-op {self.total_time_s*1e3:.3f} ms"
                   + (f"; whole-graph {self.whole_graph_time_s*1e3:.3f} ms"
                      if self.whole_graph_time_s is not None else ""))
        return "\n".join(out)

    def csv(self) -> str:
        lines = ["name,op,time_ms,flops,gops,dtype,shape"]
        for e in self.entries:
            lines.append(f"{e.name},{e.op},{e.time_s*1e3:.6f},{e.flops},{e.gops:.2f},"
                         f"{e.dtype},{'x'.join(map(str, e.shape))}")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps({
            "device": self.device,
            "total_time_ms": self.total_time_s * 1e3,
            "whole_graph_time_ms": (self.whole_graph_time_s * 1e3
                                    if self.whole_graph_time_s else None),
            "ops": [{"name": e.name, "op": e.op, "time_ms": e.time_s * 1e3, "flops": e.flops,
                     "gops": round(e.gops, 2), "dtype": e.dtype, "shape": list(e.shape)}
                    for e in self.entries],
        })


def graph_flops(graph: Graph) -> int:
    """Static total op count of a graph (2*MACs for matmul-family ops) from
    the per-op flops registry -- the denominator for e2e MFU reporting.
    Requires inferred shapes (runs infer_types if any are missing)."""
    g = graph
    if any(n.shape is None and n.dtype != "tuple" for n in g.nodes):
        g = infer_types(g)
    total = 0
    for n in g.nodes:
        if n.op in (VAR, CONST, TUPLE, TUPLE_GET_ITEM):
            continue
        in_types = [(tuple(g[i].shape or ()), g[i].dtype or "float32") for i in n.inputs]
        total += _op_flops(n, in_types)
    return total


def _op_flops(node, in_types) -> int:
    od = get_op(node.op)
    if od.flops is not None:
        try:
            return int(od.flops(node, in_types))
        except Exception:  # a rule that cannot count this node counts 0, as in the JAX package
            return 0
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _prepared(graph: Graph, fuse: bool) -> Graph:
    g = graph
    if fuse:
        from .fuse import fuse_qnn

        g = fuse_qnn(g)
    if any(n.shape is None and n.dtype != "tuple" for n in g.nodes):
        g = infer_types(g)
    return g


def profile_graph(graph: Graph, inputs, repeats: int = 5, whole_graph: bool = True,
                  fuse: bool = False, device="cuda") -> Report:
    """Each op of the graph timed alone on `device` on its captured inputs
    (best of `repeats`, host clock around the call and a synchronize), and
    the whole graph through TorchExecutor the same way."""
    dev = resolve_device(device, "profile_graph")
    g = _prepared(graph, fuse)

    # concrete values for every node via the capture executor
    names = computational_nodes(g)
    ex = TorchExecutor(g, capture=names, device=dev)
    values = dict(zip(names, ex.run_device(inputs)))
    feeds = ex._normalize(inputs)
    env: dict = {}
    for n in g.nodes:
        if n.op == VAR:
            env[n.name] = feeds[n.name]
        elif n.op == CONST:
            env[n.name] = ex._params[n.name]
        elif n.op in (TUPLE, TUPLE_GET_ITEM):
            env[n.name] = None
        else:
            env[n.name] = values[n.name]

    entries = []
    for n in g.nodes:
        if n.op in (VAR, CONST, TUPLE, TUPLE_GET_ITEM):
            continue
        args = [env[i] for i in n.inputs]
        if any(a is None for a in args):
            continue
        impl = get_op(n.op).torch_impl
        impl(*args, node=n)
        _sync(dev)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            impl(*args, node=n)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        in_types = [(tuple(a.shape), _dtype_name(a)) for a in args]
        nbytes = sum(a.numel() * a.element_size() for a in args)
        entries.append(OpProfile(n.name, n.op, tuple(n.shape or ()), n.dtype or "?", best,
                                 _op_flops(n, in_types), nbytes))

    total = sum(e.time_s for e in entries)
    wg = None
    if whole_graph:
        ex2 = TorchExecutor(g, device=dev)
        ex2.run_device(inputs)
        _sync(dev)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            ex2.run_device(inputs)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        wg = best
    return Report(entries, total, wg, _device_name(dev))


# ---------------------------------------------------------------------------
# cut-point ablation -- in-context attribution
# ---------------------------------------------------------------------------

@dataclass
class AblationEntry:
    label: str            # cut node name
    n_ops: int            # ops in this stage (since the previous cut)
    cumulative_s: float   # e2e latency of the graph truncated at this cut
    delta_s: float        # cumulative[k] - cumulative[k-1]


@dataclass
class AblationReport:
    entries: list
    device: str

    def table(self) -> str:
        rows = [f"{'cut':<40} {'ops':>5} {'cum ms':>10} {'delta ms':>10}"]
        for e in self.entries:
            rows.append(f"{e.label:<40} {e.n_ops:>5} "
                        f"{e.cumulative_s*1e3:>10.3f} {e.delta_s*1e3:>10.3f}")
        rows.append(f"device: {self.device}")
        return "\n".join(rows)

    def csv(self) -> str:
        out = ["cut,ops,cumulative_ms,delta_ms"]
        for e in self.entries:
            out.append(f"{e.label},{e.n_ops},{e.cumulative_s*1e3:.4f},{e.delta_s*1e3:.4f}")
        return "\n".join(out)

    def json(self) -> str:
        return json.dumps({
            "device": self.device,
            "entries": [{"cut": e.label, "ops": e.n_ops,
                         "cumulative_ms": round(e.cumulative_s * 1e3, 4),
                         "delta_ms": round(e.delta_s * 1e3, 4)} for e in self.entries],
        })


def ablate_graph(graph: Graph, inputs, cuts: Sequence[str] | None = None, repeats: int = 3,
                 fuse: bool = False, min_ops: int = 24, max_ops: int = 400,
                 device="cuda") -> AblationReport:
    """Cumulative-latency ablation: time the graph truncated at each cut
    (its prefix through TorchExecutor on `device`, one warm run, then the
    median of `repeats`, host clock around the run and a synchronize);
    consecutive differences give per-stage costs that include what the
    stage's neighbours do to it, which the isolated per-op mode
    (profile_graph) cannot see.

    cuts=None picks the single-tensor articulation points the segmented
    executor partitions at (runtime/segmented.py)."""
    from .segmented import partition

    dev = resolve_device(device, "ablate_graph")
    g = _prepared(graph, fuse)
    if cuts is None:
        segs = partition(g, min_ops=min_ops, max_ops=max_ops)
        cuts = [seg[-1].name for seg in segs]
        if cuts and cuts[-1] not in g.outputs:
            cuts[-1] = g.outputs[0]
    feeds = inputs
    if isinstance(feeds, (np.ndarray, torch.Tensor)):
        feeds = [feeds]
    if not isinstance(feeds, dict):
        feeds = dict(zip([n.name for n in g.inputs], feeds))

    entries = []
    prev_t, prev_ops = 0.0, 0
    for cut in cuts:
        sub = Graph(list(g.nodes), [cut], params=dict(g.params),
                    name=g.name).dead_code_eliminate()
        n_ops = sum(1 for n in sub.nodes if n.op not in (VAR, CONST, TUPLE, TUPLE_GET_ITEM))
        ex = TorchExecutor(sub, device=dev)
        x = ex._normalize({n.name: feeds[n.name] for n in sub.inputs})
        ex.run_device(x)
        _sync(dev)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            ex.run_device(x)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        entries.append(AblationEntry(cut, n_ops - prev_ops, t, t - prev_t))
        prev_t, prev_ops = t, n_ops
    return AblationReport(entries, _device_name(dev))
