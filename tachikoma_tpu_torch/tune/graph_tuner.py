"""Graph-level tuning: whole-graph decisions measured end to end (port of
`tachikoma_tpu/tune/graph_tuner.py`).

The decisions are the fused graph's conv-chain runs (`tk.conv2d_chain`
without a fused residual add): each is kept, or split back into its member
`tk.conv2d_rq` ops.  Greedy coordinate descent from the all-fused baseline
flips one decision at a time, measures the variant end to end with the
injected `measure(fused_graph) -> seconds`, and keeps a flip only when it
gains more than `improve_eps`.  Every measurement is recorded under
`graph/<structural hash[:16]>` with the config {"disabled_chains": [...]},
as in the JAX package.

The JAX package swaps the module global `fuse_conv_chains` for one
`fuse_qnn` call; the port passes the split to `fuse_qnn` explicitly
(`disabled_chains`), which gives the same variant graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ir.graph import Graph
from ..runtime.fuse import fuse_qnn
from .database import NO_ERROR, TuneDatabase, TuneRecord


def chain_runs(fused: Graph) -> list[str]:
    """Names of the tk.conv2d_chain nodes of a fused graph without a fused
    residual add (the decisions)."""
    return [n.name for n in fused.nodes
            if n.op == "tk.conv2d_chain" and not n.attrs.get("res_add")]


def apply_variant(graph: Graph, fused: Graph, disabled: set[str]) -> Graph:
    """`graph` (quantized, unfused) fused with the chains in `disabled` split
    back into their member tk.conv2d_rq ops; `fused` itself when none is."""
    if not disabled:
        return fused
    return fuse_qnn(graph, disabled_chains=frozenset(disabled))


@dataclass
class GraphTuneResult:
    best_disabled: list[str]
    best_time_s: float
    baseline_time_s: float
    trials: int


def tune_graph(graph: Graph, measure: Callable[[Graph], float],
               db: TuneDatabase | None = None, max_flips: int | None = None,
               improve_eps: float = 0.01, verbose: bool = True,
               device="cuda") -> GraphTuneResult:
    """Greedy coordinate descent over the chain-run decisions.

    graph: the quantized (unfused) graph; measure(fused_graph) -> end-to-end
    seconds on `device` ("cuda" by default: with no card this raises; pass
    "cpu" for a measurer that runs on the CPU).  Returns the winning
    disabled set; apply it with apply_variant(graph, fused, set(...))."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tune_graph: device 'cuda' asked for but no CUDA device is "
                           "available; pass device='cpu' to measure on the CPU")
    fused = fuse_qnn(graph)
    decisions = chain_runs(fused)
    wl = f"graph/{graph.structural_hash()[:16]}"

    def record(disabled, t):
        if db is not None:
            db.add(TuneRecord(wl, {"disabled_chains": sorted(disabled)}, t * 1e3, NO_ERROR, ""))

    base_t = measure(fused)
    record(set(), base_t)
    if verbose:
        print(f"graph-tune baseline ({len(decisions)} chains): {base_t * 1e3:.3f} ms",
              flush=True)
    best_t, best_dis = base_t, set()
    trials = 1
    budget = max_flips if max_flips is not None else len(decisions)
    for name in decisions[:budget]:
        cand = best_dis ^ {name}
        t = measure(apply_variant(graph, fused, cand))
        trials += 1
        record(cand, t)
        keep = t < best_t * (1 - improve_eps)
        if verbose:
            print(f"graph-tune flip {name}: {t * 1e3:.3f} ms ({'keep' if keep else 'revert'})",
                  flush=True)
        if keep:
            best_t, best_dis = t, cand
    return GraphTuneResult(sorted(best_dis), best_t, base_t, trials)
