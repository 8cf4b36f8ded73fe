"""Cross-workload tuning budget scheduler (port of
`tachikoma_tpu/tune/schedule.py`, the same allocation code).

A model has many conv and GEMM workloads but a bounded measurement budget:
each next trial goes to the task with the largest expected end-to-end gain,

    gain_i = weight_i * best_i * slope_i

with weight_i the workload's occurrences in the model, best_i its best time
so far, and slope_i its relative improvement per trial over a backward
window, floored by an optimism term that decays with trials.  Each task's
inner picker is the model-ranked + farthest-point loop of tune/model.py.
`graph_tasks` enumerates a fused graph's workloads with their counts, as the
JAX package's does, from the port's task functions (`tune/tuner.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .database import TuneDatabase, TuneRecord
from .model import explore_pick, featurize, fit_from_db, rank_candidates

NO_ERROR = 0


@dataclass
class TuneTask:
    """One tunable workload: the unit of budget allocation."""
    workload: str
    configs: list
    measure: Callable        # measure(cfg) -> (time_s, error_no, msg)
    meta_fn: Callable | None = None
    weight: int = 1          # occurrences in the model


@dataclass
class _TaskState:
    task: TuneTask
    remaining: list = field(default_factory=list)
    feats: list = field(default_factory=list)
    measured_feats: list = field(default_factory=list)
    history: list = field(default_factory=list)   # best-so-far per trial
    trials: int = 0

    def __post_init__(self):
        self.remaining = list(range(len(self.task.configs)))
        self.feats = [featurize(self.task.workload, c)
                      for c in self.task.configs]

    @property
    def best(self) -> float:
        return self.history[-1] if self.history else math.inf

    @property
    def exhausted(self) -> bool:
        return not self.remaining

    def step(self, db: TuneDatabase, model, verbose: bool = False) -> float:
        """Measure ONE candidate (model-ranked, every 3rd trial explores)."""
        t_ = self.task
        if self.trials % 4 == 2 and self.measured_feats:
            pick = explore_pick(self.measured_feats,
                                [self.feats[i] for i in self.remaining])
        else:
            order = rank_candidates(model, t_.workload,
                                    [t_.configs[i] for i in self.remaining])
            pick = order[0]
        ci = self.remaining.pop(pick)
        self.measured_feats.append(self.feats[ci])
        cfg = t_.configs[ci]
        t, err, msg = t_.measure(cfg)
        self.trials += 1
        db.add(TuneRecord(
            t_.workload, cfg, t * 1e3 if np.isfinite(t) else float("inf"),
            err, msg,
            meta=(t_.meta_fn(t) if t_.meta_fn and np.isfinite(t) else {})))
        cur = t if (err == NO_ERROR and np.isfinite(t)) else math.inf
        self.history.append(min(self.best, cur))
        if verbose:
            shown = f"{t*1e6:.1f} us" if np.isfinite(t) else f"err{err}"
            print(f"  [sched {t_.workload} #{self.trials}] {cfg}: {shown}",
                  flush=True)
        return cur

    def slope(self, window: int = 4, optimism: float = 0.10,
              decay: float = 0.7) -> float:
        """Relative best-so-far improvement per trial over the backward
        window, floored by a decaying optimism prior."""
        prior = optimism * (decay ** max(self.trials - 1, 0))
        h = self.history
        if len(h) < 2 or not np.isfinite(h[-1]):
            return prior
        w = min(window, len(h) - 1)
        then, now = h[-1 - w], h[-1]
        if not np.isfinite(then):
            return max(prior, 0.5)  # first finite point: huge gain realized
        obs = (then - now) / then / w if then > 0 else 0.0
        return max(obs, prior)

    def gain(self, window: int = 4) -> float:
        if self.exhausted:
            return -1.0
        b = self.best
        if not np.isfinite(b):
            # nothing runnable measured yet: allocate by potential share
            return float(self.task.weight) * 1e6
        return self.task.weight * b * self.slope(window)


def schedule_tune(tasks: Sequence[TuneTask], db: TuneDatabase,
                  total_trials: int = 100, min_per_task: int = 2,
                  window: int = 4, verbose: bool = False) -> dict:
    """Spend `total_trials` measurements across `tasks` by expected gain.

    Returns a summary dict: per-task trials, best times, and the projected
    model latency share (sum of weight * best)."""
    states = [_TaskState(t) for t in tasks]
    model = fit_from_db(db)
    spent = 0
    # warmup: round-robin floor so every task has a gradient estimate
    for _ in range(min_per_task):
        for st in states:
            if spent >= total_trials or st.exhausted:
                continue
            st.step(db, model, verbose)
            spent += 1
            model = fit_from_db(db)
    # gradient allocation
    while spent < total_trials:
        live = [s for s in states if not s.exhausted]
        if not live:
            break
        st = max(live, key=lambda s: s.gain(window))
        st.step(db, model, verbose)
        spent += 1
        model = fit_from_db(db)
    projected = sum(s.task.weight * s.best for s in states
                    if np.isfinite(s.best))
    return {
        "total_trials": spent,
        "per_task": {
            s.task.workload: {
                "trials": s.trials,
                "weight": s.task.weight,
                "best_us": (round(s.best * 1e6, 2)
                            if np.isfinite(s.best) else None),
            } for s in states},
        "projected_model_us": round(projected * 1e6, 1),
    }


def graph_tasks(graph, batch_hint: int | None = None, device="cuda") -> list[TuneTask]:
    """Enumerate a fused graph's tunable workloads WITH occurrence counts
    (the latency weights), each task measuring on `device`.  Mirrors the CLI
    tune extraction but keeps multiplicity instead of deduplicating it away."""
    from ..ops.nn import _pad4, _pair
    from .tuner import conv_chain_task, conv_flat_task, conv_stack_task, matmul_task

    counts: dict = {}
    for n in graph.nodes:
        if n.op in ("tk.dense_rq", "qnn.dense"):
            src = graph[n.inputs[0]]
            wsh = graph[n.inputs[1]].shape
            M = int(np.prod(src.shape[:-1]))
            key = ("mm", M, int(wsh[0]), int(wsh[1]))
        elif n.op in ("tk.conv2d_rq", "qnn.conv2d"):
            src = graph[n.inputs[0]]
            wsh = graph[n.inputs[1]].shape
            a = dict(n.attrs)
            key = ("cv", tuple(src.shape), tuple(wsh),
                   _pair(tuple(a.get("strides", (1, 1)))),
                   _pad4(a.get("padding", (0, 0, 0, 0))),
                   int(a.get("groups", 1)))
        elif n.op == "tk.conv2d_chain":
            # stage dims from the per-stage weight inputs
            src = graph[n.inputs[0]]
            dims = []
            arg = 1
            for st in n.attrs["stages"]:
                wsh = graph[n.inputs[arg]].shape
                dims.append((int(wsh[0]), int(wsh[2]), int(wsh[3])))
                arg += 2 if st.get("has_bias") else 1
            nb, hh, ww = int(src.shape[0]), int(src.shape[1]), int(src.shape[2])
            key = ("ch", nb, hh, ww, tuple(dims))
        elif n.op == "tk.conv2d_block_stack":
            src = graph[n.inputs[0]]
            bdims = []
            arg = 1
            for blk in n.attrs["blocks"]:
                dims = []
                for st in blk["stages"]:
                    wsh = graph[n.inputs[arg]].shape
                    dims.append((int(wsh[0]), int(wsh[2]), int(wsh[3])))
                    arg += 2 if st.get("has_bias") else 1
                bdims.append(tuple(dims))
            nb, hh, ww = (int(src.shape[0]), int(src.shape[1]),
                          int(src.shape[2]))
            key = ("stk", nb, hh, ww, tuple(bdims))
        else:
            continue
        counts[key] = counts.get(key, 0) + 1

    tasks = []
    for key, cnt in counts.items():
        if key[0] == "mm":
            _, M, K, N = key
            t = matmul_task(M, K, N, fused=True, weight=cnt, device=device)
        elif key[0] == "ch":
            _, nb, hh, ww, dims = key
            t = conv_chain_task(nb, hh, ww, list(dims), weight=cnt, device=device)
        elif key[0] == "stk":
            _, nb, hh, ww, bdims = key
            t = conv_stack_task(nb, hh, ww, [list(d) for d in bdims],
                                weight=cnt, device=device)
        else:
            _, shape, wsh, strides, padding, groups = key
            t = conv_flat_task(shape, wsh, strides, padding, groups,
                               weight=cnt, device=device)
            if t is None:
                continue
        tasks.append(TuneTask(*t))
    return tasks
