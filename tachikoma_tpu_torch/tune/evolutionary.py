"""Evolutionary tuning search: candidates beyond the seed grid (port of
`tachikoma_tpu/tune/evolutionary.py`, the same code).

Evolution mutates measured configs (block dims stepped by powers of two,
layout and impl toggles) and crosses pairs of good ones, scores the offspring
on the learned cost model (`tune/model.py`), and measures only the model's
top picks each generation.  The seeded numpy Generator makes it
deterministic: the same seed, records and measurements replay the same
trajectory as the JAX package's.  The port's tuner passes a `valid_fn` that
admits only the tiles the kernels are built at.
"""

from __future__ import annotations

import math

import numpy as np

from .database import NO_ERROR, TuneDatabase, TuneRecord
from .model import featurize, fit_from_db

_POW2 = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _step_pow2(v: int, direction: int) -> int:
    """Nearest power-of-two neighbour of v in the given direction."""
    if v <= 0:
        return 128
    i = min(range(len(_POW2)), key=lambda k: abs(_POW2[k] - v))
    return _POW2[max(0, min(len(_POW2) - 1, i + direction))]


def mutate(config: dict, rng: np.random.Generator,
           layouts: bool = False) -> dict:
    """One random structural edit of a config.

    layouts gates layout toggles: only conv-family workloads have layout
    variants — evolving a layout key onto a matmul config would record a
    dead attribute."""
    cfg = {k: (list(v) if isinstance(v, list) else v)
           for k, v in config.items()}
    moves = []
    if "blocks" in cfg:
        for axis in range(len(cfg["blocks"])):
            for d in (-1, +1):
                moves.append(("block", axis, d))
    if layouts and ("layout" in cfg or "blocks" in cfg):
        moves.append(("layout", None, None))
    moves.append(("impl", None, None))
    kind, axis, d = moves[rng.integers(len(moves))]
    if kind == "block":
        cfg["blocks"][axis] = _step_pow2(int(cfg["blocks"][axis]), d)
        cfg.pop("impl", None)
    elif kind == "layout":
        cur = cfg.get("layout")
        opts = [o for o in (None, "t", "w", "s") if o != cur]
        pick = opts[rng.integers(len(opts))]
        if pick is None:
            cfg.pop("layout", None)
        else:
            cfg["layout"] = pick
    else:
        if cfg.get("impl") == "xla":
            cfg.pop("impl", None)
        else:
            cfg = {"impl": "xla"}
    return cfg


def crossover(a: dict, b: dict, rng: np.random.Generator) -> dict:
    """Mix block axes of two parents (falls back to a copy of `a`)."""
    if "blocks" not in a or "blocks" not in b or len(a["blocks"]) != len(b["blocks"]):
        return dict(a)
    child = {k: (list(v) if isinstance(v, list) else v) for k, v in a.items()}
    child["blocks"] = [
        int((a if rng.integers(2) else b)["blocks"][i])
        for i in range(len(a["blocks"]))
    ]
    if "layout" in b and rng.integers(2):
        child["layout"] = b["layout"]
    return child


def _key(cfg: dict) -> str:
    return str(sorted((k, str(v)) for k, v in cfg.items()))


def evolutionary_search(
    workload: str,
    seed_configs: list[dict],
    measure,
    db: TuneDatabase,
    valid_fn=None,
    generations: int = 3,
    population: int = 16,
    measure_per_gen: int = 4,
    seed: int = 0,
    verbose: bool = False,
    meta_fn=None,
):
    """Evolve configs for `workload`, measuring only surrogate top picks.

    measure(config) -> (time_s, error_no, msg); valid_fn(config) -> bool
    gates offspring (e.g. the conv kernel's tileability rule).  Returns
    (best_record, n_measured).
    """
    rng = np.random.default_rng(seed)
    valid = valid_fn or (lambda c: True)
    layouts = any("layout" in c for c in seed_configs)
    measured: dict[str, float] = {}

    def do_measure(cfg) -> float:
        t, err, msg = measure(cfg)
        rec = TuneRecord(workload, cfg,
                         t * 1e3 if np.isfinite(t) else float("inf"),
                         err, msg,
                         meta=(meta_fn(t) if meta_fn and np.isfinite(t)
                               else {}))
        db.add(rec)
        measured[_key(cfg)] = t if err == NO_ERROR else math.inf
        if verbose:
            shown = f"{t*1e6:.1f} us" if np.isfinite(t) else f"err{err}"
            print(f"  [evolve] {cfg}: {shown}", flush=True)
        return measured[_key(cfg)]

    # generation 0: measure the seeds
    pop = [c for c in seed_configs if valid(c)]
    for cfg in pop[:max(population // 2, 2)]:
        if _key(cfg) not in measured:
            do_measure(cfg)

    for gen in range(generations):
        model = fit_from_db(db)
        # breed: parents weighted toward fast measured configs
        ranked = sorted((c for c in pop if _key(c) in measured),
                        key=lambda c: measured[_key(c)])
        parents = ranked[:max(2, len(ranked) // 2)] or pop
        offspring: list[dict] = []
        seen = {_key(c) for c in pop}
        attempts = 0
        while len(offspring) < population and attempts < population * 20:
            attempts += 1
            if len(parents) >= 2 and rng.random() < 0.3:
                a, b = rng.choice(len(parents), 2, replace=False)
                child = crossover(parents[a], parents[b], rng)
            else:
                child = mutate(parents[int(rng.integers(len(parents)))], rng,
                               layouts=layouts)
            k = _key(child)
            if k in seen or not valid(child):
                continue
            seen.add(k)
            offspring.append(child)
        if not offspring:
            break
        # surrogate scoring: only the model's top picks get real time
        if model is not None:
            feats = np.asarray([featurize(workload, c) for c in offspring])
            order = np.argsort(model.predict(feats))
        else:
            order = np.arange(len(offspring))
        for i in order[:measure_per_gen]:
            do_measure(offspring[int(i)])
        pop = pop + offspring
        if verbose:
            best_t = min(measured.values())
            print(f"  [evolve gen {gen}] population {len(pop)}, "
                  f"best {best_t*1e6:.1f} us", flush=True)

    return db.best(workload), len(measured)
