"""Model-based tuning search: rank candidates with a learned cost model
(port of `tachikoma_tpu/tune/model.py`, the same numpy code).

A ridge regression on log-time over engineered features of (workload dims,
block config), trained on the measured records of the database (other
workloads included: the model transfers across shapes), orders the candidate
grid so that measurement can stop early:
  1. rank all candidates by predicted time (model trained on every NO_ERROR
     record in the database);
  2. measure in rank order, refitting after each trial (every third trial
     explores the candidate farthest from those measured);
  3. stop after `patience` trials without improvement (`min_trials` floor).

The 28 features are the JAX package's, so a record gives the same vector and
a database the same model in both packages.  One quirk is kept with them:
only layouts "t" and "s" have a feature (`layout_t`, `layout_s`), so "w" and
"r" configs featurize like the default layout and the model cannot tell the
three apart; measurement does.  Failed trials stay data (database.py).
"""

from __future__ import annotations

import math
import re
import zlib

import numpy as np

from .database import NO_ERROR, TuneDatabase, TuneRecord

_DIM_RE = re.compile(r"([A-Z]+)(\d+)(?:x(\d+))?")


def parse_workload(workload: str) -> dict[str, float]:
    """'qconv2d_flat/N8_H56_W56_C64_O64_K3x3_S1x1_rq' -> dim dict + family."""
    parts = workload.split("/")
    dims: dict[str, float] = {"family_" + parts[0]: 1.0}
    for seg in parts[1:]:
        for tok in seg.split("_"):
            m = _DIM_RE.fullmatch(tok)
            if m:
                key, a, b = m.group(1), int(m.group(2)), m.group(3)
                dims[key] = float(a)
                if b is not None:
                    dims[key + "2"] = float(b)
            elif tok in ("fused", "raw", "rq"):
                dims["tag_" + tok] = 1.0
    # chain stage encoding: K1C64O64+K3C64O64 -> totals
    for seg in parts[1:]:
        if "+" in seg:
            stages = seg.split("+")
            dims["n_stages"] = float(len(stages))
    return dims


_FEATURE_KEYS = [
    "M", "K", "N", "H", "W", "C", "O", "K2", "S", "S2", "n_stages",
    "bm", "bn", "bk", "layout_t", "layout_s", "kernel_auto", "is_xla",
    "bm_frac", "bn_frac", "bk_frac", "grid", "vmem_mb", "macs_log",
    "cat0", "cat1", "cat2", "cat3",
]

# config keys with dedicated features; anything else lands in the hashed
# categorical buckets so NEW experiment dimensions (layout variants, chain
# geometry knobs...) still separate candidates instead of aliasing them
_KNOWN_CONFIG_KEYS = {"blocks", "bm", "layout", "kernel", "impl"}


def _lg(x: float) -> float:
    return math.log2(max(float(x), 1.0))


def featurize(workload: str, config: dict) -> np.ndarray:
    d = parse_workload(workload)
    blocks = config.get("blocks")
    f: dict[str, float] = {}
    for k in ("M", "K", "N", "H", "W", "C", "O", "K2", "S", "S2",
              "n_stages"):
        f[k] = _lg(d.get(k, 1.0))
    # canonical matmul-equivalent dims for conv workloads
    M = d.get("M", d.get("N", 1) * d.get("H", 1) * d.get("W", 1))
    Kdim = d.get("K", d.get("C", 1) * d.get("K", 1))
    if "C" in d:
        Kdim = d["C"] * d.get("K", 1) * d.get("K2", 1)
    N = d.get("N", d.get("O", 1)) if "M" in d else d.get("O", 1)
    f["macs_log"] = _lg(M * Kdim * N)
    f["is_xla"] = 1.0 if config.get("impl") == "xla" else 0.0
    bm = bn = bk = 0.0
    if blocks:
        bm, bn, bk = (list(blocks) + [0, 0, 0])[:3]
    if "bm" in config:
        bm = config["bm"]
    f["bm"], f["bn"], f["bk"] = _lg(bm), _lg(bn), _lg(bk)
    f["layout_t"] = 1.0 if config.get("layout") == "t" else 0.0
    f["layout_s"] = 1.0 if config.get("layout") == "s" else 0.0
    f["kernel_auto"] = 1.0 if config.get("kernel") == "auto" else 0.0
    for key in config:
        if key not in _KNOWN_CONFIG_KEYS:
            # stable across processes (builtin hash is seed-salted)
            h = zlib.crc32(f"{key}={config[key]}".encode()) & 3
            f[f"cat{h}"] = f.get(f"cat{h}", 0.0) + 1.0
    f["bm_frac"] = min(bm / M, 4.0) if M else 0.0
    f["bn_frac"] = min(bn / N, 4.0) if N else 0.0
    f["bk_frac"] = min(bk / Kdim, 4.0) if Kdim else 0.0
    gm = math.ceil(M / bm) if bm else 1
    gn = math.ceil(N / bn) if bn else 1
    gk = math.ceil(Kdim / bk) if bk else 1
    f["grid"] = _lg(gm * gn * gk)
    f["vmem_mb"] = (2 * bm * bk + 2 * bk * bn + 6 * bm * bn) / 1e6
    return np.asarray([f.get(k, 0.0) for k in _FEATURE_KEYS], np.float64)


class CostModel:
    """Ridge regression on log(time) with quadratic feature interactions."""

    def __init__(self, l2: float = 1e-2):
        self.l2 = l2
        self.w: np.ndarray | None = None
        self._mu = None
        self._sd = None

    @staticmethod
    def _expand(X: np.ndarray) -> np.ndarray:
        # degree-2 interactions of a modest feature set keep the model
        # closed-form while capturing block-vs-dim coupling
        n, k = X.shape
        cross = np.einsum("ni,nj->nij", X, X).reshape(n, k * k)
        iu = np.triu_indices(k)
        cross = cross.reshape(n, k, k)[:, iu[0], iu[1]]
        return np.concatenate([np.ones((n, 1)), X, cross], axis=1)

    def fit(self, feats: np.ndarray, times_ms: np.ndarray):
        y = np.log(np.maximum(times_ms, 1e-6))
        self._mu = feats.mean(axis=0)
        self._sd = feats.std(axis=0) + 1e-9
        X = self._expand((feats - self._mu) / self._sd)
        A = X.T @ X + self.l2 * np.eye(X.shape[1])
        self.w = np.linalg.solve(A, X.T @ y)

    def predict(self, feats: np.ndarray) -> np.ndarray:
        if self.w is None:
            return np.zeros(len(feats))
        X = self._expand((feats - self._mu) / self._sd)
        return X @ self.w


def fit_from_db(db: TuneDatabase) -> CostModel | None:
    feats, times = [], []
    for rec in db.records:
        if rec.error_no != NO_ERROR or not np.isfinite(rec.time_ms):
            continue
        feats.append(featurize(rec.workload, rec.config))
        times.append(rec.time_ms)
    if len(feats) < 24:
        return None
    m = CostModel()
    m.fit(np.asarray(feats), np.asarray(times))
    return m


def rank_candidates(model: CostModel | None, workload: str,
                    configs: list[dict]) -> list[int]:
    if model is None:
        return list(range(len(configs)))
    feats = np.asarray([featurize(workload, c) for c in configs])
    return list(np.argsort(model.predict(feats)))


def explore_pick(measured_feats: list[np.ndarray],
                 remaining_feats: list[np.ndarray]) -> int:
    """Farthest-point exploration: the remaining candidate most different
    (max min-distance in feature space) from everything measured so far.

    Pure predicted-rank measurement is exploitation only — a config
    dimension the first cluster never varies (e.g. a block size) is never
    tried, so refitting cannot learn it (the reason autotvm's
    model_based_tuner mixes diversity into its batch,
    `autotvm/tuner/model_based_tuner.py` submodular point selection).
    Deterministic, unlike epsilon-random."""
    if not measured_feats:
        return 0
    M = np.asarray(measured_feats)
    sd = M.std(axis=0) + 1e-9
    best_i, best_d = 0, -1.0
    for i, f in enumerate(remaining_feats):
        d = np.min(np.sum(((M - f) / sd) ** 2, axis=1))
        if d > best_d:
            best_i, best_d = i, d
    return best_i


def model_search(workload: str, configs: list[dict], measure, db: TuneDatabase,
                 patience: int = 4, min_trials: int = 5,
                 improve_eps: float = 0.02, verbose: bool = False,
                 meta_fn=None):
    """Measure `configs` in model-ranked order with early stopping.

    measure(config) -> (time_s, error_no, msg); every trial is recorded to
    db (meta_fn(time_s) -> meta dict, e.g. TOPS).  Returns
    (best_record, n_trials)."""
    model = fit_from_db(db)
    # wide grids (30+ experimental variants) need proportionally more
    # patience or the search quits inside the first cluster it tries
    patience = max(patience, math.ceil(0.15 * len(configs)))
    remaining = list(range(len(configs)))
    all_feats = [featurize(workload, c) for c in configs]
    measured_feats: list[np.ndarray] = []
    best = math.inf
    stall = 0
    trials = 0
    while remaining:
        if trials % 4 == 2:  # every 3rd trial explores
            pick = explore_pick(measured_feats,
                                [all_feats[i] for i in remaining])
        else:
            order = rank_candidates(model, workload,
                                    [configs[i] for i in remaining])
            pick = order[0]
        ci = remaining.pop(pick)
        measured_feats.append(all_feats[ci])
        cfg = configs[ci]
        t, err, msg = measure(cfg)
        trials += 1
        rec = TuneRecord(workload, cfg,
                         t * 1e3 if np.isfinite(t) else float("inf"),
                         err, msg,
                         meta=(meta_fn(t) if meta_fn and np.isfinite(t)
                               else {}))
        db.add(rec)
        if verbose:
            print(f"  [model {trials}/{len(configs)}] {cfg}: "
                  f"{t*1e6:.1f} us" if np.isfinite(t) else
                  f"  [model {trials}] {cfg}: err{err}", flush=True)
        if np.isfinite(t) and t < best * (1 - improve_eps):
            best = t
            stall = 0
        else:
            stall += 1
        if trials >= min_trials and stall >= patience:
            break
        # refine: the new record is in db, so the refit model has seen
        # THIS workload's measurements and re-ranks the remaining grid
        # (the model_based_tuner loop, autotvm/tuner/model_based_tuner.py)
        model = fit_from_db(db)
    return db.best(workload), trials
