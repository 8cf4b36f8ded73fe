"""Calibration — collect per-node activation statistics on a dataset (port
of `tachikoma_tpu/quantize/calibrate.py`).

Runs the float graph over calibration batches through the numpy interpreter
(or, with `calibrate_backend="torch-cpu"`, the segmented executor on the CPU,
the counterpart of the JAX package's "xla-cpu"), records output ranges per
node, and turns them into scales/zero-points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np

from ..ir.graph import Graph
from ..ir.infer import infer_types
from ..runtime.interpreter import Interpreter
from .config import QConfig


@dataclass
class TensorStats:
    min: float = float("inf")
    max: float = float("-inf")
    absmax: float = 0.0
    # histogram of |x| for percentile/KL modes
    hist: np.ndarray | None = None
    hist_range: float = 0.0

    def update(self, arr: np.ndarray, bins: int | None = None):
        arr = np.asarray(arr)
        if arr.size == 0:
            return
        amin, amax = float(arr.min()), float(arr.max())
        self.min = min(self.min, amin)
        self.max = max(self.max, amax)
        aabs = float(np.abs(arr).max())
        if bins:
            if self.hist is None or aabs > self.hist_range:
                new_range = max(aabs, self.hist_range, 1e-12)
                new_hist = np.zeros(bins, dtype=np.float64)
                if self.hist is not None and self.hist_range > 0:
                    # re-bucket old histogram into the wider range
                    old_edges = np.linspace(0, self.hist_range, bins + 1)
                    centers = (old_edges[:-1] + old_edges[1:]) / 2
                    idx = np.minimum((centers / new_range * bins).astype(int), bins - 1)
                    np.add.at(new_hist, idx, self.hist)
                self.hist = new_hist
                self.hist_range = new_range
            h, _ = np.histogram(np.abs(arr), bins=len(self.hist), range=(0, self.hist_range))
            self.hist += h
        self.absmax = max(self.absmax, aabs)


@dataclass
class CalibrationResult:
    stats: dict[str, TensorStats]
    config: QConfig

    def scale_zp(self, name: str) -> tuple[float, int]:
        """Derive (scale, zero_point) for a node's activation."""
        st = self.stats[name]
        cfg = self.config
        info = np.iinfo(np.dtype(cfg.act_dtype))
        qmax = info.max if info.min < 0 else info.max - info.min
        if cfg.calibrate_mode == "percentile" and st.hist is not None:
            cdf = np.cumsum(st.hist)
            total = cdf[-1]
            if total > 0:
                k = int(np.searchsorted(cdf, total * cfg.percentile / 100.0))
                amax = (k + 1) / len(st.hist) * st.hist_range
            else:
                amax = st.absmax
        elif cfg.calibrate_mode == "kl" and st.hist is not None:
            amax = _kl_threshold(st.hist, st.hist_range, qmax + 1)
        else:
            amax = st.absmax
        amax = max(amax, 1e-8)
        if cfg.act_symmetric:
            return amax / qmax, 0
        # asymmetric uint8-style
        lo, hi = min(st.min, 0.0), max(st.max, 0.0)
        scale = max((hi - lo) / 255.0, 1e-8)
        zp = int(np.clip(np.rint(-lo / scale) - 128, -128, 127)) if cfg.act_dtype == "int8" else int(
            np.clip(np.rint(-lo / scale), 0, 255)
        )
        return scale, zp


def _kl_threshold(hist: np.ndarray, hist_range: float, num_quant: int) -> float:
    """KL-divergence calibration (behavioral port of the method in the
    reference's `python/tvm/relay/quantize/kl_divergence.py`): choose the
    clipping threshold minimizing KL(P||Q) between the clipped distribution
    and its num_quant-bucket quantization."""
    bins = len(hist)
    if hist.sum() == 0:
        return hist_range
    best_kl, best_i = float("inf"), bins
    start = max(num_quant, bins // 8)
    for i in range(start, bins + 1, max(1, bins // 128)):
        p = hist[:i].astype(np.float64).copy()
        p[i - 1] += hist[i:].sum()  # clip outliers into the last bin
        if p.sum() == 0:
            continue
        # quantize p into num_quant buckets -> expand back
        factor = i / num_quant
        q = np.zeros(i, dtype=np.float64)
        for j in range(num_quant):
            lo, hi = int(j * factor), int(np.ceil((j + 1) * factor))
            seg = hist[lo:hi].astype(np.float64)
            nz = seg > 0
            if nz.any():
                q[lo:hi][nz] = seg[nz].sum() / nz.sum()
        pn = p / p.sum()
        qn = q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] / np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i / bins * hist_range


class Calibrator:
    """Runs the float graph over a dataset collecting per-node stats."""

    def __init__(self, graph: Graph, config: QConfig = QConfig()):
        self.graph = infer_types(graph)
        self.config = config
        self.stats: dict[str, TensorStats] = {}
        self._interp = None
        self._seg = None

    def collect(self, inputs, bins: int | None | str = "auto") -> None:
        if bins == "auto":
            bins = (self.config.kl_bins
                    if self.config.calibrate_mode in ("kl", "percentile")
                    else None)

        def hook(name, op, args, out):
            if isinstance(out, np.ndarray) and out.dtype.kind == "f":
                self.stats.setdefault(name, TensorStats()).update(out, bins)

        # also record graph inputs
        norm = inputs
        if isinstance(norm, np.ndarray):
            norm = [norm]
        if not isinstance(norm, Mapping):
            norm = dict(zip([n.name for n in self.graph.inputs], norm))
        for k, v in norm.items():
            self.stats.setdefault(k, TensorStats()).update(np.asarray(v), bins)
        backend = self.config.calibrate_backend
        if backend == "torch-cpu":
            self._collect_torch_cpu(norm, hook)
            return
        if backend != "oracle":
            raise NotImplementedError(
                f"calibrate_backend {backend!r}: the port has 'oracle' and 'torch-cpu' (the "
                "counterpart of the JAX package's 'xla-cpu')")
        if self._interp is None:
            self._interp = Interpreter(self.graph)
        self._interp.run(inputs, intercept=hook)

    def _collect_torch_cpu(self, feeds, hook):
        """Segmented capture on the CPU: one program per structural key, no
        scan (every node is captured), and a bounded-memory walk through
        `run_stream` that frees each value once no later segment needs it.
        The numpy oracle stays the default: its float64 products are the
        reference, and torch's float32 ones agree to about 1e-6."""
        from ..runtime.executor import computational_nodes
        from ..runtime.segmented import SegmentedExecutor, run_stream

        if self._seg is None:
            self._seg = SegmentedExecutor(self.graph, capture=computational_nodes(self.graph),
                                          scan=False, device="cpu")
        run_stream(self._seg, feeds, lambda nm, arr: hook(nm, None, None, arr))

    def _pool_groups(self):
        """scale_group tying: nodes whose names differ only in the grouped
        part SHARE one pooled TensorStats (config.py scale_group)."""
        import re

        pat = re.compile(self.config.scale_group)
        groups: dict[str, list[str]] = {}
        for name in self.stats:
            key = pat.sub("<G>", name)
            groups.setdefault(key, []).append(name)
        for key, members in groups.items():
            if len(members) < 2:
                continue
            pooled = TensorStats()
            pooled.min = min(self.stats[m].min for m in members)
            pooled.max = max(self.stats[m].max for m in members)
            pooled.absmax = max(self.stats[m].absmax for m in members)
            hists = [self.stats[m] for m in members
                     if self.stats[m].hist is not None]
            if hists:
                pooled.hist_range = max(h.hist_range for h in hists)
                bins = len(hists[0].hist)
                pooled.hist = np.zeros(bins, np.float64)
                for h in hists:
                    if h.hist_range == pooled.hist_range:
                        pooled.hist += h.hist
                    else:
                        edges = np.linspace(0, h.hist_range, bins + 1)
                        centers = (edges[:-1] + edges[1:]) / 2
                        idx = np.minimum(
                            (centers / pooled.hist_range * bins).astype(int),
                            bins - 1)
                        np.add.at(pooled.hist, idx, h.hist)
            for m in members:
                self.stats[m] = pooled

    def run(self, dataset: Iterable) -> CalibrationResult:
        """Two-pass calibration for histogram modes (kl/percentile): pass 1
        records exact ranges, pass 2 fills histograms with the FINAL range
        fixed — so no approximate re-bucketing ever happens and the result
        matches the reference's full-distribution KL
        (`python/tvm/relay/quantize/kl_divergence.py` sees all data at one
        range).  The incremental widen path in TensorStats.update stays as
        the fallback for streaming use (collect() called directly), where
        the re-bucketing approximation is documented behavior."""
        if self.config.calibrate_mode in ("kl", "percentile"):
            dataset = list(dataset)
            for batch in dataset:
                self.collect(batch, bins=None)  # exact ranges only
            if self.config.scale_group:
                self._pool_groups()  # pooled ranges BEFORE histograms
            for st in self.stats.values():
                st.hist_range = max(st.absmax, 1e-12)
            for batch in dataset:
                self.collect(batch)             # exact histograms
        else:
            for batch in dataset:
                self.collect(batch)
            if self.config.scale_group:
                self._pool_groups()
        return CalibrationResult(self.stats, self.config)


def calibrate(graph: Graph, dataset: Iterable, config: QConfig = QConfig()) -> CalibrationResult:
    return Calibrator(graph, config).run(dataset)
