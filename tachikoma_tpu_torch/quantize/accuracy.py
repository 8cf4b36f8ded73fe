"""Dataset-scale accuracy evaluation for quantized graphs (port of
`tachikoma_tpu/quantize/accuracy.py`).

Run the quantized graph over a dataset and report accuracy against the
float model and the labels.  Two metrics:

  * top-k AGREEMENT between the float graph and its quantized twin — the
    quantization-quality number that needs no labels;
  * top-1 ACCURACY vs labels (when the dataset has them) for both graphs.

`compare_calibrations` re-quantizes the float graph under each calibration
mode (max / percentile / KL — `quantize/calibrate.py`) with the SAME
calibration batches and evaluates each on the SAME eval split.

`executor` names the backend: "torch" runs `TorchExecutor` on `device`
("cuda" by default: without a card it raises, pass device="cpu"), "oracle"
the numpy interpreter.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..ir.graph import Graph


@dataclass
class AccuracyReport:
    name: str
    n: int
    top1_agree: float
    top5_agree: float
    top1_float: float | None      # vs labels (None if unlabeled)
    top1_quant: float | None
    top5_float: float | None = None
    top5_quant: float | None = None

    def row(self) -> str:
        acc = ("    (unlabeled)" if self.top1_float is None else
               f"  top1 f/q {self.top1_float:.4f}/{self.top1_quant:.4f}"
               f"  top5 f/q {self.top5_float:.4f}/{self.top5_quant:.4f}")
        return (f"{self.name:<14} n={self.n:<5d} agree top1 "
                f"{self.top1_agree:.4f} top5 {self.top5_agree:.4f}{acc}")


def _runner(graph: Graph, executor: str, device):
    """A function batch -> first output (numpy) of `graph` on the backend:
    "torch" (TorchExecutor on `device`, its parameters moved there once) or
    "oracle" (the numpy interpreter)."""
    if executor == "oracle":
        from ..runtime.interpreter import run_graph

        return lambda batch_arr: np.asarray(run_graph(graph, [batch_arr])[0])
    if executor != "torch":
        raise ValueError(f"executor {executor!r}: 'torch' or 'oracle'")
    from ..runtime.executor import TorchExecutor

    ex = TorchExecutor(graph, device=device)
    return lambda batch_arr: ex.run([batch_arr])[0]


def _topk(logits: np.ndarray, k: int) -> np.ndarray:
    return np.argsort(-logits, axis=-1)[:, :k]


def eval_topk(float_graph: Graph, quant_graph: Graph, dataset,
              executor: str = "torch", limit: int | None = None,
              name: str = "int8", device="cuda") -> AccuracyReport:
    """Run both graphs over `dataset` batch-by-batch and aggregate top-k
    agreement + label accuracy.  Batch size comes from the graphs' input
    shape (both graphs must share it); the final short batch is padded and
    only valid rows are scored."""
    batch = int(float_graph.inputs[0].shape[0])
    n = agree1 = agree5 = 0
    acc1f = acc1q = acc5f = acc5q = 0
    labeled = dataset.labels is not None
    pos = 0
    run_f = _runner(float_graph, executor, device)
    run_q = _runner(quant_graph, executor, device)
    for chunk, valid in dataset.batches(batch, limit=limit):
        lf = run_f(chunk)[:valid]
        lq = run_q(chunk)[:valid]
        lf = lf.reshape(valid, -1)
        lq = lq.reshape(valid, -1)
        t1f, t1q = lf.argmax(-1), lq.argmax(-1)
        t5f, t5q = _topk(lf, 5), _topk(lq, 5)
        agree1 += int((t1f == t1q).sum())
        # top-5 agreement: float's top-1 class appears in quant's top-5
        agree5 += int((t5q == t1f[:, None]).any(1).sum())
        if labeled:
            lab = dataset.labels[pos:pos + valid]
            acc1f += int((t1f == lab).sum())
            acc1q += int((t1q == lab).sum())
            acc5f += int((t5f == lab[:, None]).any(1).sum())
            acc5q += int((t5q == lab[:, None]).any(1).sum())
        pos += valid
        n += valid
    return AccuracyReport(
        name=name, n=n,
        top1_agree=agree1 / max(n, 1),
        top5_agree=agree5 / max(n, 1),
        top1_float=acc1f / n if labeled and n else None,
        top1_quant=acc1q / n if labeled and n else None,
        top5_float=acc5f / n if labeled and n else None,
        top5_quant=acc5q / n if labeled and n else None,
    )


def compare_calibrations(float_graph: Graph, dataset, modes=("max",
                         "percentile", "kl"), config=None,
                         calib_samples: int = 32, executor: str = "torch",
                         limit: int | None = None, device="cuda") -> list[AccuracyReport]:
    """Quantize `float_graph` under each calibration mode with identical
    calibration batches; evaluate every quantized twin on the same eval
    split.  Returns one AccuracyReport per mode."""
    from .config import QConfig
    from .quantizer import quantize

    base = config or QConfig()
    batch = int(float_graph.inputs[0].shape[0])
    calib_n = min(calib_samples, max(batch, len(dataset) // 4))
    calib_ds, eval_ds = dataset.split(calib_n)
    calib_batches = [chunk for chunk, _ in calib_ds.batches(batch)]

    # float predictions ONCE (they are identical across calibration modes)
    chunks = list(eval_ds.batches(batch, limit=limit))
    fpred = []
    run_f = _runner(float_graph, executor, device)
    for chunk, valid in chunks:
        lf = run_f(chunk)[:valid].reshape(valid, -1)
        fpred.append((lf.argmax(-1), _topk(lf, 5)))

    labeled = eval_ds.labels is not None
    reports = []
    for mode in modes:
        cfg = dataclasses.replace(base, calibrate_mode=mode)
        qg = quantize(float_graph, calib_batches, cfg)
        n = agree1 = agree5 = acc1f = acc1q = acc5f = acc5q = 0
        pos = 0
        run_q = _runner(qg, executor, device)
        for (chunk, valid), (t1f, t5f) in zip(chunks, fpred):
            lq = run_q(chunk)[:valid].reshape(valid, -1)
            t1q, t5q = lq.argmax(-1), _topk(lq, 5)
            agree1 += int((t1f == t1q).sum())
            agree5 += int((t5q == t1f[:, None]).any(1).sum())
            if labeled:
                lab = eval_ds.labels[pos:pos + valid]
                acc1f += int((t1f == lab).sum())
                acc1q += int((t1q == lab).sum())
                acc5f += int((t5f == lab[:, None]).any(1).sum())
                acc5q += int((t5q == lab[:, None]).any(1).sum())
            pos += valid
            n += valid
        reports.append(AccuracyReport(
            name=mode, n=n,
            top1_agree=agree1 / max(n, 1), top5_agree=agree5 / max(n, 1),
            top1_float=acc1f / n if labeled and n else None,
            top1_quant=acc1q / n if labeled and n else None,
            top5_float=acc5f / n if labeled and n else None,
            top5_quant=acc5q / n if labeled and n else None))
    return reports


def table(reports) -> str:
    return "\n".join(r.row() for r in reports)
