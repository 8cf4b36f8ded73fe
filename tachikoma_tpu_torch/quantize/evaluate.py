"""Quantization quality evaluation — per-layer SNR + output agreement (port
of `tachikoma_tpu/quantize/evaluate.py`).

Given the float graph and its quantized twin, report

  * per-OUTPUT agreement: SNR (dB), max abs error, argmax agreement;
  * per-LAYER SNR: each quantized tensor dequantized and compared against
    the float graph's value at the matching node — the sensitivity list
    that tells you WHICH layer to calibrate differently / keep in float.

Both graphs run on the numpy oracle (runtime/interpreter.py), as in the JAX
package, so the numbers are the same on any machine.

Matching uses node names: the quantizer preserves originals (op node X
becomes X or X_q/X_rq/X_dq), so float node X pairs with the quantized
value whose dequantized meaning is X.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ir.graph import Graph
from ..runtime.interpreter import Interpreter


def _snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    err = got.astype(np.float64) - ref
    p_sig = float((ref ** 2).mean())
    p_err = float((err ** 2).mean())
    if p_err == 0:
        return float("inf")
    return 10.0 * np.log10(max(p_sig, 1e-30) / p_err)


@dataclass
class LayerReport:
    name: str
    op: str
    snr_db: float
    max_abs_err: float
    scale: float


@dataclass
class QuantReport:
    outputs: list
    layers: list

    def table(self, worst: int = 15) -> str:
        rows = ["outputs:"]
        for name, snr, mae, agree in self.outputs:
            rows.append(f"  {name:<32} snr {snr:7.2f} dB  max|err| "
                        f"{mae:.4g}  argmax agree {agree:.3f}")
        rows.append(f"layers (worst {worst} by SNR):")
        for e in sorted(self.layers, key=lambda e: e.snr_db)[:worst]:
            rows.append(f"  {e.name:<40} {e.op:<16} snr {e.snr_db:7.2f} dB"
                        f"  max|err| {e.max_abs_err:.4g}")
        return "\n".join(rows)


def quantization_report(float_graph: Graph, quant_graph: Graph,
                        inputs) -> QuantReport:
    """Run both graphs on `inputs` and compare (numpy oracle, exact)."""
    fvals: dict[str, np.ndarray] = {}
    feeds = inputs
    if isinstance(feeds, np.ndarray):
        feeds = [feeds]
    if not isinstance(feeds, dict):
        feeds = dict(zip([n.name for n in float_graph.inputs], feeds))
    for k, v in feeds.items():
        fvals[k] = np.asarray(v)   # inputs pair with their quantize nodes
    Interpreter(float_graph).run(
        inputs, intercept=lambda n, op, a, o: fvals.__setitem__(n, o))

    qvals: dict[str, np.ndarray] = {}
    Interpreter(quant_graph).run(
        inputs, intercept=lambda n, op, a, o: qvals.__setitem__(n, o))

    # per-layer: the quantizer names rewrites X_q / X_rq / X_dq after the
    # original node X — strip the suffix to pair each quantized value with
    # the float graph's tensor it represents
    def base_name(name: str) -> str | None:
        if name in fvals:
            return name
        for suf in ("_rq", "_q", "_dq", "_sq", "_sdq"):
            if name.endswith(suf) and name[: -len(suf)] in fvals:
                return name[: -len(suf)]
        return None

    layers: list[LayerReport] = []
    for n in quant_graph.nodes:
        ref_name = base_name(n.name)
        if n.name not in qvals or ref_name is None:
            continue
        qv = np.asarray(qvals[n.name])
        fv = np.asarray(fvals[ref_name])
        if qv.shape != fv.shape or fv.dtype.kind != "f":
            continue
        if qv.dtype.kind in "iu":
            scale = n.attrs.get("output_scale", n.attrs.get("scale"))
            zp = int(n.attrs.get("output_zero_point",
                                 n.attrs.get("zero_point", 0)) or 0)
            if scale is None or np.ndim(scale) > 0:
                continue
            deq = (qv.astype(np.float64) - zp) * float(scale)
            layers.append(LayerReport(ref_name, n.op, _snr_db(fv, deq),
                                      float(np.abs(deq - fv).max()),
                                      float(scale)))
        elif qv.dtype.kind == "f":
            layers.append(LayerReport(ref_name, n.op, _snr_db(fv, qv),
                                      float(np.abs(qv - fv).max()), 0.0))

    outs = []
    fouts = Interpreter(float_graph).run(inputs)
    qouts = Interpreter(quant_graph).run(inputs)
    for name, fo, qo in zip(float_graph.outputs, fouts, qouts):
        fo, qo = np.asarray(fo, np.float64), np.asarray(qo, np.float64)
        if fo.shape != qo.shape:
            continue
        agree = 1.0
        if fo.ndim >= 2:
            agree = float((np.argmax(fo, -1) == np.argmax(qo, -1)).mean())
        outs.append((name, _snr_db(fo, qo), float(np.abs(fo - qo).max()),
                     agree))
    return QuantReport(outs, layers)
