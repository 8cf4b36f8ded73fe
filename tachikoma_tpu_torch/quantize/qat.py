"""Quantization-aware training: fake-quant insertion and finalization (port
of `tachikoma_tpu/quantize/qat.py`).

  qat_prepare(float_graph, calib)  -> float graph with
      qnn.simulated_quantize -> qnn.simulated_dequantize pairs on every
      conv/dense data input and weight (per-channel on weights when the
      config says so), activation scales from the port's `calibrate`
      (either calibration backend), trainable end to end through
      runtime/autodiff.py (the fake-quant pair's straight-through gradient)
  qat_finalize(float_graph, trained_params, calib) -> integer graph:
      the trained weights swapped into the original float graph, quantized
      by the port's PTQ flow (quantize/quantizer.py), so the deployed integer
      model is the one training simulated.

From the same inputs and the same stepped weights, both give the JAX
package's graphs byte for byte (structural bytes, params included).
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types
from .calibrate import CalibrationResult, calibrate
from .config import QConfig

_FAKEQ_OPS = {"nn.conv2d", "nn.dense", "nn.matmul", "nn.batch_matmul"}


def _weight_scale(arr: np.ndarray, per_channel: bool):
    if per_channel:
        axes = tuple(range(arr.ndim - 1))
        amax = np.abs(arr).max(axis=axes)
        return np.maximum(amax, 1e-12).astype(np.float32) / 127.0
    return max(float(np.abs(arr).max()), 1e-12) / 127.0


def qat_prepare(graph: Graph, calib_data, config: QConfig | None = None,
                calib: CalibrationResult | None = None) -> Graph:
    """Insert fake-quant (sq->sdq) pairs; returns a float graph whose
    params are the ORIGINAL weights (trainable)."""
    g = infer_types(graph)
    cfg = config or QConfig()
    if calib is None:
        calib = calibrate(g, calib_data, cfg)

    b = GraphBuilder(g.name + "_qat")
    mapping: dict[str, str] = {}
    fakeq_cache: dict[str, str] = {}

    def fakeq_act(name: str, orig_name: str) -> str:
        key = f"act:{name}"
        if key in fakeq_cache:
            return fakeq_cache[key]
        scale, zp = calib.scale_zp(orig_name)
        sq = b.call("qnn.simulated_quantize", name, scale=scale,
                    zero_point=zp, out_dtype="int8",
                    name=f"{orig_name}_sq")
        out = b.call("qnn.simulated_dequantize", sq, scale=scale,
                     zero_point=zp, name=f"{orig_name}_sdq")
        fakeq_cache[key] = out
        return out

    def fakeq_weight(const_name: str) -> str:
        key = f"w:{const_name}"
        if key in fakeq_cache:
            return fakeq_cache[key]
        arr = g.params[const_name]
        scale = _weight_scale(arr, cfg.weight_per_channel)
        sq = b.call("qnn.simulated_quantize", mapping[const_name],
                    scale=scale, zero_point=0, out_dtype="int8",
                    axis=arr.ndim - 1, name=f"{const_name}_sq")
        out = b.call("qnn.simulated_dequantize", sq, scale=scale,
                     zero_point=0, axis=arr.ndim - 1,
                     name=f"{const_name}_sdq")
        fakeq_cache[key] = out
        return out

    for n in g.nodes:
        if n.is_var:
            mapping[n.name] = b.var(n.name, n.shape, n.dtype)
            continue
        if n.is_const:
            mapping[n.name] = b.const(g.params[n.name], name=n.name)
            continue
        ins = [mapping[i] for i in n.inputs]
        if (n.op in _FAKEQ_OPS and n.dtype == "float32"
                and g[n.inputs[0]].dtype == "float32"):
            ins = list(ins)
            ins[0] = fakeq_act(ins[0], n.inputs[0])
            for k in range(1, len(n.inputs)):
                src = g[n.inputs[k]]
                if src.is_const and src.dtype == "float32":
                    ins[k] = fakeq_weight(n.inputs[k])
                else:
                    ins[k] = fakeq_act(ins[k], n.inputs[k])
        mapping[n.name] = b.call(n.op, *ins, name=n.name, **dict(n.attrs))
    return infer_types(b.build([mapping[o] for o in g.outputs]))


def _host(v) -> np.ndarray:
    """A trained weight as numpy (a tensor on any device is read back)."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def qat_finalize(graph: Graph, trained_params: dict, calib_data,
                 config: QConfig | None = None) -> Graph:
    """Swap trained weights into the float graph and quantize with the same
    flow as PTQ (quantize/quantizer.py); weight scales are re-derived from
    the trained values exactly as the quantizer does."""
    from .quantizer import quantize

    g = infer_types(graph)
    params = dict(g.params)
    for k, v in trained_params.items():
        if k in params:
            params[k] = np.asarray(_host(v), dtype=params[k].dtype)
    g2 = Graph(list(g.nodes), list(g.outputs), params, g.name)
    return quantize(g2, calib_data, config or QConfig())
