"""FQ2I — convert a fake-quantized (QDQ) imported graph to integer-only ops
(port of `tachikoma_tpu/quantize/fq2i.py`).

The behavior of Relay's FakeQuantizationToInteger pass: a graph imported
with qnn.quantize / qnn.dequantize boundary nodes (ONNX QuantizeLinear /
DequantizeLinear, QLinearConv / QLinearMatMul, torch.ao-quantized models) is
rewritten so the float regions between the boundaries execute as integer
qnn ops using the MODEL'S OWN scales — no calibration.

Implementation: a Quantizer subclass whose
  * activation scales come from the DOWNSTREAM qnn.quantize node (QDQ
    graphs quantize every tensor, so the nearest quantize through
    scale-preserving ops defines each op's output qparams),
  * qnn.dequantize nodes vanish (their int8 input flows on as a 'quant'
    QVal),
  * qnn.quantize nodes become requantizes (or nothing, when scales match),
  * weight constants marked by the frontend with qdq_scale attrs recover
    their EXACT int8 values instead of being re-quantized by absmax.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, Node
from ..ir.infer import infer_types
from .config import QConfig
from .quantizer import QVal, Quantizer

# ops through which an output scale can be traced downstream
_SCALE_TRANSPARENT = {
    "nn.relu", "clip", "reshape", "transpose", "squeeze", "expand_dims",
    "nn.batch_flatten", "nn.max_pool2d", "nn.global_max_pool2d", "nn.pad",
    "nn.bias_add", "strided_slice",
}


class ScaleUnresolved(KeyError):
    """No downstream qnn.quantize defines a scale for this tensor: the op
    lives in a float-computed interior (torch computes hardswish & friends
    in fp32 and requantizes at the boundary) — the quantizer falls back to
    float for the node and the boundary quantize restores int8."""


class _QDQScales:
    """scale_zp(name) resolved from the nearest downstream qnn.quantize."""

    def __init__(self, graph: Graph, config: QConfig):
        self.g = graph
        self.config = config
        self.users = graph.users()
        self._cache: dict[str, tuple[float, int]] = {}

    def scale_zp(self, name: str) -> tuple[float, int]:
        if name in self._cache:
            return self._cache[name]
        seen = {name}
        frontier = [name]
        while frontier:
            nxt = []
            for cur in frontier:
                for u in self.users.get(cur, []):
                    un = self.g[u]
                    if un.op == "qnn.quantize":
                        sc = un.attrs["scale"]
                        if not np.ndim(sc):
                            res = (float(sc), int(un.attrs.get("zero_point", 0)))
                            self._cache[name] = res
                            return res
                    elif un.op in _SCALE_TRANSPARENT and u not in seen:
                        seen.add(u)
                        nxt.append(u)
            frontier = nxt
        raise ScaleUnresolved(
            f"FQ2I: no downstream qnn.quantize defines a scale for {name!r}")


class FQ2IQuantizer(Quantizer):
    def __init__(self, graph: Graph, config: QConfig | None = None):
        cfg = config or QConfig()
        super().__init__(graph, _QDQScales(infer_types(graph), cfg), cfg)

    # weights imported from QDQ carry their model scales as const attrs
    def quantize_weight(self, arr, per_channel, name):
        nd = self.g[name] if name in self.g else None
        if nd is not None and "qdq_scale" in nd.attrs:
            scales = np.asarray(nd.attrs["qdq_scale"], np.float64)
            if not nd.attrs.get("qdq_per_axis", False):
                scales = scales.reshape(())
            q = np.clip(np.rint(arr / scales), -128, 127).astype(self.cfg.weight_dtype)
            wname = self.b.const(q, name=name + "_qw")
            return wname, scales
        return super().quantize_weight(arr, per_channel, name)

    def _fq_dequantize(self, n: Node):
        """qnn.dequantize disappears: its input continues as 'quant'."""
        src = self.env[n.inputs[0]]
        a = n.attrs
        sc = a["scale"]
        if np.ndim(sc):
            # per-axis activation dequantize: keep as float island
            self._float_fallback_with_consts(n)
            return
        orig = self.g[n.inputs[0]] if n.inputs[0] in self.g else None
        if orig is not None and orig.is_const:
            # integer constant input: flows on as a quantized const
            arr = self.g.params[n.inputs[0]]
            cname = src.name or self.b.const(arr, name=n.inputs[0])
            self.env[n.name] = QVal("quant", cname, float(sc),
                                    int(a.get("zero_point", 0)), str(arr.dtype))
            return
        if src.kind == "float":
            # a float producer (shouldn't happen in QDQ graphs) — quantize it
            out = self.b.call("qnn.quantize", src.name, scale=float(sc),
                              zero_point=int(a.get("zero_point", 0)),
                              out_dtype=self.cfg.act_dtype, name=n.name + "_q")
            self.env[n.name] = QVal("quant", out, float(sc),
                                    int(a.get("zero_point", 0)), self.cfg.act_dtype)
            return
        self.env[n.name] = QVal(src.kind, src.name, float(sc),
                                int(a.get("zero_point", 0)),
                                src.dtype if src.kind == "quant" else src.dtype,
                                src.axis)

    def _fq_quantize(self, n: Node):
        """qnn.quantize becomes a requantize (or nothing when scales align)."""
        a = n.attrs
        sc = a.get("scale")
        if np.ndim(sc):
            self._float_fallback_with_consts(n)
            return
        scale = float(sc)
        zp = int(a.get("zero_point", 0))
        dtype = a.get("out_dtype", "int8")
        src = self.env[n.inputs[0]]
        if src.kind == "float":
            if src.name is None:  # const
                self._materialize_const_inputs(n)
                src = self.env[n.inputs[0]]
            out = self.b.call("qnn.quantize", src.name, scale=scale,
                              zero_point=zp, out_dtype=dtype, name=n.name)
            self.env[n.name] = QVal("quant", out, scale, zp, dtype)
            return
        if src.kind == "quant" and float(src.scale) == scale and src.zp == zp \
                and src.dtype == dtype:
            self.env[n.name] = src
            return
        in_scale = src.scale
        axis = -1
        if isinstance(in_scale, np.ndarray) and in_scale.ndim > 0:
            in_scale = [float(s) for s in in_scale]
            axis = src.axis
        else:
            in_scale = float(in_scale)
        out = self.b.call(
            "qnn.requantize", src.name,
            input_scale=in_scale, input_zero_point=src.zp,
            output_scale=scale, output_zero_point=zp,
            axis=axis, rounding=self.cfg.rounding, out_dtype=dtype,
            name=n.name,
        )
        self.env[n.name] = QVal("quant", out, scale, zp, dtype)

    def _make_handlers(self):
        handlers = super()._make_handlers()

        # ops inside a float-computed interior (no downstream quantize —
        # torch's fp32-computed hardswish gate, for example) fall back to
        # float; the boundary qnn.quantize restores int8 with the model's
        # own params
        def resilient(h):
            def run(n, h=h):
                try:
                    h(n)
                except ScaleUnresolved:
                    self._float_fallback_with_consts(n)
            return run

        handlers = {op: resilient(h) for op, h in handlers.items()}
        handlers["qnn.dequantize"] = self._fq_dequantize
        handlers["qnn.quantize"] = self._fq_quantize
        return handlers

    def run(self) -> Graph:
        # fallback after a partially-emitted handler can leave orphan
        # coercion nodes in `self.b`; DCE removes them
        return infer_types(super().run().dead_code_eliminate())


def fq2i(graph: Graph, config: QConfig | None = None) -> Graph:
    """Rewrite a QDQ-imported graph into an integer-only graph using the
    model's own quantization parameters (no calibration)."""
    return FQ2IQuantizer(graph, config).run()
