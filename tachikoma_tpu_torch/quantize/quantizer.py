"""Quantizer — rewrite a calibrated float graph into an integer-only graph
(port of `tachikoma_tpu/quantize/quantizer.py`).

The port carries the JAX package's handlers, copied, so its output equals the
JAX package's byte for byte: conv2d, dense, batch_matmul, bias_add, relu,
clip, add, subtract, multiply, concatenate, avg_pool2d (qnn.avg_pool2d, the
input's scale and zero point passed through), global_avg_pool2d,
adaptive_avg_pool2d, pad, the integer softmax, the LUT ops, layer_norm and
the passthrough ops it registers.

Strategy: one topological walk.  Each original node maps to a QVal — a value
in the new graph tagged with its numeric representation:

  float : plain float tensor
  quant : integer tensor (int8/uint8) with (scale, zero_point)
  accum : int32 accumulator with per-channel scale vector (conv/dense output
          before requantize; bias adds fold in here)

Ops with integer rules rewrite to qnn.* ops; anything else falls back to
dequantize -> float op -> (re)quantize at the next integer consumer, so the
rewrite is total over the op vocabulary (mirroring how the reference's
partial quantization keeps unsupported ops in float).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..ir.graph import CONST, TUPLE, TUPLE_GET_ITEM, VAR, Graph, GraphBuilder, Node
from ..ir.infer import infer_types
from ..ir.registry import has_op
from ..ir.transforms import simplify
from ..ops.nn import _pair
from ..utils import dtypes as dt
from .calibrate import CalibrationResult, calibrate
from .config import QConfig

# Ops whose integer form is the same op applied to the quantized tensor
# (scale/zp unchanged); the JAX package's set, of which the port handles the
# ops it registers.
_PASSTHROUGH = {
    "reshape", "transpose", "squeeze", "expand_dims", "nn.batch_flatten",
    "strided_slice", "split", "tile", "broadcast_to", "copy", "nn.dropout",
    "nn.max_pool2d", "nn.global_max_pool2d", "nn.depth_to_space", "nn.space_to_depth",
    "image.resize2d",
}


@dataclass
class QVal:
    kind: str                      # "float" | "quant" | "accum"
    name: str                      # node name in the new graph
    scale: float | np.ndarray = 1.0
    zp: int = 0
    dtype: str = "float32"
    axis: int = -1                 # channel axis for per-channel accum scale


class Quantizer:
    def __init__(self, graph: Graph, calib: CalibrationResult, config: QConfig | None = None):
        self.g = infer_types(graph)
        self.calib = calib
        self.cfg = config or calib.config
        self.b = GraphBuilder(self.g.name + "_int8")
        self.env: dict[str, QVal] = {}
        self._wgroups: dict[str, np.ndarray] | None = None  # scale_group

    # -- representation coercions -------------------------------------------

    def act_qparams(self, orig_name: str) -> tuple[float, int]:
        return self.calib.scale_zp(orig_name)

    def to_quant(self, orig_name: str) -> QVal:
        """Coerce a value to int8 'quant' representation."""
        v = self.env[orig_name]
        cfg = self.cfg
        if v.kind == "quant":
            return v
        orig = self.g[orig_name] if orig_name in self.g else None
        if v.kind == "float" and orig is not None and orig.is_const:
            # constants quantize directly from their values (no calibration)
            arr = self.g.params[orig_name]
            lim = dt.qmax(cfg.act_dtype)
            scale = max(float(np.abs(arr).max()) / lim, 1e-8)
            q = np.clip(np.rint(arr / scale), -lim, lim).astype(cfg.act_dtype)
            name = self.b.const(q, name=orig_name + "_q")
            qv = QVal("quant", name, scale, 0, cfg.act_dtype)
            self.env[orig_name] = qv
            return qv
        if v.kind == "float":
            scale, zp = self.act_qparams(orig_name)
            name = self.b.call(
                "qnn.quantize", v.name, scale=scale, zero_point=zp,
                out_dtype=cfg.act_dtype, name=v.name + "_q",
            )
            q = QVal("quant", name, scale, zp, cfg.act_dtype)
        else:  # accum -> requantize to the node's calibrated activation scale
            scale, zp = self.act_qparams(orig_name)
            in_scale = v.scale
            if isinstance(in_scale, np.ndarray) and in_scale.ndim > 0:
                in_scale = [float(s) for s in in_scale]
                axis = v.axis
            else:
                in_scale = float(in_scale)
                axis = -1
            name = self.b.call(
                "qnn.requantize", v.name,
                input_scale=in_scale, input_zero_point=v.zp,
                output_scale=scale, output_zero_point=zp,
                axis=axis, rounding=cfg.rounding, out_dtype=cfg.act_dtype,
                name=v.name + "_rq",
            )
            q = QVal("quant", name, scale, zp, cfg.act_dtype)
        self.env[orig_name] = q
        return q

    def to_float(self, orig_name: str) -> QVal:
        v = self.env[orig_name]
        if v.kind == "float":
            return v
        if v.kind == "accum":
            v = self.to_quant(orig_name)
        name = self.b.call(
            "qnn.dequantize", v.name, scale=float(np.asarray(v.scale).max()) if np.ndim(v.scale) else float(v.scale),
            zero_point=v.zp, name=v.name + "_dq",
        )
        f = QVal("float", name)
        self.env[orig_name] = f
        return f

    # -- weight/bias quantization -------------------------------------------

    def quantize_weight(self, arr: np.ndarray, per_channel: bool, name: str):
        """Symmetric int8 weight quantization; channel = last axis (HWIO/KN).

        With cfg.scale_group, the absmax is pooled across same-shaped
        weights whose names differ only in the grouped part, so sibling
        layers share identical scale vectors (-> identical requantize
        attrs -> scan-compilable segments)."""
        qmax = 127
        if per_channel and arr.ndim >= 2:
            red = tuple(range(arr.ndim - 1))
            absmax = np.maximum(np.abs(arr).max(axis=red), 1e-8)
        else:
            absmax = np.maximum(np.abs(arr).max(), 1e-8)
        pooled = self._weight_group_absmax(name, arr, per_channel)
        if pooled is not None:
            absmax = np.maximum(pooled, 1e-8)
        scales = (absmax / qmax).astype(np.float64)
        q = np.clip(np.rint(arr / scales), -127, 127).astype(self.cfg.weight_dtype)
        wname = self.b.const(q, name=name + "_qw")
        return wname, scales

    def _weight_group_absmax(self, name: str, arr: np.ndarray,
                             per_channel: bool):
        if not self.cfg.scale_group:
            return None
        if self._wgroups is None:
            import re

            pat = re.compile(self.cfg.scale_group)
            groups: dict[tuple, list[str]] = {}
            for pname, pv in self.g.params.items():
                key = (pat.sub("<G>", pname), pv.shape)
                groups.setdefault(key, []).append(pname)
            self._wgroups = {}
            for (key, shape), members in groups.items():
                if len(members) < 2:
                    continue
                mats = [self.g.params[m] for m in members]
                if per_channel and mats[0].ndim >= 2:
                    red = tuple(range(mats[0].ndim - 1))
                    am = np.max([np.abs(m).max(axis=red) for m in mats],
                                axis=0)
                else:
                    am = max(float(np.abs(m).max()) for m in mats)
                for m in members:
                    self._wgroups[m] = am
        return self._wgroups.get(name)

    # -- op handlers ---------------------------------------------------------

    def _conv_dense(self, n: Node):
        data = self.to_quant(n.inputs[0])
        w = self.g.params[n.inputs[1]]
        wname, wscales = self.quantize_weight(
            w, self.cfg.weight_per_channel, n.inputs[1]
        )
        attrs = {k: v for k, v in n.attrs.items() if k != "out_dtype"}
        op = "qnn.conv2d" if n.op == "nn.conv2d" else "qnn.dense"
        out = self.b.call(
            op, data.name, wname,
            input_zero_point=data.zp, kernel_zero_point=0,
            out_dtype=self.cfg.accum_dtype, name=n.name, **attrs,
        )
        accum_scale = np.asarray(data.scale, dtype=np.float64) * np.asarray(wscales)
        # channel axis is the LAST axis for both conv (NHWC) and dense (...N)
        self.env[n.name] = QVal("accum", out, accum_scale, 0, self.cfg.accum_dtype, axis=-1)

    def _bias_add(self, n: Node):
        src = self.env[n.inputs[0]]
        bias = self.g.params.get(n.inputs[1])
        if src.kind == "accum" and bias is not None:
            binfo = np.iinfo(np.dtype(self.cfg.bias_dtype))
            bq = np.clip(
                np.rint(bias.astype(np.float64) / np.asarray(src.scale)),
                binfo.min, binfo.max,
            ).astype(self.cfg.bias_dtype)
            bname = self.b.const(bq, name=n.inputs[1] + "_qb")
            out = self.b.call("nn.bias_add", src.name, bname, name=n.name,
                              axis=int(n.attrs.get("axis", -1)))
            self.env[n.name] = QVal("accum", out, src.scale, src.zp, src.dtype, src.axis)
        else:
            self._float_fallback_with_consts(n)

    def _relu(self, n: Node):
        src = self.env[n.inputs[0]]
        if src.kind == "quant":
            lo = src.zp
            hi = dt.qmax(src.dtype)
            out = self.b.call("clip", src.name, a_min=lo, a_max=hi, name=n.name)
            self.env[n.name] = QVal("quant", out, src.scale, src.zp, src.dtype)
        elif src.kind == "accum":
            out = self.b.call("clip", src.name, a_min=0, a_max=dt.qmax(self.cfg.accum_dtype), name=n.name)
            self.env[n.name] = QVal("accum", out, src.scale, src.zp, src.dtype, src.axis)
        else:
            self._float_fallback(n)

    def _clip(self, n: Node):
        src = self.env[n.inputs[0]]
        if src.kind == "quant":
            s = float(src.scale)
            a_min = int(np.rint(float(n.attrs["a_min"]) / s)) + src.zp
            a_max = int(np.rint(float(n.attrs["a_max"]) / s)) + src.zp
            a_min = max(a_min, dt.qmin(src.dtype))
            a_max = min(a_max, dt.qmax(src.dtype))
            out = self.b.call("clip", src.name, a_min=a_min, a_max=a_max, name=n.name)
            self.env[n.name] = QVal("quant", out, src.scale, src.zp, src.dtype)
        elif src.kind == "accum":
            # clip bounds scale per-channel; requantize to int8 first
            self.to_quant(n.inputs[0])
            self._clip(n)
        else:
            self._float_fallback(n)

    def _batch_matmul(self, n: Node):
        a = self.to_quant(n.inputs[0])
        bqv = self.to_quant(n.inputs[1])
        out = self.b.call(
            "qnn.batch_matmul", a.name, bqv.name,
            lhs_zero_point=a.zp, rhs_zero_point=bqv.zp,
            out_dtype=self.cfg.accum_dtype, name=n.name,
            **{k: v for k, v in n.attrs.items() if k in ("transpose_a", "transpose_b")},
        )
        accum_scale = float(a.scale) * float(bqv.scale)
        self.env[n.name] = QVal("accum", out, accum_scale, 0, self.cfg.accum_dtype)

    def _scalar_const(self, name: str) -> float | None:
        nd = self.g[name] if name in self.g else None
        if nd is not None and nd.is_const and self.g.params[name].size == 1:
            return float(self.g.params[name].reshape(()))
        return None

    def _binary(self, n: Node, qop: str):
        # scale folding: multiplying a quantized tensor by a positive scalar
        # constant only rescales its quantization scale — zero runtime ops
        if qop == "qnn.mul":
            for ti, ci in ((0, 1), (1, 0)):
                cval = self._scalar_const(n.inputs[ci])
                src = self.env[n.inputs[ti]]
                if cval is not None and cval > 0 and src.kind in ("quant", "accum"):
                    self.env[n.name] = QVal(
                        src.kind, src.name,
                        np.asarray(src.scale) * cval if np.ndim(src.scale) else float(src.scale) * cval,
                        src.zp, src.dtype, src.axis,
                    )
                    return
        # qnn.add / qnn.subtract / qnn.mul with calibrated output qparams
        a = self.to_quant(n.inputs[0])
        c = self.to_quant(n.inputs[1])
        oscale, ozp = self.act_qparams(n.name)
        out = self.b.call(
            qop, a.name, c.name,
            lhs_scale=float(a.scale), lhs_zero_point=a.zp,
            rhs_scale=float(c.scale), rhs_zero_point=c.zp,
            output_scale=oscale, output_zero_point=ozp,
            rounding=self.cfg.rounding, out_dtype=self.cfg.act_dtype, name=n.name,
        )
        self.env[n.name] = QVal("quant", out, oscale, ozp, self.cfg.act_dtype)

    def _concat(self, n: Node):
        vals = [self.to_quant(i) for i in n.inputs]
        oscale, ozp = self.act_qparams(n.name)
        out = self.b.call(
            "qnn.concatenate", *[v.name for v in vals],
            input_scales=[float(v.scale) for v in vals],
            input_zero_points=[v.zp for v in vals],
            output_scale=oscale, output_zero_point=ozp,
            rounding=self.cfg.rounding, out_dtype=self.cfg.act_dtype,
            axis=int(n.attrs.get("axis", 0)), name=n.name,
        )
        self.env[n.name] = QVal("quant", out, oscale, ozp, self.cfg.act_dtype)

    def _avg_pool(self, n: Node):
        src = self.env[n.inputs[0]]
        if src.kind != "quant":
            src = self.to_quant(n.inputs[0])
        out = self.b.call(
            "qnn.avg_pool2d", src.name,
            input_scale=float(src.scale), input_zero_point=src.zp,
            output_scale=float(src.scale), output_zero_point=src.zp,
            rounding=self.cfg.rounding, out_dtype=src.dtype, name=n.name,
            **{k: v for k, v in n.attrs.items()},
        )
        self.env[n.name] = QVal("quant", out, src.scale, src.zp, src.dtype)

    def _global_avg_pool(self, n: Node):
        # the integer mean rounds identically in the raw quantized domain
        # for any zero point (q_out = round(mean(q_in)) carries <= 0.5 LSB
        # error whether or not zp is 0), so scale AND zp pass through
        src = self.env[n.inputs[0]]
        if src.kind != "quant":
            src = self.to_quant(n.inputs[0])
        out = self.b.call("nn.global_avg_pool2d", src.name, name=n.name, **dict(n.attrs))
        self.env[n.name] = QVal("quant", out, src.scale, src.zp, src.dtype)

    def _adaptive_avg_pool(self, n: Node):
        # adaptive pool to (1,1) == global avg pool (zp passes through, see
        # _global_avg_pool)
        src = self.env[n.inputs[0]]
        if _pair(n.attrs["output_size"]) == (1, 1) and src.kind != "float":
            src = self.to_quant(n.inputs[0])
            out = self.b.call("nn.adaptive_avg_pool2d", src.name, name=n.name, **dict(n.attrs))
            self.env[n.name] = QVal("quant", out, src.scale, src.zp, src.dtype)
            return
        self._float_fallback(n)

    def _passthrough(self, n: Node):
        src = self.env[n.inputs[0]]
        if src.kind == "float":
            self._float_fallback(n)
            return
        if src.kind == "accum" and n.op == "strided_slice":
            # a LAST-axis slice maps 1:1 onto the per-channel scale vector:
            # keep the accumulator domain (merged-QKV splits stay exact)
            shape = self.g[n.inputs[0]].shape
            begin = list(n.attrs.get("begin", []))
            end = list(n.attrs.get("end", []))
            strides = list(n.attrs.get("strides", [1] * len(begin)))
            if (shape is not None and len(begin) == len(shape)
                    and all(int(st) == 1 for st in strides)
                    and all(int(b) == 0 and int(e) >= shape[i]
                            for i, (b, e) in enumerate(zip(begin[:-1], end[:-1])))):
                lo, hi = int(begin[-1]), int(end[-1])
                sc = src.scale
                if isinstance(sc, np.ndarray) and sc.ndim > 0:
                    sc = sc[lo:hi]
                out = self.b.call(n.op, src.name, name=n.name, **dict(n.attrs))
                self.env[n.name] = QVal("accum", out, sc, src.zp, src.dtype,
                                        src.axis)
                return
        if src.kind == "accum":
            # per-channel accum scales don't survive axis-moving ops;
            # requantize to int8 first (scalar scale) to stay safe
            src = self.to_quant(n.inputs[0])
        out = self.b.call(n.op, src.name, name=n.name, **dict(n.attrs))
        self.env[n.name] = QVal(src.kind, out, src.scale, src.zp, src.dtype, src.axis)

    def _pad(self, n: Node):
        src = self.env[n.inputs[0]]
        if src.kind == "quant" and float(n.attrs.get("pad_value", 0)) == 0.0:
            attrs = dict(n.attrs)
            attrs["pad_value"] = src.zp
            out = self.b.call("nn.pad", src.name, name=n.name, **attrs)
            self.env[n.name] = QVal("quant", out, src.scale, src.zp, src.dtype)
        else:
            self._float_fallback(n)

    def _softmax(self, n: Node):
        src = self.env[n.inputs[0]]
        if not self.cfg.integer_softmax or src.kind == "float":
            self._float_fallback(n)
            return
        from ..ops.qnn import SOFTMAX_OUT_SCALE, SOFTMAX_OUT_ZP

        src = self.to_quant(n.inputs[0])
        out = self.b.call(
            "qnn.softmax", src.name,
            input_scale=float(src.scale), axis=int(n.attrs.get("axis", -1)),
            out_dtype=self.cfg.act_dtype, name=n.name,
        )
        self.env[n.name] = QVal("quant", out, SOFTMAX_OUT_SCALE, SOFTMAX_OUT_ZP, self.cfg.act_dtype)

    def _lut_unary(self, n: Node):
        src = self.env[n.inputs[0]]
        if src.kind == "float":
            self._float_fallback(n)
            return
        from ..ir.registry import get_op
        from ..ops.qnn import build_lut

        src = self.to_quant(n.inputs[0])
        oscale, ozp = self.act_qparams(n.name)
        np_fn = get_op(n.op).np_impl

        def f(x):
            return np_fn(x, node=n)

        table = build_lut(f, float(src.scale), src.zp, oscale, ozp)
        out = self.b.call(
            "qnn.lut", src.name, table=[int(v) for v in table],
            out_dtype=self.cfg.act_dtype, name=n.name,
        )
        self.env[n.name] = QVal("quant", out, oscale, ozp, self.cfg.act_dtype)

    def _layer_norm(self, n: Node):
        """nn.layer_norm -> qnn.layer_norm with pinned integer semantics
        (ops/qnn.py).  Falls back when gamma/beta aren't constants or the
        axis isn't the last dimension."""
        src = self.env[n.inputs[0]]
        axis = int(n.attrs.get("axis", -1))
        shape = self.g[n.inputs[0]].shape
        if (src.kind == "float"
                or shape is None
                or axis not in (-1, len(shape) - 1)
                or n.inputs[1] not in self.g.params
                or n.inputs[2] not in self.g.params):
            self._float_fallback(n)
            return
        from ..ops.qnn import plan_layer_norm

        src = self.to_quant(n.inputs[0])
        gamma = self.g.params[n.inputs[1]]
        beta = self.g.params[n.inputs[2]]
        oscale, ozp = self.act_qparams(n.name)
        attrs = plan_layer_norm(gamma, beta, float(src.scale), src.zp,
                                oscale, ozp, int(shape[-1]))
        attrs["out_dtype"] = self.cfg.act_dtype
        out = self.b.call("qnn.layer_norm", src.name, name=n.name, **attrs)
        self.env[n.name] = QVal("quant", out, oscale, ozp, self.cfg.act_dtype)

    def _float_fallback(self, n: Node):
        ins = [self.to_float(i).name for i in n.inputs]
        out = self.b.call(n.op, *ins, name=n.name, **dict(n.attrs))
        self.env[n.name] = QVal("float", out)

    # -- the walk ------------------------------------------------------------

    def _make_handlers(self) -> dict:
        cfg = self.cfg
        handlers: dict[str, Callable[[Node], None]] = {
            "nn.conv2d": self._conv_dense,
            "nn.dense": self._conv_dense,
            "nn.batch_matmul": self._batch_matmul,
            "nn.bias_add": self._bias_add,
            "nn.relu": self._relu,
            "clip": self._clip,
            "add": lambda n: self._binary(n, "qnn.add"),
            "subtract": lambda n: self._binary(n, "qnn.subtract"),
            "multiply": lambda n: self._binary(n, "qnn.mul"),
            "concatenate": self._concat,
            "nn.avg_pool2d": self._avg_pool,
            "nn.global_avg_pool2d": self._global_avg_pool,
            "nn.adaptive_avg_pool2d": self._adaptive_avg_pool,
            "nn.pad": self._pad,
        }
        if cfg.integer_softmax:
            handlers["nn.softmax"] = self._softmax
        if getattr(cfg, "integer_layer_norm", False):
            handlers["nn.layer_norm"] = self._layer_norm
        for op in cfg.lut_ops:
            handlers[op] = self._lut_unary
        for op in _PASSTHROUGH - set(handlers):
            if has_op(op):
                handlers[op] = self._passthrough
        return handlers

    def run(self) -> Graph:
        cfg = self.cfg
        handlers = self._make_handlers()
        for n in self.g.nodes:
            if n.op == VAR:
                name = self.b.var(n.name, n.shape, n.dtype)
                self.env[n.name] = QVal("float", name)
            elif n.op == CONST:
                arr = self.g.params[n.name]
                # consts are materialized lazily at use sites (weights/bias);
                # float consts used by fallback ops get copied on demand
                self.env[n.name] = QVal("float", None)  # type: ignore[arg-type]
            elif n.op == TUPLE or n.op == TUPLE_GET_ITEM:
                self._structural(n)
            else:
                h = handlers.get(n.op)
                if h is not None and n.op in ("nn.conv2d", "nn.dense"):
                    # only quantize when weight is const
                    if self.g[n.inputs[1]].is_const:
                        self._materialize_const_inputs(n, skip={n.inputs[1]})
                        h(n)
                    else:
                        self._float_fallback_with_consts(n)
                elif h is not None and n.op == "nn.bias_add":
                    self._materialize_const_inputs(n, skip={n.inputs[1]})
                    h(n)
                elif h is not None and n.op not in cfg.float_ops:
                    self._materialize_const_inputs(n)
                    h(n)
                else:
                    self._float_fallback_with_consts(n)

        outputs = []
        for o in self.g.outputs:
            v = self.env[o]
            if v.kind != "float" and cfg.dequantize_outputs:
                v = self.to_float(o)
            elif v.kind == "accum":
                v = self.to_quant(o)
            outputs.append(v.name)
        return infer_types(self.b.build(outputs))

    def _structural(self, n: Node):
        # tuples only appear around float subgraphs in practice
        ins = [self.to_float(i).name if self.env[i].kind != "float" else self.env[i].name
               for i in n.inputs]
        out = self.b.call(n.op, *ins, name=n.name, **dict(n.attrs))
        self.env[n.name] = QVal("float", out)

    def _materialize_const_inputs(self, n: Node, skip: set | None = None):
        for i in n.inputs:
            if self.g[i].is_const and self.env[i].name is None and (not skip or i not in skip):
                self.env[i] = QVal("float", self.b.const(self.g.params[i], name=i))

    def _float_fallback_with_consts(self, n: Node):
        self._materialize_const_inputs(n)
        self._float_fallback(n)


def quantize(
    graph: Graph,
    dataset,
    config: QConfig = QConfig(),
    pre_simplify: bool = True,
) -> Graph:
    """One-call flow: simplify -> calibrate -> rewrite to integer graph.

    The counterpart of `relay.quantize.quantize`
    (`python/tvm/relay/quantize/quantize.py:333`)."""
    g = simplify(graph) if pre_simplify else infer_types(graph)
    calib = calibrate(g, dataset, config)
    return Quantizer(g, calib, config).run()
