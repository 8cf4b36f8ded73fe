"""ONNX frontend: ModelProto -> Graph (port of
`tachikoma_tpu/frontend/onnx.py`, converter for converter).

The counterpart of `relay.frontend.from_onnx`, on the in-tree protobuf codec
(onnx_proto.py).  Conv-domain tensors ride in NHWC (the 'nhwc' layout tag);
shape-sensitive ops coerce back to ONNX layout ('onnx' tag) with a
`transpose`.  Shape-computation subgraphs (Shape / Gather / Unsqueeze /
Concat feeding Reshape: the dynamic-reshape idiom) and other all-constant
arithmetic fold at import time, since graphs are static-shape.

QuantizeLinear / DequantizeLinear / QLinearConv / QLinearMatMul import as
the JAX importer imports them: quantize and dequantize nodes around float
ops, the dequantized weights folded to float and annotated with their model
scales.  FQ2I (`quantize/fq2i.py fq2i`) then turns those islands into
integer ops at the model's own scales and its exact int8 weights.

The graph is the JAX importer's, byte for byte (`Graph.to_json`), so every
op a converter emits has its relation, oracle and torch impl in the port's
ops/ (nn.py, extra.py, tail.py, tail3.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types
from .onnx_proto import ONNX_DTYPES, load_model, tensor_to_np


def _attr_map(node: dict) -> dict[str, Any]:
    out = {}
    for a in node.get("attribute", []):
        name = a["name"]
        if "i" in a:
            out[name] = a["i"]
        elif "f" in a:
            out[name] = a["f"]
        elif "s" in a:
            v = a["s"]
            out[name] = v.decode() if isinstance(v, (bytes, bytearray)) else v
        elif "ints" in a:
            out[name] = list(a["ints"])
        elif "floats" in a:
            out[name] = list(a["floats"])
        elif "t" in a:
            out[name] = tensor_to_np(a["t"])
        else:
            out[name] = None
    return out


class _OnnxImporter:
    def __init__(self, model: dict, input_shapes: dict | None):
        self.graph_proto = model["graph"]
        self.b = GraphBuilder(self.graph_proto.get("name", "from_onnx") or "from_onnx")
        # onnx value name -> (graph name | np const, layout)
        self.env: dict[str, tuple[Any, str]] = {}
        self.consts: dict[str, np.ndarray] = {}
        self.input_shapes = dict(input_shapes or {})
        # onnx value name -> (scale array, zp array, axis, per_axis) for
        # constants that came through QuantizeLinear/DequantizeLinear
        self.qdq_info: dict[str, tuple] = {}

    # -- value plumbing -----------------------------------------------------
    def val(self, name: str) -> tuple[str, str]:
        v, layout = self.env[name]
        if isinstance(v, np.ndarray):  # materialize lazily-kept constant
            cn = self.b.const(v, name=name[:40] or None)
            self.env[name] = (cn, "onnx")
            return cn, "onnx"
        return v, layout

    def const_value(self, name: str) -> np.ndarray | None:
        """Constant value if statically known (for shape-op folding)."""
        if name in self.consts:
            return self.consts[name]
        v, _ = self.env.get(name, (None, None))
        return v if isinstance(v, np.ndarray) else None

    def as_onnx(self, name: str) -> str:
        v, layout = self.val(name)
        if layout == "nhwc":
            v = self.b.call("transpose", v, axes=(0, 3, 1, 2))
            self.env[name] = (v, "onnx")
        return v

    def as_nhwc(self, name: str) -> str:
        v, layout = self.val(name)
        if layout == "onnx":
            v = self.b.call("transpose", v, axes=(0, 2, 3, 1))
            self.env[name] = (v, "nhwc")
        return v

    def set(self, name: str, graph_name: str, layout: str):
        self.env[name] = (graph_name, layout)

    def shape_of(self, name: str) -> tuple[int, ...]:
        v, layout = self.val(name)
        g = infer_types(self.b.build([v]))
        shape = g[v].shape
        if layout == "nhwc":  # report ONNX-layout shape
            n, h, w, c = shape
            return (n, c, h, w)
        return shape

    # -- the walk over the graph --------------------------------------------
    def run(self) -> Graph:
        gp = self.graph_proto
        for t in gp.get("initializer", []):
            arr = tensor_to_np(t)
            self.env[t["name"]] = (arr, "onnx")
            self.consts[t["name"]] = arr
        init_names = set(self.consts)
        for vi in gp.get("input", []):
            name = vi["name"]
            if name in init_names:
                continue
            shape, dtype = self._vi_shape(vi, name)
            self.set(name, self.b.var(name, shape, dtype), "onnx")
        for node in gp.get("node", []):
            self.convert(node)
        outs = [self.as_onnx(o["name"]) for o in gp.get("output", [])]
        return infer_types(self.b.build(outs))

    def _vi_shape(self, vi: dict, name: str):
        if name in self.input_shapes:
            sh = self.input_shapes[name]
            dt = "float32"
            if isinstance(sh, tuple) and len(sh) == 2 and isinstance(sh[1], str):
                sh, dt = sh
            return tuple(sh), dt
        tt = vi.get("type", {}).get("tensor_type", {})
        dtype = ONNX_DTYPES.get(tt.get("elem_type", 1), "float32")
        dims = []
        for d in tt.get("shape", {}).get("dim", []):
            if "dim_value" in d:
                dims.append(int(d["dim_value"]))
            else:
                raise ValueError(
                    f"input {name} has symbolic dim {d.get('dim_param')!r}; "
                    f"pass input_shapes={{{name!r}: (...)}}"
                )
        return tuple(dims), dtype

    # -- converters ---------------------------------------------------------
    def convert(self, node: dict):
        op = node["op_type"]
        attrs = _attr_map(node)
        ins = node.get("input", [])
        outs = node.get("output", [])
        h = getattr(self, f"op_{op}", None)
        if h is None:
            raise NotImplementedError(f"ONNX op {op} not supported")
        h(ins, outs, attrs)

    def _unary(self, ins, outs, tk_op, **extra):
        v, layout = self.val(ins[0])
        self.set(outs[0], self.b.call(tk_op, v, **extra), layout)

    def op_Relu(self, ins, outs, attrs):
        self._unary(ins, outs, "nn.relu")

    def op_Sigmoid(self, ins, outs, attrs):
        self._unary(ins, outs, "sigmoid")

    def op_Tanh(self, ins, outs, attrs):
        self._unary(ins, outs, "tanh")

    def op_Erf(self, ins, outs, attrs):
        self._unary(ins, outs, "erf")

    def op_Sqrt(self, ins, outs, attrs):
        self._unary(ins, outs, "sqrt")

    def op_Exp(self, ins, outs, attrs):
        self._unary(ins, outs, "exp")

    def op_Identity(self, ins, outs, attrs):
        self.env[outs[0]] = self.env[ins[0]]

    def op_Dropout(self, ins, outs, attrs):
        self.env[outs[0]] = self.env[ins[0]]

    def op_Gelu(self, ins, outs, attrs):
        self._unary(ins, outs, "nn.gelu", approximate=attrs.get("approximate", "none"))

    def op_LeakyRelu(self, ins, outs, attrs):
        self._unary(ins, outs, "nn.leaky_relu", alpha=attrs.get("alpha", 0.01))

    def op_Clip(self, ins, outs, attrs):
        lo = attrs.get("min")
        hi = attrs.get("max")
        if len(ins) > 1 and ins[1]:
            lo = float(self.const_value(ins[1]))
        if len(ins) > 2 and ins[2]:
            hi = float(self.const_value(ins[2]))
        self._unary(ins, outs, "clip",
                    a_min=lo if lo is not None else -3.4e38,
                    a_max=hi if hi is not None else 3.4e38)

    # -- QDQ / prequantized import ------------------------------------------
    # QuantizeLinear/DequantizeLinear pairs import as qnn.quantize/dequantize
    # nodes; dequantized weight constants fold to float but carry their model
    # scales as const-node attrs (qdq_scale/qdq_per_axis) so that FQ2I
    # (quantize/fq2i.py) recovers the exact int8 weights, as Relay's
    # FakeQuantizationToInteger does.

    def _mark_qdq(self, const_name: str, onnx_name: str, last_axis_was: int):
        """Mark an imported weight const with its model quantization scales.
        last_axis_was: which ORIGINAL axis ended up last after any layout
        transpose (per-axis scales must live on the last axis)."""
        info = self.qdq_info.get(onnx_name)
        if info is None:
            return
        scale, zp, axis, per_axis = info
        if per_axis and axis != last_axis_was:
            return  # channel axis didn't land on the last dim; skip marking
        if np.any(np.asarray(zp) != 0):
            return  # integer kernels assume symmetric weights
        self.b.annotate(
            const_name,
            qdq_scale=[float(s) for s in np.atleast_1d(scale)],
            qdq_per_axis=bool(per_axis),
        )

    def op_QuantizeLinear(self, ins, outs, attrs):
        scale = self.const_value(ins[1])
        zp = self.const_value(ins[2]) if len(ins) > 2 and ins[2] else None
        out_dtype = str(zp.dtype) if zp is not None else "int8"
        per_axis = scale.ndim > 0 and scale.size > 1
        zp_v = int(np.atleast_1d(zp)[0]) if (zp is not None and not per_axis) else (
            [int(v) for v in zp] if zp is not None else 0)
        xc = self.const_value(ins[0])
        if xc is not None:
            axis = int(attrs.get("axis", 1))
            s = np.asarray(scale, np.float32)
            z = np.asarray(zp if zp is not None else 0, np.int32)
            if per_axis:
                sh = [1] * xc.ndim
                sh[axis] = -1
                s = s.reshape(sh)
                z = z.reshape(sh) if z.ndim > 0 else z
            info = np.iinfo(np.dtype(out_dtype))
            q = np.clip(np.rint(xc.astype(np.float32) / s) + z,
                        info.min, info.max).astype(out_dtype)
            self.env[outs[0]] = (q, "onnx")
            self.consts[outs[0]] = q
            self.qdq_info[outs[0]] = (np.atleast_1d(scale), np.atleast_1d(
                zp if zp is not None else 0), int(attrs.get("axis", 1)), per_axis)
            return
        v, layout = self.val(ins[0])
        out = self.b.call(
            "qnn.quantize", v,
            scale=[float(s) for s in np.atleast_1d(scale)] if per_axis else float(scale),
            zero_point=zp_v, out_dtype=out_dtype,
            name=outs[0][:40] or None,
        )
        self.set(outs[0], out, layout)

    def op_DequantizeLinear(self, ins, outs, attrs):
        scale = self.const_value(ins[1])
        zp = self.const_value(ins[2]) if len(ins) > 2 and ins[2] else None
        per_axis = scale.ndim > 0 and scale.size > 1
        qc = self.const_value(ins[0])
        if qc is not None:
            # dequantized constant (weights/bias): fold to float, remember
            # the model scales for exact FQ2I recovery
            axis = int(attrs.get("axis", 1)) if per_axis else 0
            s = np.asarray(scale, np.float32)
            z = np.asarray(zp if zp is not None else 0, np.int32)
            if per_axis:
                sh = [1] * qc.ndim
                sh[axis] = -1
                s = s.reshape(sh)
                z = z.reshape(sh) if z.ndim > 0 else z
            wf = ((qc.astype(np.int64) - z).astype(np.float32) * s).astype(np.float32)
            self.env[outs[0]] = (wf, "onnx")
            self.consts[outs[0]] = wf
            self.qdq_info[outs[0]] = (np.atleast_1d(scale), np.atleast_1d(
                zp if zp is not None else 0), axis, per_axis)
            return
        v, layout = self.val(ins[0])
        zp_v = int(np.atleast_1d(zp)[0]) if (zp is not None and not per_axis) else (
            [int(x) for x in zp] if zp is not None else 0)
        out = self.b.call(
            "qnn.dequantize", v,
            scale=[float(s) for s in np.atleast_1d(scale)] if per_axis else float(scale),
            zero_point=zp_v,
            name=outs[0][:40] or None,
        )
        self.set(outs[0], out, layout)

    def op_QLinearConv(self, ins, outs, attrs):
        """QLinearConv decomposes to dequantize -> Conv -> quantize; FQ2I
        then reconstitutes the integer conv with the model's scales."""
        x_s, x_zp = self.const_value(ins[1]), self.const_value(ins[2])
        y_s, y_zp = self.const_value(ins[6]), self.const_value(ins[7])
        dq_x = f"{outs[0]}__dqx"
        self.op_DequantizeLinear([ins[0], ins[1], ins[2]], [dq_x], {})
        dq_w = f"{outs[0]}__dqw"
        self.op_DequantizeLinear([ins[3], ins[4], ins[5]], [dq_w], {"axis": 0})
        conv_out = f"{outs[0]}__conv"
        conv_ins = [dq_x, dq_w]
        if len(ins) > 8 and ins[8]:
            bq = self.const_value(ins[8])  # int32, scale = x_s * w_s
            ws = np.atleast_1d(self.const_value(ins[4])).astype(np.float64)
            bf = (bq.astype(np.float64) * (float(np.atleast_1d(x_s)[0]) * ws)).astype(np.float32)
            dq_b = f"{outs[0]}__dqb"
            self.env[dq_b] = (bf, "onnx")
            self.consts[dq_b] = bf
            conv_ins.append(dq_b)
        self.op_Conv(conv_ins, [conv_out], attrs)
        self.op_QuantizeLinear([conv_out, ins[6], ins[7]], outs, {})

    def op_QLinearMatMul(self, ins, outs, attrs):
        dq_a = f"{outs[0]}__dqa"
        self.op_DequantizeLinear([ins[0], ins[1], ins[2]], [dq_a], {})
        dq_b = f"{outs[0]}__dqb"
        self.op_DequantizeLinear([ins[3], ins[4], ins[5]], [dq_b], {})
        mm = f"{outs[0]}__mm"
        self.op_MatMul([dq_a, dq_b], [mm], {})
        self.op_QuantizeLinear([mm, ins[6], ins[7]], outs, {})


    def _auto_pads(self, auto_pad, in_hw, ks, strides, dils, pads):
        """Resolve ONNX auto_pad (SAME_UPPER/SAME_LOWER/VALID) to explicit
        [t, l, b, r] pads (onnx spec: extra padding goes to the end for
        SAME_UPPER, to the beginning for SAME_LOWER)."""
        if auto_pad in ("NOTSET", None, ""):
            return pads
        if auto_pad == "VALID":
            return [0, 0, 0, 0]
        out = []
        for d in range(2):
            eff_k = (ks[d] - 1) * dils[d] + 1
            osz = -(-in_hw[d] // strides[d])
            total = max((osz - 1) * strides[d] + eff_k - in_hw[d], 0)
            if auto_pad == "SAME_UPPER":
                out.append((total // 2, total - total // 2))
            else:  # SAME_LOWER
                out.append((total - total // 2, total // 2))
        (pt, pb), (pl, pr) = out
        return [pt, pl, pb, pr]

    def op_Conv(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        w = self.const_value(ins[1])
        assert w is not None, "dynamic conv weights unsupported"
        groups = int(attrs.get("group", 1))
        w_hwio = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
        wn = self.b.const(w_hwio, name=ins[1][:40] + "_w")
        # OIHW axis 0 (out channels) lands on the last HWIO axis
        self._mark_qdq(wn, ins[1], last_axis_was=0)
        pads = attrs.get("pads", [0, 0, 0, 0])  # [t, l, b, r]
        strides = attrs.get("strides", [1, 1])
        dil = attrs.get("dilations", [1, 1])
        ap = attrs.get("auto_pad", "NOTSET")
        if ap not in ("NOTSET", None, ""):
            sh_ = self.shape_of(ins[0])  # ONNX layout (N, C, H, W)
            pads = self._auto_pads(ap, (sh_[2], sh_[3]), w.shape[2:4],
                                   strides, dil, pads)
        out = self.b.call(
            "nn.conv2d", x, wn,
            strides=tuple(strides), padding=(pads[0], pads[1], pads[2], pads[3]),
            dilation=tuple(dil), groups=groups,
        )
        if len(ins) > 2 and ins[2]:
            bn = self.b.const(self.const_value(ins[2]), name=ins[2][:40] + "_b")
            out = self.b.call("nn.bias_add", out, bn, axis=-1)
        self.set(outs[0], out, "nhwc")

    def op_Gemm(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        w = self.const_value(ins[1])
        assert w is not None
        alpha, beta = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)
        if attrs.get("transA"):
            x = self.b.call("transpose", x, axes=(1, 0))
        if attrs.get("transB", 0):
            w = w.T
        wn = self.b.const(np.ascontiguousarray(w * np.float32(alpha)), name=ins[1][:40] + "_w")
        if alpha == 1.0:
            # (N,K) axis 0 -> last after transB transpose; (K,N) axis 1 is last
            self._mark_qdq(wn, ins[1], last_axis_was=0 if attrs.get("transB", 0) else 1)
        out = self.b.call("nn.dense", x, wn)
        if len(ins) > 2 and ins[2]:
            bias = self.const_value(ins[2]) * np.float32(beta)
            out = self.b.call("nn.bias_add", out, self.b.const(bias), axis=-1)
        self.set(outs[0], out, "onnx")

    def op_MatMul(self, ins, outs, attrs):
        a = self.as_onnx(ins[0])
        bw = self.const_value(ins[1])
        if bw is not None and bw.ndim == 2:
            wn = self.b.const(np.ascontiguousarray(bw))
            self._mark_qdq(wn, ins[1], last_axis_was=1)
            out = self.b.call("nn.dense", a, wn)
        else:
            b2 = self.as_onnx(ins[1])
            out = self.b.call("nn.batch_matmul", a, b2)
        self.set(outs[0], out, "onnx")

    def _binary(self, ins, outs, op):
        av = self.const_value(ins[0])
        bv = self.const_value(ins[1])
        if av is not None and bv is not None:
            # fold shape arithmetic eagerly
            fold = {"add": np.add, "subtract": np.subtract, "multiply": np.multiply,
                    "divide": lambda a, b: a // b if a.dtype.kind in "iu" else a / b}[op](av, bv)
            self.env[outs[0]] = (fold, "onnx")
            self.consts[outs[0]] = fold
            return
        la = self.env[ins[0]][1] if av is None else None
        lb = self.env[ins[1]][1] if bv is None else None
        if la is not None and lb is not None and la != lb:
            a, b2 = self.as_onnx(ins[0]), self.as_onnx(ins[1])
            layout = "onnx"
        else:
            layout = la or lb
            a, _ = self.val(ins[0])
            b2, _ = self.val(ins[1])
            # channel-vector broadcast against NHWC needs no reshape (C last);
            # against NCHW-style (1, C, 1, 1) constants flatten to (C,)
            if layout == "nhwc":
                for nm, vv in ((ins[0], av), (ins[1], bv)):
                    chan_vec = vv is not None and (
                        (vv.ndim == 4 and vv.shape[0] == 1 and vv.shape[2:] == (1, 1))
                        or (vv.ndim == 3 and vv.shape[1:] == (1, 1))  # opset<7 (C,1,1)
                    )
                    if chan_vec:
                        squeezed = vv.reshape(1, 1, 1, -1)
                        cn = self.b.const(squeezed)
                        if nm == ins[0]:
                            a = cn
                        else:
                            b2 = cn
        out = self.b.call(op, a, b2)
        self.set(outs[0], out, layout or "onnx")

    def op_Add(self, ins, outs, attrs):
        self._binary(ins, outs, "add")

    def op_Sub(self, ins, outs, attrs):
        self._binary(ins, outs, "subtract")

    def op_Mul(self, ins, outs, attrs):
        self._binary(ins, outs, "multiply")

    def op_Div(self, ins, outs, attrs):
        self._binary(ins, outs, "divide")

    def op_Pow(self, ins, outs, attrs):
        self._binary(ins, outs, "power")

    def _pool(self, ins, outs, attrs, kind):
        x = self.as_nhwc(ins[0])
        ks = attrs["kernel_shape"]
        strides = attrs.get("strides", [1] * len(ks))
        pads = attrs.get("pads", [0] * (2 * len(ks)))
        ap = attrs.get("auto_pad", "NOTSET")
        if ap not in ("NOTSET", None, ""):
            sh_ = self.shape_of(ins[0])
            pads = self._auto_pads(ap, (sh_[2], sh_[3]), ks, strides,
                                   [1] * len(ks), pads)
        extra = {}
        if kind == "avg":
            extra["count_include_pad"] = bool(attrs.get("count_include_pad", 0))
        out = self.b.call(
            f"nn.{kind}_pool2d", x,
            pool_size=tuple(ks), strides=tuple(strides),
            padding=(pads[0], pads[1], pads[2], pads[3]),
            ceil_mode=bool(attrs.get("ceil_mode", 0)), **extra,
        )
        self.set(outs[0], out, "nhwc")

    def op_MaxPool(self, ins, outs, attrs):
        self._pool(ins, outs, attrs, "max")

    def op_AveragePool(self, ins, outs, attrs):
        self._pool(ins, outs, attrs, "avg")

    def op_GlobalAveragePool(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        self.set(outs[0], self.b.call("nn.global_avg_pool2d", x), "nhwc")

    def op_BatchNormalization(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        gamma, beta, mean, var = (self.const_value(i) for i in ins[1:5])
        out = self.b.call(
            "nn.batch_norm", x,
            self.b.const(gamma), self.b.const(beta),
            self.b.const(mean), self.b.const(var),
            epsilon=attrs.get("epsilon", 1e-5),
        )
        self.set(outs[0], out, "nhwc")

    def op_LayerNormalization(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        axis = attrs.get("axis", -1)
        out = self.b.call(
            "nn.layer_norm", x,
            self.b.const(self.const_value(ins[1])),
            self.b.const(self.const_value(ins[2]) if len(ins) > 2 and ins[2] else
                         np.zeros_like(self.const_value(ins[1]))),
            axis=axis, epsilon=attrs.get("epsilon", 1e-5),
        )
        self.set(outs[0], out, "onnx")

    def op_Softmax(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        self.set(outs[0], self.b.call("nn.softmax", x, axis=attrs.get("axis", -1)), "onnx")

    def op_Flatten(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        assert attrs.get("axis", 1) == 1
        self.set(outs[0], self.b.call("nn.batch_flatten", x), "onnx")

    def op_Reshape(self, ins, outs, attrs):
        shape = self.const_value(ins[1])
        assert shape is not None, "dynamic Reshape target must constant-fold"
        xc = self.const_value(ins[0])
        if xc is not None:  # constant fold (e.g. pre-reshaped weights)
            target = [xc.shape[i] if s == 0 else int(s) for i, s in enumerate(shape.tolist())]
            folded = xc.reshape(target)
            self.env[outs[0]] = (folded, "onnx")
            self.consts[outs[0]] = folded
            return
        x = self.as_onnx(ins[0])
        target = []
        in_shape = self.shape_of(ins[0])
        for i, s in enumerate(shape.tolist()):
            target.append(in_shape[i] if s == 0 else int(s))
        self.set(outs[0], self.b.call("reshape", x, newshape=tuple(target)), "onnx")

    def op_Transpose(self, ins, outs, attrs):
        xc = self.const_value(ins[0])
        perm = tuple(attrs.get("perm", [])) or None
        if xc is not None:
            folded = np.ascontiguousarray(np.transpose(xc, perm))
            self.env[outs[0]] = (folded, "onnx")
            self.consts[outs[0]] = folded
            return
        x = self.as_onnx(ins[0])
        self.set(outs[0], self.b.call("transpose", x, axes=perm), "onnx")

    def op_Concat(self, ins, outs, attrs):
        cvals = [self.const_value(i) for i in ins]
        if all(v is not None for v in cvals):
            fold = np.concatenate(cvals, axis=attrs.get("axis", 0))
            self.env[outs[0]] = (fold, "onnx")
            self.consts[outs[0]] = fold
            return
        names = [self.as_onnx(i) for i in ins]
        self.set(outs[0], self.b.call("concatenate", *names, axis=attrs.get("axis", 0)), "onnx")

    def op_Squeeze(self, ins, outs, attrs):
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        cv = self.const_value(ins[0])
        if cv is not None:
            fold = np.squeeze(cv, axis=tuple(axes) if axes else None)
            self.env[outs[0]] = (fold, "onnx")
            self.consts[outs[0]] = fold
            return
        x = self.as_onnx(ins[0])
        self.set(outs[0], self.b.call("squeeze", x, axis=tuple(axes) if axes else None), "onnx")

    def op_Unsqueeze(self, ins, outs, attrs):
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        cv = self.const_value(ins[0])
        if cv is not None:
            fold = cv
            for ax in sorted(axes):
                fold = np.expand_dims(fold, ax)
            self.env[outs[0]] = (fold, "onnx")
            self.consts[outs[0]] = fold
            return
        x = self.as_onnx(ins[0])
        out = x
        for ax in sorted(axes):
            out = self.b.call("expand_dims", out, axis=ax)
        self.set(outs[0], out, "onnx")

    def op_Shape(self, ins, outs, attrs):
        sh = np.asarray(self.shape_of(ins[0]), dtype=np.int64)
        self.env[outs[0]] = (sh, "onnx")
        self.consts[outs[0]] = sh

    def op_Constant(self, ins, outs, attrs):
        if "value" in attrs and attrs["value"] is not None:
            arr = attrs["value"]
        elif "value_float" in attrs:
            arr = np.float32(attrs["value_float"])
        elif "value_int" in attrs:
            arr = np.int64(attrs["value_int"])
        else:
            raise NotImplementedError("Constant without value")
        arr = np.asarray(arr)
        self.env[outs[0]] = (arr, "onnx")
        self.consts[outs[0]] = arr

    def op_ConstantOfShape(self, ins, outs, attrs):
        shape = self.const_value(ins[0])
        val = attrs.get("value")
        fill = val.reshape(()) if isinstance(val, np.ndarray) else np.float32(0)
        arr = np.full(tuple(shape.tolist()), fill)
        self.env[outs[0]] = (arr, "onnx")
        self.consts[outs[0]] = arr

    def op_Gather(self, ins, outs, attrs):
        axis = attrs.get("axis", 0)
        data_c = self.const_value(ins[0])
        idx_c = self.const_value(ins[1])
        if data_c is not None and idx_c is not None:
            fold = np.take(data_c, idx_c.astype(np.int64), axis=axis)
            self.env[outs[0]] = (fold, "onnx")
            self.consts[outs[0]] = fold
            return
        data, _ = self.val(ins[0])
        idx, _ = self.val(ins[1])
        self.set(outs[0], self.b.call("take", data, idx, axis=axis), "onnx")

    def op_Slice(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        if "starts" in attrs:  # opset < 10
            starts, ends = attrs["starts"], attrs["ends"]
            axes = attrs.get("axes", list(range(len(starts))))
            steps = [1] * len(starts)
        else:
            starts = self.const_value(ins[1]).tolist()
            ends = self.const_value(ins[2]).tolist()
            axes = (self.const_value(ins[3]).tolist()
                    if len(ins) > 3 and ins[3] else list(range(len(starts))))
            steps = (self.const_value(ins[4]).tolist()
                     if len(ins) > 4 and ins[4] else [1] * len(starts))
        self.set(outs[0], self.b.call(
            "strided_slice", x, begin=tuple(starts), end=tuple(ends),
            strides=tuple(steps), axes=tuple(axes)), "onnx")

    def op_Split(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        axis = attrs.get("axis", 0)
        splits = attrs.get("split")
        if splits is None and len(ins) > 1 and ins[1]:
            splits = self.const_value(ins[1]).tolist()
        if splits is None:
            tup = self.b.call("split", x, indices_or_sections=len(outs), axis=axis)
        else:
            pts = np.cumsum(splits[:-1]).tolist()
            tup = self.b.call("split", x, indices_or_sections=tuple(pts), axis=axis)
        for i, o in enumerate(outs):
            self.set(o, self.b.get_item(tup, i), "onnx")

    def op_Cast(self, ins, outs, attrs):
        cv = self.const_value(ins[0])
        target = ONNX_DTYPES[attrs["to"]]
        if cv is not None:
            fold = cv.astype(target)
            self.env[outs[0]] = (fold, "onnx")
            self.consts[outs[0]] = fold
            return
        v, layout = self.val(ins[0])
        self.set(outs[0], self.b.call("cast", v, dtype=target), layout)

    def op_ReduceMean(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        self.set(outs[0], self.b.call(
            "mean", x, axis=tuple(axes) if axes else None,
            keepdims=bool(attrs.get("keepdims", 1))), "onnx")

    def op_Pad(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        pads = attrs.get("pads")
        if pads is None:
            pads = self.const_value(ins[1]).tolist()
        rank = len(pads) // 2
        pw = [(pads[i], pads[i + rank]) for i in range(rank)]
        val = 0.0
        if len(ins) > 2 and ins[2]:
            val = float(self.const_value(ins[2]))
        self.set(outs[0], self.b.call(
            "nn.pad", x, pad_width=tuple(pw),
            pad_mode=attrs.get("mode", "constant"), pad_value=val), "onnx")

    # -- converter long tail (breadth batch; `relay/frontend/onnx.py` roles) --

    def op_Neg(self, ins, outs, attrs):
        self._unary(ins, outs, "negative")

    def op_Abs(self, ins, outs, attrs):
        self._unary(ins, outs, "abs")

    def op_Floor(self, ins, outs, attrs):
        self._unary(ins, outs, "floor")

    def op_Ceil(self, ins, outs, attrs):
        self._unary(ins, outs, "ceil")

    def op_Round(self, ins, outs, attrs):
        self._unary(ins, outs, "round")

    def op_Log(self, ins, outs, attrs):
        self._unary(ins, outs, "log")

    def op_Sin(self, ins, outs, attrs):
        self._unary(ins, outs, "sin")

    def op_Cos(self, ins, outs, attrs):
        self._unary(ins, outs, "cos")

    def op_Tan(self, ins, outs, attrs):
        self._unary(ins, outs, "tan")

    def op_Asin(self, ins, outs, attrs):
        self._unary(ins, outs, "asin")

    def op_Acos(self, ins, outs, attrs):
        self._unary(ins, outs, "acos")

    def op_Atan(self, ins, outs, attrs):
        self._unary(ins, outs, "atan")

    def op_Sinh(self, ins, outs, attrs):
        self._unary(ins, outs, "sinh")

    def op_Cosh(self, ins, outs, attrs):
        self._unary(ins, outs, "cosh")

    def op_Sign(self, ins, outs, attrs):
        self._unary(ins, outs, "sign")

    def op_Not(self, ins, outs, attrs):
        self._unary(ins, outs, "logical_not")

    def op_IsNaN(self, ins, outs, attrs):
        self._unary(ins, outs, "isnan")

    def op_IsInf(self, ins, outs, attrs):
        self._unary(ins, outs, "isinf")

    def op_Reciprocal(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        one = self.b.const(np.float32(1.0))
        self.set(outs[0], self.b.call("divide", one, v), layout)

    def op_Softplus(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        e = self.b.call("exp", v)
        e1 = self.b.call("add", e, self.b.const(np.float32(1.0)))
        self.set(outs[0], self.b.call("log", e1), layout)

    def op_Softsign(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        den = self.b.call("add", self.b.call("abs", v),
                          self.b.const(np.float32(1.0)))
        self.set(outs[0], self.b.call("divide", v, den), layout)

    def op_HardSigmoid(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        a = np.float32(attrs.get("alpha", 0.2))
        be = np.float32(attrs.get("beta", 0.5))
        s = self.b.call("add", self.b.call("multiply", v, self.b.const(a)),
                        self.b.const(be))
        self.set(outs[0], self.b.call("clip", s, a_min=0.0, a_max=1.0), layout)

    def op_HardSwish(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        s = self.b.call("add", self.b.call(
            "multiply", v, self.b.const(np.float32(1 / 6))),
            self.b.const(np.float32(0.5)))
        hs = self.b.call("clip", s, a_min=0.0, a_max=1.0)
        self.set(outs[0], self.b.call("multiply", v, hs), layout)

    def op_Elu(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        a = np.float32(attrs.get("alpha", 1.0))
        em1 = self.b.call("subtract", self.b.call("exp", v),
                          self.b.const(np.float32(1.0)))
        neg = self.b.call("multiply", em1, self.b.const(a))
        zero = self.b.const(np.float32(0.0))
        cond = self.b.call("greater", v, zero)
        self.set(outs[0], self.b.call("where", cond, v, neg), layout)

    def op_Selu(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        a = np.float32(attrs.get("alpha", 1.6732632423543772))
        g = np.float32(attrs.get("gamma", 1.0507009873554805))
        em1 = self.b.call("subtract", self.b.call("exp", v),
                          self.b.const(np.float32(1.0)))
        neg = self.b.call("multiply", em1, self.b.const(a))
        cond = self.b.call("greater", v, self.b.const(np.float32(0.0)))
        sel = self.b.call("where", cond, v, neg)
        self.set(outs[0], self.b.call("multiply", sel, self.b.const(g)), layout)

    def op_ThresholdedRelu(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        a = np.float32(attrs.get("alpha", 1.0))
        cond = self.b.call("greater", v, self.b.const(a))
        self.set(outs[0], self.b.call(
            "where", cond, v, self.b.const(np.float32(0.0))), layout)

    def op_Mish(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        e1 = self.b.call("add", self.b.call("exp", v),
                         self.b.const(np.float32(1.0)))
        sp = self.b.call("log", e1)
        self.set(outs[0], self.b.call(
            "multiply", v, self.b.call("tanh", sp)), layout)

    def op_PRelu(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        slope = self.const_value(ins[1])
        assert slope is not None, "dynamic PRelu slope unsupported"
        sl = slope.reshape(-1).astype(np.float32)
        if sl.size == 1:
            self.set(outs[0], self.b.call(
                "nn.leaky_relu", v, alpha=float(sl[0])), layout)
            return
        # per-channel slope: channel axis is 1 in ONNX layout, last in nhwc
        axis = -1 if layout == "nhwc" else 1
        self.set(outs[0], self.b.call(
            "nn.prelu", v, self.b.const(sl), axis=axis), layout)

    def op_LogSoftmax(self, ins, outs, attrs):
        self._unary(ins, outs, "nn.log_softmax",
                    axis=int(attrs.get("axis", -1)))

    # comparisons / logical -----------------------------------------------

    def op_Equal(self, ins, outs, attrs):
        self._binary(ins, outs, "equal")

    def op_Greater(self, ins, outs, attrs):
        self._binary(ins, outs, "greater")

    def op_Less(self, ins, outs, attrs):
        self._binary(ins, outs, "less")

    def op_GreaterOrEqual(self, ins, outs, attrs):
        self._binary(ins, outs, "greater_equal")

    def op_LessOrEqual(self, ins, outs, attrs):
        self._binary(ins, outs, "less_equal")

    def op_And(self, ins, outs, attrs):
        self._binary(ins, outs, "logical_and")

    def op_Or(self, ins, outs, attrs):
        self._binary(ins, outs, "logical_or")

    def op_Xor(self, ins, outs, attrs):
        self._binary(ins, outs, "logical_xor")

    def op_Mod(self, ins, outs, attrs):
        self._binary(ins, outs,
                     "trunc_mod" if attrs.get("fmod") else "mod")

    def _variadic(self, ins, outs, op):
        v, layout = self.val(ins[0])
        for nxt in ins[1:]:
            w, _ = self.val(nxt)
            v = self.b.call(op, v, w)
        return v, layout

    def op_Max(self, ins, outs, attrs):
        v, layout = self._variadic(ins, outs, "maximum")
        self.set(outs[0], v, layout)

    def op_Min(self, ins, outs, attrs):
        v, layout = self._variadic(ins, outs, "minimum")
        self.set(outs[0], v, layout)

    def op_Sum(self, ins, outs, attrs):
        v, layout = self._variadic(ins, outs, "add")
        self.set(outs[0], v, layout)

    def op_Mean(self, ins, outs, attrs):
        v, layout = self._variadic(ins, outs, "add")
        self.set(outs[0], self.b.call(
            "divide", v, self.b.const(np.float32(len(ins)))), layout)

    # reductions ------------------------------------------------------------

    def _reduce(self, ins, outs, attrs, op):
        x = self.as_onnx(ins[0])
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        kd = bool(attrs.get("keepdims", 1))
        if axes is None and attrs.get("noop_with_empty_axes"):
            self.env[outs[0]] = self.env[ins[0]]
            return None
        return self.b.call(op, x, axis=tuple(axes) if axes else None,
                           keepdims=kd)

    def op_ReduceSum(self, ins, outs, attrs):
        v = self._reduce(ins, outs, attrs, "sum")
        if v is not None:
            self.set(outs[0], v, "onnx")

    def op_ReduceMax(self, ins, outs, attrs):
        v = self._reduce(ins, outs, attrs, "max")
        if v is not None:
            self.set(outs[0], v, "onnx")

    def op_ReduceMin(self, ins, outs, attrs):
        v = self._reduce(ins, outs, attrs, "min")
        if v is not None:
            self.set(outs[0], v, "onnx")

    def op_ReduceProd(self, ins, outs, attrs):
        v = self._reduce(ins, outs, attrs, "prod")
        if v is not None:
            self.set(outs[0], v, "onnx")

    def op_ReduceL1(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        ab = self.b.call("abs", x)
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        self.set(outs[0], self.b.call(
            "sum", ab, axis=tuple(axes) if axes else None,
            keepdims=bool(attrs.get("keepdims", 1))), "onnx")

    def op_ReduceL2(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        sq = self.b.call("multiply", x, x)
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        ssum = self.b.call("sum", sq, axis=tuple(axes) if axes else None,
                           keepdims=bool(attrs.get("keepdims", 1)))
        self.set(outs[0], self.b.call("sqrt", ssum), "onnx")

    def op_ReduceSumSquare(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        sq = self.b.call("multiply", x, x)
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1]:
            axes = self.const_value(ins[1]).tolist()
        self.set(outs[0], self.b.call(
            "sum", sq, axis=tuple(axes) if axes else None,
            keepdims=bool(attrs.get("keepdims", 1))), "onnx")

    def op_ArgMax(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        self.set(outs[0], self.b.call(
            "argmax", x, axis=(int(attrs.get("axis", 0)),),
            keepdims=bool(attrs.get("keepdims", 1))), "onnx")

    def op_ArgMin(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        self.set(outs[0], self.b.call(
            "argmin", x, axis=(int(attrs.get("axis", 0)),),
            keepdims=bool(attrs.get("keepdims", 1))), "onnx")

    # data movement ----------------------------------------------------------

    def op_Expand(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        target = tuple(int(v) for v in self.const_value(ins[1]))
        in_shape = self.shape_of(ins[0])
        out_shape = tuple(np.broadcast_shapes(tuple(in_shape), target))
        self.set(outs[0], self.b.call(
            "broadcast_to", x, shape=out_shape), "onnx")

    def op_Tile(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        reps = tuple(int(v) for v in self.const_value(ins[1]))
        self.set(outs[0], self.b.call("tile", x, reps=reps), "onnx")

    def op_Range(self, ins, outs, attrs):
        s = self.const_value(ins[0])
        li = self.const_value(ins[1])
        d = self.const_value(ins[2])
        assert s is not None and li is not None and d is not None, \
            "dynamic Range unsupported"
        fold = np.arange(s.item(), li.item(), d.item(), dtype=s.dtype)
        self.env[outs[0]] = (fold, "onnx")
        self.consts[outs[0]] = fold

    def op_Where(self, ins, outs, attrs):
        c = self.as_onnx(ins[0])
        a = self.as_onnx(ins[1])
        b2 = self.as_onnx(ins[2])
        self.set(outs[0], self.b.call("where", c, a, b2), "onnx")

    def op_OneHot(self, ins, outs, attrs):
        idx = self.as_onnx(ins[0])
        depth = int(self.const_value(ins[1]).item())
        vals = self.const_value(ins[2])  # [off, on]
        self.set(outs[0], self.b.call(
            "one_hot", idx, depth=depth, axis=int(attrs.get("axis", -1)),
            on_value=vals[1].item(), off_value=vals[0].item(),
            dtype=str(vals.dtype)), "onnx")

    def op_CumSum(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        axis = int(self.const_value(ins[1]).item())
        if attrs.get("exclusive") or attrs.get("reverse"):
            raise NotImplementedError("CumSum exclusive/reverse")
        self.set(outs[0], self.b.call("cumsum", x, axis=axis), "onnx")

    def op_Trilu(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        k = 0
        if len(ins) > 1 and ins[1]:
            k = int(self.const_value(ins[1]).item())
        self.set(outs[0], self.b.call(
            "trilu", x, k=k, upper=bool(attrs.get("upper", 1))), "onnx")

    def op_TopK(self, ins, outs, attrs):
        x = self.as_onnx(ins[0])
        k = int(self.const_value(ins[1]).item())
        if not attrs.get("largest", 1):
            raise NotImplementedError("TopK largest=0")
        tup = self.b.call("topk", x, k=k, axis=int(attrs.get("axis", -1)),
                          ret_type="both", is_ascend=False, dtype="int64")
        self.set(outs[0], self.b.get_item(tup, 0), "onnx")
        if len(outs) > 1:
            self.set(outs[1], self.b.get_item(tup, 1), "onnx")

    def op_GatherND(self, ins, outs, attrs):
        if attrs.get("batch_dims"):
            raise NotImplementedError("GatherND batch_dims")
        d = self.as_onnx(ins[0])
        i = self.as_onnx(ins[1])
        self.set(outs[0], self.b.call("gather_nd", d, i), "onnx")

    def op_ScatterND(self, ins, outs, attrs):
        d = self.as_onnx(ins[0])
        i = self.as_onnx(ins[1])
        u = self.as_onnx(ins[2])
        self.set(outs[0], self.b.call(
            "scatter_nd", d, i, u,
            reduction=attrs.get("reduction", "update")), "onnx")

    def op_GatherElements(self, ins, outs, attrs):
        d = self.as_onnx(ins[0])
        i = self.as_onnx(ins[1])
        self.set(outs[0], self.b.call(
            "gather", d, i, axis=int(attrs.get("axis", 0))), "onnx")

    def op_ScatterElements(self, ins, outs, attrs):
        d = self.as_onnx(ins[0])
        i = self.as_onnx(ins[1])
        u = self.as_onnx(ins[2])
        self.set(outs[0], self.b.call(
            "scatter_elements", d, i, u, axis=int(attrs.get("axis", 0)),
            reduction=attrs.get("reduction", "update")), "onnx")

    def op_Einsum(self, ins, outs, attrs):
        eq = attrs["equation"]
        if isinstance(eq, bytes):
            eq = eq.decode()
        vs = [self.as_onnx(i) for i in ins]
        self.set(outs[0], self.b.call("einsum", *vs, equation=eq), "onnx")

    def op_Size(self, ins, outs, attrs):
        fold = np.int64(int(np.prod(self.shape_of(ins[0]))))
        self.env[outs[0]] = (np.asarray(fold), "onnx")
        self.consts[outs[0]] = np.asarray(fold)

    # NN layers ----------------------------------------------------------------

    def op_ConvTranspose(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        w = self.const_value(ins[1])
        assert w is not None, "dynamic ConvTranspose weights unsupported"
        if int(attrs.get("group", 1)) != 1:
            raise NotImplementedError("grouped ConvTranspose")
        # ONNX weight (CIN, COUT, KH, KW) -> HWIO
        w_hwio = np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))
        wn = self.b.const(w_hwio, name=ins[1][:40] + "_w")
        pads = attrs.get("pads", [0, 0, 0, 0])
        strides = attrs.get("strides", [1, 1])
        opad = attrs.get("output_padding", [0, 0])
        out = self.b.call(
            "nn.conv2d_transpose", x, wn, strides=tuple(strides),
            padding=(pads[0], pads[1], pads[2], pads[3]),
            output_padding=tuple(opad))
        if len(ins) > 2 and ins[2]:
            bn = self.b.const(self.const_value(ins[2]), name=ins[2][:40] + "_b")
            out = self.b.call("nn.bias_add", out, bn, axis=-1)
        self.set(outs[0], out, "nhwc")

    def op_Resize(self, ins, outs, attrs):
        def s(v, default):
            v = attrs.get(v, default)
            return v.decode() if isinstance(v, bytes) else v

        mode = s("mode", "nearest")
        if mode not in ("nearest", "linear"):
            raise NotImplementedError(f"Resize mode {mode}")
        # ONNX opset-11+ defaults: half_pixel + round_prefer_floor (Relay's
        # Resize converter passes both through to image.resize2d)
        ctm = s("coordinate_transformation_mode", "half_pixel")
        nearest = s("nearest_mode", "round_prefer_floor")
        if ctm == "pytorch_half_pixel":
            ctm = "half_pixel"  # identical when output size > 1
        if ctm == "tf_half_pixel_for_nn":
            ctm = "half_pixel"
        x = self.as_nhwc(ins[0])
        n, c, h, w = self.shape_of(ins[0])
        sizes = None
        if len(ins) > 3 and ins[3]:
            sz = self.const_value(ins[3])
            sizes = (int(sz[2]), int(sz[3]))
        elif len(ins) > 2 and ins[2]:
            sc = self.const_value(ins[2])
            if sc is not None and sc.size == 4:
                sizes = (int(round(h * float(sc[2]))),
                         int(round(w * float(sc[3]))))
        if sizes is None:
            raise NotImplementedError("Resize without static sizes/scales")
        kw = dict(size=sizes, coordinate_transformation_mode=ctm)
        if mode == "nearest":
            kw.update(method="nearest_neighbor", rounding_method=nearest)
        else:
            kw.update(method="linear")
        self.set(outs[0], self.b.call("image.resize2d", x, **kw), "nhwc")

    def op_Upsample(self, ins, outs, attrs):
        # opset<10 deprecated form
        mode = attrs.get("mode", "nearest")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if mode != "nearest":
            raise NotImplementedError(f"Upsample mode {mode}")
        x = self.as_nhwc(ins[0])
        n, c, h, w = self.shape_of(ins[0])
        sc = attrs.get("scales")
        if sc is None and len(ins) > 1 and ins[1]:
            sc = self.const_value(ins[1]).tolist()
        self.set(outs[0], self.b.call(
            "image.resize2d", x,
            size=(int(round(h * sc[2])), int(round(w * sc[3]))),
            method="nearest_neighbor"), "nhwc")

    def op_InstanceNormalization(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        gamma = self.b.const(self.const_value(ins[1]))
        beta = self.b.const(self.const_value(ins[2]))
        axis = -1 if layout == "nhwc" else 1
        self.set(outs[0], self.b.call(
            "nn.instance_norm", v, gamma, beta, axis=axis,
            epsilon=float(attrs.get("epsilon", 1e-5))), layout)

    def op_GlobalMaxPool(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        self.set(outs[0], self.b.call("nn.global_max_pool2d", x), "nhwc")

    def op_DepthToSpace(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        mode = attrs.get("mode", "DCR")
        if isinstance(mode, bytes):
            mode = mode.decode()
        self.set(outs[0], self.b.call(
            "nn.depth_to_space", x, block_size=int(attrs["blocksize"]),
            mode=mode), "nhwc")

    def op_SpaceToDepth(self, ins, outs, attrs):
        x = self.as_nhwc(ins[0])
        self.set(outs[0], self.b.call(
            "nn.space_to_depth", x, block_size=int(attrs["blocksize"])),
            "nhwc")

    def op_LRN(self, ins, outs, attrs):
        v, layout = self.val(ins[0])
        axis = -1 if layout == "nhwc" else 1
        self.set(outs[0], self.b.call(
            "nn.lrn", v, size=int(attrs.get("size", 5)), axis=axis,
            alpha=float(attrs.get("alpha", 1e-4)),
            beta=float(attrs.get("beta", 0.75)),
            bias=float(attrs.get("bias", 1.0))), layout)


def from_onnx(model, input_shapes: dict | None = None) -> Graph:
    """Import an ONNX model (path, bytes, or decoded dict).

    input_shapes: {input_name: shape tuple} overrides/fills symbolic dims.
    """
    if not isinstance(model, dict):
        model = load_model(model)
    return _OnnxImporter(model, input_shapes).run()
