"""TensorFlow frontend: import frozen GraphDefs, tf.functions and SavedModels
(port of `tachikoma_tpu/frontend/tensorflow.py`, its 92 converters copied
name for name).

The unit of import is the GraphDef, TensorFlow's NHWC dataflow graph of
primitive ops, converted node by node into the IR.  Variables arrive as
constants (the graph is frozen), and shape-computation subgraphs (`Shape ->
StridedSlice -> Pack -> Reshape`) fold at import time.  Layouts are
TensorFlow's and the IR's alike (NHWC activations, HWIO conv weights, (K, N)
dense weights), so nothing is transposed.

The graph is read with the port's own codec (`frontend/tf_proto.py`), so a
`.pb` file imports with no TensorFlow installed: `from_tf_graphdef` takes
the codec's GraphDef, serialized bytes, a `.pb` path, or TensorFlow's own
GraphDef (anything with `SerializeToString`, serialized and decoded by the
codec, so that every graph takes one code path).  `from_tf_function` and
`from_saved_model` need TensorFlow to trace and freeze, and import it when
called.  An op without a converter raises NotImplementedError naming it.
"""

from __future__ import annotations

import os

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types
from .tf_proto import Message, load_graph_def, make_ndarray, parse_graph_def
from .tf_proto import np_dtype as _np_dtype

__all__ = ["from_tf_graphdef", "from_tf_function", "from_saved_model"]


def _same_pad(size: int, k_eff: int, stride: int) -> tuple[int, int]:
    """TF SAME padding (reference tensorflow.py get_pad_pair)."""
    out = -(-size // stride)
    pad = max(0, (out - 1) * stride + k_eff - size)
    return pad // 2, pad - pad // 2


class _Attrs:
    """Thin AttrValue reader over the codec's messages."""

    def __init__(self, node):
        self.node = node

    def __contains__(self, key):
        return key in self.node.attr

    def s(self, key, default=None):
        if key not in self.node.attr:
            return default
        return self.node.attr[key].s.decode()

    def i(self, key, default=None):
        return self.node.attr[key].i if key in self.node.attr else default

    def f(self, key, default=None):
        return self.node.attr[key].f if key in self.node.attr else default

    def b(self, key, default=None):
        return self.node.attr[key].b if key in self.node.attr else default

    def ilist(self, key, default=()):
        if key not in self.node.attr:
            return list(default)
        return list(self.node.attr[key].list.i)

    def dtype(self, key="T"):
        return _np_dtype(self.node.attr[key].type)

    def shape(self, key="shape"):
        return [int(d.size) for d in self.node.attr[key].shape.dim]

    def tensor(self, key="value"):
        return np.asarray(make_ndarray(self.node.attr[key].tensor))


class _GraphDefImporter:
    def __init__(self, graph_def, input_specs=None, outputs=None):
        self.gd = graph_def
        self.b = GraphBuilder("tf")
        # env: (tf node name, output index) -> our node name
        self.env: dict[tuple[str, int], str] = {}
        # const values for eager folding of shape subgraphs
        self.consts: dict[tuple[str, int], np.ndarray] = {}
        self.input_specs = input_specs or {}
        self.requested_outputs = outputs
        self.nodes = {n.name: n for n in graph_def.node}

    # -- plumbing ---------------------------------------------------------

    @staticmethod
    def _ref(inp: str) -> tuple[str, int] | None:
        if inp.startswith("^"):  # control dependency
            return None
        if ":" in inp:
            name, idx = inp.rsplit(":", 1)
            return name, int(idx)
        return inp, 0

    def ins(self, node) -> list[tuple[str, int]]:
        return [r for r in (self._ref(i) for i in node.input) if r is not None]

    def get(self, ref: tuple[str, int]) -> str:
        if ref not in self.env:
            cv = self.consts.get(ref)
            if cv is None:
                raise KeyError(f"TF tensor {ref} not materialised")
            self.env[ref] = self.b.const(np.ascontiguousarray(cv),
                                         name=ref[0][-40:].replace("/", "_"))
        return self.env[ref]

    def const_value(self, ref: tuple[str, int]) -> np.ndarray | None:
        return self.consts.get(ref)

    def set(self, node, out: str, index: int = 0):
        self.env[(node.name, index)] = out

    def set_const(self, node, value: np.ndarray, index: int = 0):
        self.consts[(node.name, index)] = np.asarray(value)

    def shape_of(self, ref: tuple[str, int]):
        cv = self.consts.get(ref)
        if cv is not None:
            return tuple(cv.shape)
        g = infer_types(self.b.build([self.env[ref]]))
        return tuple(g[self.env[ref]].shape)

    # -- driver -----------------------------------------------------------

    def run(self) -> Graph:
        for node in self.gd.node:
            op = node.op
            if op in ("NoOp",):
                continue
            handler = getattr(self, "op_" + op, None)
            if handler is None:
                raise NotImplementedError(f"TF op {op} (node {node.name})")
            handler(node, _Attrs(node))
        outs = self.requested_outputs
        if outs is None:
            # frozen concrete functions end in Identity nodes named
            # Identity, Identity_1, ... — collect nodes nobody consumes
            consumed = set()
            for n in self.gd.node:
                for r in (self._ref(i) for i in n.input):
                    if r:
                        consumed.add(r[0])
            outs = [n.name for n in self.gd.node
                    if n.op == "Identity" and n.name not in consumed]
            if not outs:
                outs = [self.gd.node[-1].name]
        out_names = []
        for o in outs:
            ref = self._ref(o) or (o, 0)
            out_names.append(self.get(ref))
        return self.b.build(out_names)

    # -- structural / constant ops ---------------------------------------

    def op_Placeholder(self, node, a):
        shape = self.input_specs.get(node.name) or a.shape()
        if any(d < 0 for d in shape):
            raise ValueError(
                f"input {node.name} has unknown dims {shape}; pass "
                f"input_specs={{{node.name!r}: (concrete shape)}}")
        self.set(node, self.b.var(node.name, tuple(int(d) for d in shape),
                                  a.dtype("dtype")))

    def op_Const(self, node, a):
        self.set_const(node, a.tensor())

    def op_Identity(self, node, a):
        (ref,) = self.ins(node)
        cv = self.const_value(ref)
        if cv is not None:
            self.set_const(node, cv)
        else:
            self.set(node, self.get(ref))

    op_StopGradient = op_Identity
    op_PreventGradient = op_Identity
    op_CheckNumerics = op_Identity
    op_Snapshot = op_Identity

    def op_IdentityN(self, node, a):
        for k, ref in enumerate(self.ins(node)):
            cv = self.const_value(ref)
            if cv is not None:
                self.set_const(node, cv, k)
            else:
                self.set(node, self.get(ref), k)

    def op_Shape(self, node, a):
        (ref,) = self.ins(node)
        self.set_const(node, np.asarray(self.shape_of(ref), np.int32))

    # -- eager const folding for shape arithmetic -------------------------

    def _fold(self, node, fn, *refs) -> bool:
        vals = [self.const_value(r) for r in refs]
        if all(v is not None for v in vals):
            self.set_const(node, fn(*vals))
            return True
        return False

    # -- math -------------------------------------------------------------

    def _binary(self, node, op, np_fn):
        l, r = self.ins(node)
        if self._fold(node, np_fn, l, r):
            return
        self.set(node, self.b.call(op, self.get(l), self.get(r)))

    def op_Add(self, node, a):
        self._binary(node, "add", np.add)

    op_AddV2 = op_Add

    def op_AddN(self, node, a):
        refs = self.ins(node)
        out = self.get(refs[0])
        for r in refs[1:]:
            out = self.b.call("add", out, self.get(r))
        self.set(node, out)

    def op_Sub(self, node, a):
        self._binary(node, "subtract", np.subtract)

    def op_Mul(self, node, a):
        self._binary(node, "multiply", np.multiply)

    def op_RealDiv(self, node, a):
        self._binary(node, "divide", np.divide)

    op_Div = op_RealDiv

    def op_FloorDiv(self, node, a):
        self._binary(node, "floor_divide", lambda x, y: x // y)

    def op_FloorMod(self, node, a):
        self._binary(node, "floor_mod", np.mod)

    def op_Pow(self, node, a):
        self._binary(node, "power", np.power)

    def op_Maximum(self, node, a):
        self._binary(node, "maximum", np.maximum)

    def op_Minimum(self, node, a):
        self._binary(node, "minimum", np.minimum)

    def op_SquaredDifference(self, node, a):
        l, r = self.ins(node)
        d = self.b.call("subtract", self.get(l), self.get(r))
        self.set(node, self.b.call("multiply", d, d))

    def _unary(self, node, op, np_fn=None):
        (ref,) = self.ins(node)
        if np_fn is not None and self._fold(node, np_fn, ref):
            return
        self.set(node, self.b.call(op, self.get(ref)))

    def op_Neg(self, node, a):
        self._unary(node, "negative", np.negative)

    def op_Abs(self, node, a):
        self._unary(node, "abs", np.abs)

    def op_Square(self, node, a):
        (ref,) = self.ins(node)
        x = self.get(ref)
        self.set(node, self.b.call("multiply", x, x))

    def op_Sqrt(self, node, a):
        self._unary(node, "sqrt")

    def op_Rsqrt(self, node, a):
        self._unary(node, "rsqrt")

    def op_Exp(self, node, a):
        self._unary(node, "exp")

    def op_Log(self, node, a):
        self._unary(node, "log")

    def op_Erf(self, node, a):
        self._unary(node, "erf")

    def op_Sin(self, node, a):
        self._unary(node, "sin")

    def op_Cos(self, node, a):
        self._unary(node, "cos")

    def op_Tanh(self, node, a):
        self._unary(node, "tanh")

    def op_Sigmoid(self, node, a):
        self._unary(node, "sigmoid")

    def op_Round(self, node, a):
        self._unary(node, "round")

    def op_Floor(self, node, a):
        self._unary(node, "floor")

    def op_Ceil(self, node, a):
        self._unary(node, "ceil")

    def op_Sign(self, node, a):
        self._unary(node, "sign")

    def op_Cast(self, node, a):
        (ref,) = self.ins(node)
        dst = _np_dtype(node.attr["DstT"].type)
        cv = self.const_value(ref)
        if cv is not None:
            self.set_const(node, cv.astype(dst))
            return
        self.set(node, self.b.call("cast", self.get(ref), dtype=dst))

    def _compare(self, node, op, np_fn):
        self._binary(node, op, np_fn)

    def op_Greater(self, node, a):
        self._compare(node, "greater", np.greater)

    def op_GreaterEqual(self, node, a):
        self._compare(node, "greater_equal", np.greater_equal)

    def op_Less(self, node, a):
        self._compare(node, "less", np.less)

    def op_LessEqual(self, node, a):
        self._compare(node, "less_equal", np.less_equal)

    def op_Equal(self, node, a):
        self._compare(node, "equal", np.equal)

    def op_NotEqual(self, node, a):
        self._compare(node, "not_equal", np.not_equal)

    def op_LogicalAnd(self, node, a):
        self._binary(node, "logical_and", np.logical_and)

    def op_LogicalOr(self, node, a):
        self._binary(node, "logical_or", np.logical_or)

    def op_LogicalNot(self, node, a):
        self._unary(node, "logical_not", np.logical_not)

    def op_Select(self, node, a):
        c, l, r = self.ins(node)
        self.set(node, self.b.call("where", self.get(c), self.get(l), self.get(r)))

    op_SelectV2 = op_Select

    def op_ClipByValue(self, node, a):
        x, lo, hi = self.ins(node)
        lov, hiv = self.const_value(lo), self.const_value(hi)
        assert lov is not None and hiv is not None, "dynamic clip bounds"
        self.set(node, self.b.call("clip", self.get(x),
                                   a_min=float(lov), a_max=float(hiv)))

    # -- activations ------------------------------------------------------

    def op_Relu(self, node, a):
        self._unary(node, "nn.relu")

    def op_Relu6(self, node, a):
        (ref,) = self.ins(node)
        self.set(node, self.b.call("clip", self.get(ref), a_min=0.0, a_max=6.0))

    def op_LeakyRelu(self, node, a):
        (ref,) = self.ins(node)
        self.set(node, self.b.call("nn.leaky_relu", self.get(ref),
                                   alpha=float(a.f("alpha", 0.2))))

    def op_Elu(self, node, a):
        # elu(x) = x if x > 0 else exp(x) - 1
        (ref,) = self.ins(node)
        x = self.get(ref)
        e = self.b.call("exp", x)
        em1 = self.b.call("subtract", e, self.b.const(np.float32(1)))
        zero = self.b.const(np.float32(0))
        mask = self.b.call("greater", x, zero)
        self.set(node, self.b.call("where", mask, x, em1))

    def op_Selu(self, node, a):
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        (ref,) = self.ins(node)
        x = self.get(ref)
        e = self.b.call("exp", x)
        em1 = self.b.call("subtract", e, self.b.const(np.float32(1)))
        neg = self.b.call("multiply", em1, self.b.const(np.float32(alpha)))
        mask = self.b.call("greater", x, self.b.const(np.float32(0)))
        sel = self.b.call("where", mask, x, neg)
        self.set(node, self.b.call("multiply", sel, self.b.const(np.float32(scale))))

    def op_Softplus(self, node, a):
        (ref,) = self.ins(node)
        x = self.get(ref)
        e = self.b.call("exp", x)
        e1 = self.b.call("add", e, self.b.const(np.float32(1)))
        self.set(node, self.b.call("log", e1))

    def op_Softmax(self, node, a):
        self._unary(node, "nn.softmax")

    def op_LogSoftmax(self, node, a):
        (ref,) = self.ins(node)
        self.set(node, self.b.call("nn.log_softmax", self.get(ref), axis=-1))

    # -- matmul / conv ----------------------------------------------------

    def op_MatMul(self, node, a):
        l, r = self.ins(node)
        ta, tb = a.b("transpose_a", False), a.b("transpose_b", False)
        w = self.const_value(r)
        if w is not None and w.ndim == 2:
            if tb:
                w = w.T  # -> (K, N)
            x = self.get(l)
            if ta:
                x = self.b.call("transpose", x, axes=(1, 0))
            wn = self.b.const(np.ascontiguousarray(w), name=r[0][-40:].replace("/", "_"))
            self.set(node, self.b.call("nn.dense", x, wn))
            return
        self.set(node, self.b.call(
            "nn.matmul", self.get(l), self.get(r),
            transpose_a=bool(ta), transpose_b=bool(tb)))

    def op_BatchMatMulV2(self, node, a):
        l, r = self.ins(node)
        self.set(node, self.b.call(
            "nn.batch_matmul", self.get(l), self.get(r),
            transpose_a=bool(a.b("adj_x", False)),
            transpose_b=bool(a.b("adj_y", False))))

    op_BatchMatMulV3 = op_BatchMatMulV2
    op_BatchMatMul = op_BatchMatMulV2

    def _conv_padding(self, a, in_h, in_w, k_eff_h, k_eff_w, sh, sw):
        mode = a.s("padding", "VALID")
        if mode == "SAME":
            pt, pb = _same_pad(in_h, k_eff_h, sh)
            pl, pr = _same_pad(in_w, k_eff_w, sw)
            return (pt, pl, pb, pr)
        if mode == "EXPLICIT":
            e = a.ilist("explicit_paddings")
            # NHWC: [n0,n1, t,b, l,r, c0,c1]
            return (e[2], e[4], e[3], e[5])
        return (0, 0, 0, 0)

    def op_Conv2D(self, node, a):
        assert a.s("data_format", "NHWC") == "NHWC", "NCHW TF graphs unsupported"
        x_ref, w_ref = self.ins(node)
        w = self.const_value(w_ref)
        assert w is not None, "dynamic conv weights unsupported"
        sh, sw = a.ilist("strides", (1, 1, 1, 1))[1:3]
        dh, dw = a.ilist("dilations", (1, 1, 1, 1))[1:3] or (1, 1)
        kh, kw, ic_w, oc = w.shape  # HWIO already
        _, ih, iw, ic = self.shape_of(x_ref)
        pad = self._conv_padding(a, ih, iw, dh * (kh - 1) + 1, dw * (kw - 1) + 1, sh, sw)
        wn = self.b.const(np.ascontiguousarray(w), name=w_ref[0][-40:].replace("/", "_"))
        groups = ic // ic_w
        self.set(node, self.b.call(
            "nn.conv2d", self.get(x_ref), wn, strides=(sh, sw), padding=pad,
            dilation=(dh, dw), groups=int(groups)))

    def op_DepthwiseConv2dNative(self, node, a):
        assert a.s("data_format", "NHWC") == "NHWC"
        x_ref, w_ref = self.ins(node)
        w = self.const_value(w_ref)
        assert w is not None, "dynamic conv weights unsupported"
        sh, sw = a.ilist("strides", (1, 1, 1, 1))[1:3]
        dh, dw = a.ilist("dilations", (1, 1, 1, 1))[1:3] or (1, 1)
        kh, kw, ic, mult = w.shape  # (H, W, I, channel_multiplier)
        _, ih, iw, _ = self.shape_of(x_ref)
        pad = self._conv_padding(a, ih, iw, dh * (kh - 1) + 1, dw * (kw - 1) + 1, sh, sw)
        # output channel i*mult+m convolves input channel i: grouped conv
        # with I=1 per group, O = ic*mult (same move as frontend/tflite.py)
        w_hwio = np.ascontiguousarray(w.reshape(kh, kw, 1, ic * mult))
        wn = self.b.const(w_hwio, name=w_ref[0][-40:].replace("/", "_"))
        self.set(node, self.b.call(
            "nn.conv2d", self.get(x_ref), wn, strides=(sh, sw), padding=pad,
            dilation=(dh, dw), groups=int(ic)))

    def op_Conv2DBackpropInput(self, node, a):
        # TF expresses transpose conv as the gradient op: inputs are
        # (output_shape, filter, data)
        assert a.s("data_format", "NHWC") == "NHWC"
        oshape_ref, w_ref, x_ref = self.ins(node)
        oshape = self.const_value(oshape_ref)
        w = self.const_value(w_ref)
        assert w is not None and oshape is not None
        sh, sw = a.ilist("strides", (1, 1, 1, 1))[1:3]
        kh, kw, oc, ic = w.shape  # HWOI for backprop-input
        _, ih, iw, _ = self.shape_of(x_ref)
        mode = a.s("padding", "VALID")
        if mode == "SAME":
            pt, pb = _same_pad(int(oshape[1]), kh, sh)
            pl, pr = _same_pad(int(oshape[2]), kw, sw)
            pad = (pt, pl, pb, pr)
        else:
            pad = (0, 0, 0, 0)
        # our nn.conv2d_transpose takes HWIO weights (I = input channels of
        # the transpose op = ic here)
        w_hwio = np.ascontiguousarray(np.transpose(w, (0, 1, 3, 2)))
        wn = self.b.const(w_hwio, name=w_ref[0][-40:].replace("/", "_"))
        out_h, out_w = int(oshape[1]), int(oshape[2])
        # output_padding recovers the requested output size
        base_h = (ih - 1) * sh + kh - pad[0] - pad[2]
        base_w = (iw - 1) * sw + kw - pad[1] - pad[3]
        self.set(node, self.b.call(
            "nn.conv2d_transpose", self.get(x_ref), wn, strides=(sh, sw),
            padding=pad, output_padding=(out_h - base_h, out_w - base_w)))

    def op_BiasAdd(self, node, a):
        x_ref, b_ref = self.ins(node)
        bias = self.const_value(b_ref)
        bn = (self.b.const(bias, name=b_ref[0][-40:].replace("/", "_"))
              if bias is not None else self.get(b_ref))
        axis = -1 if a.s("data_format", "NHWC") == "NHWC" else 1
        self.set(node, self.b.call("nn.bias_add", self.get(x_ref), bn, axis=axis))

    def op_FusedBatchNormV3(self, node, a):
        assert a.s("data_format", "NHWC") == "NHWC"
        assert not a.b("is_training", False), "training-mode BN unsupported"
        x, gamma, beta, mean, var = self.ins(node)
        out = self.b.call(
            "nn.batch_norm", self.get(x),
            self.get(gamma), self.get(beta), self.get(mean), self.get(var),
            epsilon=float(a.f("epsilon", 1e-3)))
        self.set(node, out)

    op_FusedBatchNorm = op_FusedBatchNormV3
    op_FusedBatchNormV2 = op_FusedBatchNormV3

    # -- pooling ----------------------------------------------------------

    def _pool(self, node, a, kind):
        assert a.s("data_format", "NHWC") == "NHWC"
        (x_ref,) = self.ins(node)
        kh, kw = a.ilist("ksize")[1:3]
        sh, sw = a.ilist("strides")[1:3]
        _, ih, iw, _ = self.shape_of(x_ref)
        pad = self._conv_padding(a, ih, iw, kh, kw, sh, sw)
        self.set(node, self.b.call(
            f"nn.{kind}_pool2d", self.get(x_ref), pool_size=(kh, kw),
            strides=(sh, sw), padding=pad))

    def op_MaxPool(self, node, a):
        self._pool(node, a, "max")

    def op_AvgPool(self, node, a):
        # TF SAME avg pool divides by the number of VALID taps =
        # count_include_pad=False, our default
        self._pool(node, a, "avg")

    # -- reductions -------------------------------------------------------

    def _reduce(self, node, a, op, np_fn):
        x_ref, ax_ref = self.ins(node)
        axes = self.const_value(ax_ref)
        assert axes is not None, "dynamic reduction axes"
        axes = tuple(int(v) for v in np.atleast_1d(axes))
        keep = bool(a.b("keep_dims", False))
        cv = self.const_value(x_ref)
        if cv is not None:
            self.set_const(node, np_fn(cv, axis=axes, keepdims=keep))
            return
        self.set(node, self.b.call(op, self.get(x_ref), axis=axes, keepdims=keep))

    def op_Mean(self, node, a):
        self._reduce(node, a, "mean", np.mean)

    def op_Sum(self, node, a):
        self._reduce(node, a, "sum", np.sum)

    def op_Max(self, node, a):
        self._reduce(node, a, "max", np.max)

    def op_Min(self, node, a):
        self._reduce(node, a, "min", np.min)

    def op_Prod(self, node, a):
        self._reduce(node, a, "prod", np.prod)

    def op_All(self, node, a):
        self._reduce(node, a, "all", np.all)

    def op_Any(self, node, a):
        self._reduce(node, a, "any", np.any)

    def op_ArgMax(self, node, a):
        x_ref, ax_ref = self.ins(node)
        axis = int(np.atleast_1d(self.const_value(ax_ref))[0])
        out = self.b.call("argmax", self.get(x_ref), axis=axis)
        odt = _np_dtype(node.attr["output_type"].type) if "output_type" in node.attr else "int64"
        self.set(node, self.b.call("cast", out, dtype=odt))

    def op_ArgMin(self, node, a):
        x_ref, ax_ref = self.ins(node)
        axis = int(np.atleast_1d(self.const_value(ax_ref))[0])
        out = self.b.call("argmin", self.get(x_ref), axis=axis)
        odt = _np_dtype(node.attr["output_type"].type) if "output_type" in node.attr else "int64"
        self.set(node, self.b.call("cast", out, dtype=odt))

    # -- shape manipulation ----------------------------------------------

    def op_Reshape(self, node, a):
        x_ref, s_ref = self.ins(node)
        shape = self.const_value(s_ref)
        assert shape is not None, "dynamic Reshape target must constant-fold"
        target = [int(v) for v in shape]
        cv = self.const_value(x_ref)
        if cv is not None:
            self.set_const(node, cv.reshape(target))
            return
        self.set(node, self.b.call("reshape", self.get(x_ref), newshape=tuple(target)))

    def op_Squeeze(self, node, a):
        (x_ref,) = self.ins(node)
        dims = a.ilist("squeeze_dims") or a.ilist("axis")
        cv = self.const_value(x_ref)
        if cv is not None:
            self.set_const(node, np.squeeze(cv, axis=tuple(dims) if dims else None))
            return
        self.set(node, self.b.call("squeeze", self.get(x_ref),
                                   axis=tuple(int(d) for d in dims) if dims else None))

    def op_ExpandDims(self, node, a):
        x_ref, ax_ref = self.ins(node)
        axis = int(np.atleast_1d(self.const_value(ax_ref))[0])
        cv = self.const_value(x_ref)
        if cv is not None:
            self.set_const(node, np.expand_dims(cv, axis))
            return
        self.set(node, self.b.call("expand_dims", self.get(x_ref), axis=axis))

    def op_Transpose(self, node, a):
        x_ref, p_ref = self.ins(node)
        perm = self.const_value(p_ref)
        assert perm is not None
        cv = self.const_value(x_ref)
        if cv is not None:
            self.set_const(node, np.transpose(cv, perm))
            return
        self.set(node, self.b.call("transpose", self.get(x_ref),
                                   axes=tuple(int(p) for p in perm)))

    def op_Pad(self, node, a):
        x_ref, p_ref = self.ins(node)
        pads = self.const_value(p_ref)
        assert pads is not None
        pw = tuple((int(b), int(e)) for b, e in pads)
        val = 0.0
        if node.op == "PadV2":
            val = float(self.const_value(self.ins(node)[2]))
        self.set(node, self.b.call("nn.pad", self.get(x_ref),
                                   pad_width=pw, pad_value=val))

    def op_PadV2(self, node, a):
        x_ref, p_ref, v_ref = self.ins(node)
        pads = self.const_value(p_ref)
        val = self.const_value(v_ref)
        assert pads is not None and val is not None
        pw = tuple((int(b), int(e)) for b, e in pads)
        self.set(node, self.b.call("nn.pad", self.get(x_ref),
                                   pad_width=pw, pad_value=float(val)))

    def op_MirrorPad(self, node, a):
        x_ref, p_ref = self.ins(node)
        pads = self.const_value(p_ref)
        assert pads is not None
        pw = tuple((int(b), int(e)) for b, e in pads)
        mode = {"REFLECT": "reflect", "SYMMETRIC": "edge"}[a.s("mode", "REFLECT")]
        self.set(node, self.b.call("nn.pad", self.get(x_ref),
                                   pad_width=pw, pad_mode=mode))

    def op_ConcatV2(self, node, a):
        refs = self.ins(node)
        axis = int(np.atleast_1d(self.const_value(refs[-1]))[0])
        vals = [self.const_value(r) for r in refs[:-1]]
        if all(v is not None for v in vals):
            self.set_const(node, np.concatenate(vals, axis=axis))
            return
        self.set(node, self.b.call(
            "concatenate", *[self.get(r) for r in refs[:-1]], axis=axis))

    def op_Pack(self, node, a):
        refs = self.ins(node)
        axis = int(a.i("axis", 0))
        vals = [self.const_value(r) for r in refs]
        if all(v is not None for v in vals):
            self.set_const(node, np.stack(vals, axis=axis))
            return
        self.set(node, self.b.call("stack", *[self.get(r) for r in refs], axis=axis))

    def op_Unpack(self, node, a):
        (x_ref,) = self.ins(node)
        axis = int(a.i("axis", 0))
        num = int(a.i("num"))
        tup = self.b.call("split", self.get(x_ref), indices_or_sections=num, axis=axis)
        for k in range(num):
            item = self.b.get_item(tup, k)
            self.set(node, self.b.call("squeeze", item, axis=(axis,)), k)

    def op_Split(self, node, a):
        ax_ref, x_ref = self.ins(node)
        axis = int(np.atleast_1d(self.const_value(ax_ref))[0])
        num = int(a.i("num_split"))
        tup = self.b.call("split", self.get(x_ref), indices_or_sections=num, axis=axis)
        for k in range(num):
            self.set(node, self.b.get_item(tup, k), k)

    def op_SplitV(self, node, a):
        x_ref, sz_ref, ax_ref = self.ins(node)
        sizes = self.const_value(sz_ref)
        axis = int(np.atleast_1d(self.const_value(ax_ref))[0])
        assert sizes is not None
        pts = np.cumsum(sizes[:-1]).tolist()
        tup = self.b.call("split", self.get(x_ref),
                          indices_or_sections=tuple(int(p) for p in pts), axis=axis)
        for k in range(len(sizes)):
            self.set(node, self.b.get_item(tup, k), k)

    def op_StridedSlice(self, node, a):
        x_ref, b_ref, e_ref, s_ref = self.ins(node)
        begin = self.const_value(b_ref)
        end = self.const_value(e_ref)
        strides = self.const_value(s_ref)
        assert begin is not None and end is not None and strides is not None
        bm, em = int(a.i("begin_mask", 0)), int(a.i("end_mask", 0))
        sm = int(a.i("shrink_axis_mask", 0))
        nm = int(a.i("new_axis_mask", 0))
        elm = int(a.i("ellipsis_mask", 0))
        cv = self.const_value(x_ref)
        if cv is not None:
            # const fold with TF's own semantics via numpy slicing
            idx = self._ss_index(cv.shape, begin, end, strides, bm, em, sm, nm, elm)
            self.set_const(node, cv[idx])
            return
        assert nm == 0 and elm == 0, "new_axis/ellipsis on tensor StridedSlice"
        shape = self.shape_of(x_ref)
        bs, es, ss, squeeze = [], [], [], []
        for k in range(len(begin)):
            dim = shape[k]
            st = int(strides[k])
            b0 = 0 if (bm >> k) & 1 else int(begin[k])
            e0 = dim if (em >> k) & 1 else int(end[k])
            if (sm >> k) & 1:
                b0 = int(begin[k]) % dim if begin[k] < 0 else int(begin[k])
                e0, st = b0 + 1, 1
                squeeze.append(k)
            else:
                if b0 < 0:
                    b0 += dim
                if e0 < 0:
                    e0 += dim
            bs.append(b0)
            es.append(e0)
            ss.append(st)
        out = self.b.call("strided_slice", self.get(x_ref),
                          begin=tuple(bs), end=tuple(es), strides=tuple(ss))
        if squeeze:
            out = self.b.call("squeeze", out, axis=tuple(squeeze))
        self.set(node, out)

    @staticmethod
    def _ss_index(shape, begin, end, strides, bm, em, sm, nm, elm):
        idx = []
        k = 0
        for j in range(len(begin)):
            if (elm >> j) & 1:
                fill = len(shape) - (len(begin) - j - 1) - k
                idx.extend([slice(None)] * fill)
                k += fill
                continue
            if (nm >> j) & 1:
                idx.append(None)
                continue
            if (sm >> j) & 1:
                idx.append(int(begin[j]))
                k += 1
                continue
            b0 = None if (bm >> j) & 1 else int(begin[j])
            e0 = None if (em >> j) & 1 else int(end[j])
            idx.append(slice(b0, e0, int(strides[j])))
            k += 1
        return tuple(idx)

    def op_Slice(self, node, a):
        x_ref, b_ref, s_ref = self.ins(node)
        begin = self.const_value(b_ref)
        size = self.const_value(s_ref)
        assert begin is not None and size is not None
        shape = self.shape_of(x_ref)
        bs = [int(v) for v in begin]
        es = [s + (shape[k] - bs[k] if sz < 0 else int(sz))
              for k, (s, sz) in enumerate(zip(bs, size))]
        self.set(node, self.b.call("strided_slice", self.get(x_ref),
                                   begin=tuple(bs), end=tuple(es)))

    def op_Tile(self, node, a):
        x_ref, m_ref = self.ins(node)
        mult = self.const_value(m_ref)
        assert mult is not None
        self.set(node, self.b.call("tile", self.get(x_ref),
                                   reps=tuple(int(m) for m in mult)))

    def op_Fill(self, node, a):
        s_ref, v_ref = self.ins(node)
        shape = self.const_value(s_ref)
        val = self.const_value(v_ref)
        assert shape is not None
        if val is not None:
            self.set_const(node, np.full([int(d) for d in shape], val))
            return
        self.set(node, self.b.call("full", self.get(v_ref),
                                   shape=tuple(int(d) for d in shape)))

    def op_Range(self, node, a):
        s_ref, l_ref, d_ref = self.ins(node)
        start, limit, delta = (self.const_value(r) for r in (s_ref, l_ref, d_ref))
        assert start is not None and limit is not None and delta is not None
        self.set_const(node, np.arange(start, limit, delta))

    def op_GatherV2(self, node, a):
        x_ref, i_ref, ax_ref = self.ins(node)
        axis = int(np.atleast_1d(self.const_value(ax_ref))[0])
        assert int(a.i("batch_dims", 0)) == 0, "batched gather unsupported"
        cv, iv = self.const_value(x_ref), self.const_value(i_ref)
        if cv is not None and iv is not None:
            self.set_const(node, np.take(cv, iv, axis=axis))
            return
        self.set(node, self.b.call("take", self.get(x_ref), self.get(i_ref), axis=axis))

    def op_DepthToSpace(self, node, a):
        (x_ref,) = self.ins(node)
        self.set(node, self.b.call("nn.depth_to_space", self.get(x_ref),
                                   block_size=int(a.i("block_size")),
                                   layout="NHWC"))

    def op_SpaceToDepth(self, node, a):
        (x_ref,) = self.ins(node)
        self.set(node, self.b.call("nn.space_to_depth", self.get(x_ref),
                                   block_size=int(a.i("block_size")),
                                   layout="NHWC"))

    def op_ResizeBilinear(self, node, a):
        self._resize(node, a, "linear")

    def op_ResizeNearestNeighbor(self, node, a):
        self._resize(node, a, "nearest_neighbor")

    def _resize(self, node, a, method):
        x_ref, s_ref = self.ins(node)
        size = self.const_value(s_ref)
        assert size is not None
        if a.b("half_pixel_centers", False):
            coord = "half_pixel"
        elif a.b("align_corners", False):
            coord = "align_corners"
        else:
            coord = "asymmetric"
        self.set(node, self.b.call(
            "image.resize2d", self.get(x_ref),
            size=(int(size[0]), int(size[1])), method=method,
            coordinate_transformation_mode=coord,
            rounding_method="floor" if method == "nearest_neighbor" else ""))


def _as_graph_def(graph_def) -> Message:
    """The codec's GraphDef of any accepted form."""
    if isinstance(graph_def, Message):
        if graph_def._type != "GraphDef":
            raise TypeError(f"expected a GraphDef, got a {graph_def._type}")
        return graph_def
    if isinstance(graph_def, (bytes, bytearray, memoryview, str, os.PathLike)):
        return load_graph_def(graph_def)
    if hasattr(graph_def, "SerializeToString"):
        return parse_graph_def(graph_def.SerializeToString())
    raise TypeError(f"cannot read a GraphDef from {type(graph_def).__name__}")


def from_tf_graphdef(graph_def, input_specs=None, outputs=None) -> Graph:
    """Convert a (frozen) TF GraphDef to a Graph.

    graph_def: the codec's GraphDef, serialized bytes, a `.pb` path, or
    TensorFlow's GraphDef.
    input_specs: optional {placeholder_name: shape} for graphs whose
    Placeholder shapes contain unknown dims.
    outputs: optional list of TF tensor names; default = the frozen
    function's terminal Identity nodes.
    """
    return _GraphDefImporter(_as_graph_def(graph_def), input_specs, outputs).run()


def from_tf_function(fn, input_specs) -> Graph:
    """Trace + freeze a callable through tf.function and import it.

    input_specs: sequence of (shape, dtype-str) tuples or tf.TensorSpec.
    """
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    specs = []
    for s in input_specs:
        if isinstance(s, tf.TensorSpec):
            specs.append(s)
        else:
            shape, dtype = s
            specs.append(tf.TensorSpec(shape, getattr(tf, dtype)))
    if not isinstance(fn, tf.types.experimental.GenericFunction):
        fn = tf.function(fn)
    frozen = convert_variables_to_constants_v2(fn.get_concrete_function(*specs))
    return from_tf_graphdef(frozen.graph.as_graph_def().SerializeToString())


def from_saved_model(path: str, signature: str = "serving_default",
                     input_specs=None) -> Graph:
    """Import a TF SavedModel's serving signature."""
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    mod = tf.saved_model.load(path)
    fn = mod.signatures[signature]
    frozen = convert_variables_to_constants_v2(fn)
    return from_tf_graphdef(frozen.graph.as_graph_def().SerializeToString())
