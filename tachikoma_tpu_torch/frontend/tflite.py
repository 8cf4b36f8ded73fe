"""TFLite frontend: import (prequantized) .tflite models as integer graphs
(port of `tachikoma_tpu/frontend/tflite.py`).

The converters are the JAX package's, so the imported graph's JSON equals its
importer's byte for byte.  TFLite tensors carry (scale, zero_point)
quantization and its integer ops map 1:1 onto the qnn dialect:

  CONV_2D / DEPTHWISE_CONV_2D -> qnn.conv2d [+ nn.bias_add]
      + qnn.requantize(axis=3) + clip(fused activation); SAME padding as
      TFLite computes it (stride 2: bottom and right only), the border padded
      with the input zero point
  FULLY_CONNECTED -> qnn.dense + bias + requantize (+clip)
  ADD/SUB/MUL -> qnn.add/subtract/mul
  CONCATENATION -> qnn.concatenate
  AVERAGE_POOL_2D -> cast int32 -> nn.avg_pool2d -> cast (same io qparams)
  MAX_POOL_2D -> nn.max_pool2d (same io qparams)
  SOFTMAX/LOGISTIC/TANH -> dequantize -> float op -> quantize, or with
      integer_lut (the default) the exact qnn.softmax / qnn.lut
  MEAN -> cast int32 -> mean -> requantize
  PAD -> nn.pad with pad_value = input zero point
  RESHAPE/SQUEEZE/QUANTIZE/DEQUANTIZE/RELU/RELU6 -> direct

16x8 models (int16 activations, int8 weights) import with int64
accumulators: the W8A16 path (ops/kernels/wide.py on the card).  The emitted
int8 pattern (qnn.conv2d -> bias_add -> requantize -> clip) is what
`runtime/fuse.py` fuses into tk.conv2d_rq / tk.dense_rq, so an imported int8
model runs on K1, K2 and K5 with its own zero points.  Rounding is UPWARD;
against the TFLite interpreter (two-step gemmlowp rounding) an output may
differ by one quantum.

Parsing is the in-tree flatbuffer reader (`frontend/tflite_fb.py`).
"""

from __future__ import annotations

import math

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types
from ..ops.qnn import SOFTMAX_OUT_SCALE, SOFTMAX_OUT_ZP, build_lut
from . import tflite_fb as fb


def _get_pad_value(data: int, kernel: int, stride: int) -> tuple[int, int]:
    """SAME padding: (before, after), the odd cell after."""
    out = int(math.ceil(float(data) / float(stride)))
    pad = max(0, (out - 1) * stride + kernel - data)
    pad_before = pad // 2
    return pad_before, pad - pad_before


class _QParams:
    __slots__ = ("scale", "zero_point", "axis")

    def __init__(self, scale, zero_point, axis):
        self.scale = scale          # float or 1-D np.float32 array
        self.zero_point = zero_point  # int or 1-D np.int32 array
        self.axis = axis

    @property
    def scalar_scale(self) -> float:
        return float(np.asarray(self.scale).reshape(-1)[0])

    @property
    def scalar_zp(self) -> int:
        return int(np.asarray(self.zero_point).reshape(-1)[0])


class _TFLiteImporter:
    def __init__(self, buf, input_shapes=None, integer_lut=True):
        self.model = fb.root(buf)
        if fb.file_identifier(buf) != "TFL3":
            raise ValueError("not a TFLite flatbuffer (missing TFL3 id)")
        self.b = GraphBuilder("tflite")
        self.input_shapes = dict(input_shapes or {})
        # integer_lut: realize quantized unary nonlinearities as exact
        # integer ops (qnn.softmax / qnn.lut) instead of dequantize -> float
        # -> quantize islands: float reduction order varies by backend, so
        # only the integer form gives byte-identical traces
        self.integer_lut = bool(integer_lut)
        m = fb.Model(self.model.buf, self.model.pos)
        self.opcodes = [c.builtin_code() for c in m.operator_codes()]
        self.buffers = m.buffers()
        sgs = m.subgraphs()
        if len(sgs) != 1:
            raise NotImplementedError(f"{len(sgs)} subgraphs (expected 1)")
        self.sg = sgs[0]
        self.tensors = self.sg.tensors()
        self.env: dict[int, str] = {}    # tensor idx -> graph node name

    # -- tensor helpers ------------------------------------------------------

    def qparams(self, idx: int) -> _QParams | None:
        q = self.tensors[idx].quantization()
        if q is None:
            return None
        scale = q.scale()
        if scale.size == 0:
            return None
        zp = q.zero_point().astype(np.int64)
        if scale.size == 1:
            return _QParams(float(scale[0]), int(zp[0]) if zp.size else 0,
                            q.quantized_dimension())
        return _QParams(scale.astype(np.float32),
                        zp.astype(np.int32), q.quantized_dimension())

    def dtype(self, idx: int) -> str:
        return np.dtype(fb.NP_DTYPE[self.tensors[idx].type()]).name

    def shape(self, idx: int) -> tuple[int, ...]:
        return tuple(int(x) for x in self.tensors[idx].shape())

    def const_value(self, idx: int) -> np.ndarray | None:
        t = self.tensors[idx]
        data = self.buffers[t.buffer()].data()
        if not data:
            return None
        arr = np.frombuffer(data, dtype=fb.NP_DTYPE[t.type()])
        return arr.reshape(self.shape(idx)).copy()

    def get(self, idx: int) -> str:
        """Graph name for a tensor (materializing consts lazily)."""
        if idx in self.env:
            return self.env[idx]
        v = self.const_value(idx)
        if v is None:
            raise ValueError(
                f"tensor {idx} ({self.tensors[idx].name()}) has no value "
                "and no producer")
        name = self.b.const(v, name=f"t{idx}_{self.tensors[idx].name()[:32]}")
        self.env[idx] = name
        return name

    def set(self, idx: int, name: str):
        self.env[idx] = name

    # -- epilogue helpers ----------------------------------------------------

    def _fused_clip(self, out: str, act: int, q: _QParams | None,
                    dtype: str) -> str:
        """Fused activation as a clip in the quantized domain."""
        if act == fb.Act.NONE:
            return out
        if q is None:
            if act == fb.Act.RELU:
                return self.b.call("nn.relu", out)
            if act == fb.Act.RELU6:
                return self.b.call("clip", out, a_min=0.0, a_max=6.0)
            raise NotImplementedError(f"float fused activation {act}")
        info = np.iinfo(np.dtype(dtype))
        scale, zp = q.scalar_scale, q.scalar_zp

        def quantize(x):
            return int(round(x / scale)) + zp

        if act == fb.Act.RELU:
            lo, hi = max(info.min, quantize(0.0)), info.max
        elif act == fb.Act.RELU6:
            lo = max(info.min, quantize(0.0))
            hi = min(info.max, quantize(6.0))
        elif act == fb.Act.RELU_N1_TO_1:
            lo = max(info.min, quantize(-1.0))
            hi = min(info.max, quantize(1.0))
        else:
            raise NotImplementedError(f"quantized fused activation {act}")
        return self.b.call("clip", out, a_min=lo, a_max=hi)

    def _dequant(self, name: str, q: _QParams) -> str:
        return self.b.call("qnn.dequantize", name, scale=q.scale,
                           zero_point=q.zero_point, axis=q.axis)

    def _quant(self, name: str, q: _QParams, dtype: str) -> str:
        return self.b.call("qnn.quantize", name, scale=q.scale,
                           zero_point=q.zero_point, axis=q.axis,
                           out_dtype=dtype)

    # -- converters ----------------------------------------------------------

    def conv(self, op: fb.Operator, depthwise: bool):
        ins, outs = op.inputs(), op.outputs()
        o = fb.Table(op.builtin_options().buf, op.builtin_options().pos)
        if depthwise:
            padding_e = o.scalar(0, "i8")
            stride_w, stride_h = o.scalar(1, "i32", 0), o.scalar(2, "i32", 0)
            mult = o.scalar(3, "i32", 1)
            act = o.scalar(4, "i8", 0)
            dil_w, dil_h = o.scalar(5, "i32", 1), o.scalar(6, "i32", 1)
        else:
            padding_e = o.scalar(0, "i8")
            stride_w, stride_h = o.scalar(1, "i32", 0), o.scalar(2, "i32", 0)
            act = o.scalar(3, "i8", 0)
            dil_w, dil_h = o.scalar(4, "i32", 1), o.scalar(5, "i32", 1)
        dil_w, dil_h = max(dil_w, 1), max(dil_h, 1)

        data_idx, w_idx = int(ins[0]), int(ins[1])
        x = self.get(data_idx)
        w = self.const_value(w_idx)
        assert w is not None, "dynamic conv weights unsupported"
        n, ih, iw, ic = self.shape(data_idx)
        if depthwise:
            # TFLite layout (1, KH, KW, ic*mult) -> HWIO with I=1 per group
            _, kh, kw, cout = w.shape
            assert cout == ic * mult
            w_hwio = np.ascontiguousarray(w.reshape(kh, kw, 1, cout))
            groups = ic
        else:
            cout, kh, kw, _ = w.shape  # OHWI -> HWIO
            w_hwio = np.ascontiguousarray(np.transpose(w, (1, 2, 3, 0)))
            groups = 1
        wn = self.b.const(w_hwio, name=f"t{w_idx}_w")

        pad = (0, 0, 0, 0)
        if padding_e == fb.PAD_SAME:
            dk_h = dil_h * (kh - 1) + 1
            dk_w = dil_w * (kw - 1) + 1
            pt, pb = _get_pad_value(ih, dk_h, stride_h)
            pl, pr = _get_pad_value(iw, dk_w, stride_w)
            pad = (pt, pl, pb, pr)

        in_q = self.qparams(data_idx)
        w_q = self.qparams(w_idx)
        out_idx = int(outs[0])
        out_q = self.qparams(out_idx)
        out_dtype = self.dtype(out_idx)

        if in_q is None:  # float conv
            out = self.b.call("nn.conv2d", x, wn, strides=(stride_h, stride_w),
                              padding=pad, dilation=(dil_h, dil_w),
                              groups=groups)
            if len(ins) > 2 and int(ins[2]) >= 0:
                bias = self.b.const(self.const_value(int(ins[2])))
                out = self.b.call("nn.bias_add", out, bias, axis=-1)
            self.set(out_idx, self._fused_clip(out, act, None, out_dtype))
            return

        kzp = w_q.zero_point
        # 16x8 mode: int16 activations accumulate in int64
        acc_dtype = "int64" if out_dtype == "int16" else "int32"
        out = self.b.call(
            "qnn.conv2d", x, wn, strides=(stride_h, stride_w), padding=pad,
            dilation=(dil_h, dil_w), groups=groups,
            input_zero_point=in_q.scalar_zp,
            kernel_zero_point=(kzp if np.ndim(kzp) else int(kzp)),
            out_dtype=acc_dtype)
        if len(ins) > 2 and int(ins[2]) >= 0:
            bias = self.const_value(int(ins[2]))
            out = self.b.call("nn.bias_add", out,
                              self.b.const(bias.astype(np.int32)), axis=-1)
        # requantize: scale = in_scale * w_scale (per-channel ok), zp 0
        new_scale = np.asarray(in_q.scale, np.float64) * np.asarray(
            w_q.scale, np.float64)
        out = self.b.call(
            "qnn.requantize", out,
            input_scale=(new_scale.astype(np.float32)
                         if new_scale.ndim else float(new_scale)),
            input_zero_point=0, output_scale=out_q.scalar_scale,
            output_zero_point=out_q.scalar_zp, axis=3, out_dtype=out_dtype)
        self.set(out_idx, self._fused_clip(out, act, out_q, out_dtype))

    def fully_connected(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        o = op.builtin_options()
        act = o.scalar(0, "i8", 0) if o is not None else 0
        keep_dims = bool(o.scalar(2, "bool", False)) if o is not None else False
        data_idx, w_idx = int(ins[0]), int(ins[1])
        x = self.get(data_idx)
        w = self.const_value(w_idx)
        assert w is not None, "dynamic FC weights unsupported"
        cout, cin = w.shape
        dshape = self.shape(data_idx)
        if len(dshape) != 2 or dshape[1] != cin:
            batch = int(np.prod(dshape)) // cin
            x = self.b.call("reshape", x, newshape=(batch, cin))
        if keep_dims:
            raise NotImplementedError("FULLY_CONNECTED keep_num_dims")
        wn = self.b.const(np.ascontiguousarray(w.T), name=f"t{w_idx}_w")
        in_q, w_q = self.qparams(data_idx), self.qparams(w_idx)
        out_idx = int(outs[0])
        out_q, out_dtype = self.qparams(out_idx), self.dtype(out_idx)

        if in_q is None:
            out = self.b.call("nn.dense", x, wn)
            if len(ins) > 2 and int(ins[2]) >= 0:
                out = self.b.call("nn.bias_add", out,
                                  self.b.const(self.const_value(int(ins[2]))),
                                  axis=-1)
            self.set(out_idx, self._fused_clip(out, act, None, out_dtype))
            return

        kzp = w_q.zero_point
        acc_dtype = "int64" if out_dtype == "int16" else "int32"
        out = self.b.call("qnn.dense", x, wn,
                          input_zero_point=in_q.scalar_zp,
                          kernel_zero_point=(kzp if np.ndim(kzp)
                                             else int(kzp)),
                          out_dtype=acc_dtype)
        if len(ins) > 2 and int(ins[2]) >= 0:
            out = self.b.call(
                "nn.bias_add", out,
                self.b.const(self.const_value(int(ins[2])).astype(np.int32)),
                axis=-1)
        new_scale = np.asarray(in_q.scale, np.float64) * np.asarray(
            w_q.scale, np.float64)
        out = self.b.call(
            "qnn.requantize", out,
            input_scale=(new_scale.astype(np.float32)
                         if new_scale.ndim else float(new_scale)),
            input_zero_point=0, output_scale=out_q.scalar_scale,
            output_zero_point=out_q.scalar_zp, axis=-1, out_dtype=out_dtype)
        self.set(out_idx, self._fused_clip(out, act, out_q, out_dtype))

    def pool2d(self, op: fb.Operator, kind: str):
        ins, outs = op.inputs(), op.outputs()
        o = op.builtin_options()
        padding_e = o.scalar(0, "i8")
        stride_w, stride_h = o.scalar(1, "i32", 0), o.scalar(2, "i32", 0)
        filt_w, filt_h = o.scalar(3, "i32", 0), o.scalar(4, "i32", 0)
        act = o.scalar(5, "i8", 0)
        data_idx, out_idx = int(ins[0]), int(outs[0])
        x = self.get(data_idx)
        _, ih, iw, _ = self.shape(data_idx)
        pad = (0, 0, 0, 0)
        if padding_e == fb.PAD_SAME:
            pt, pb = _get_pad_value(ih, filt_h, stride_h)
            pl, pr = _get_pad_value(iw, filt_w, stride_w)
            pad = (pt, pl, pb, pr)
        in_q = self.qparams(data_idx)
        out_q, out_dtype = self.qparams(out_idx), self.dtype(out_idx)
        params = dict(pool_size=(filt_h, filt_w), strides=(stride_h, stride_w),
                      padding=pad)
        if kind == "average":
            if in_q is not None:
                out = self.b.call("cast", x, dtype="int32")
                out = self.b.call("nn.avg_pool2d", out, **params)
                out = self.b.call("cast", out, dtype=out_dtype)
            else:
                out = self.b.call("nn.avg_pool2d", x, **params)
        else:
            out = self.b.call("nn.max_pool2d", x, **params)
        self.set(out_idx, self._fused_clip(out, act, out_q, out_dtype))

    def dequant_op_quant(self, op: fb.Operator, float_op: str,
                         float_fn=None, **attrs):
        ins, outs = op.inputs(), op.outputs()
        data_idx, out_idx = int(ins[0]), int(outs[0])
        x = self.get(data_idx)
        in_q = self.qparams(data_idx)
        out_q = self.qparams(out_idx)
        out_dtype = self.dtype(out_idx)
        if (in_q is not None and out_q is not None and self.integer_lut
                and out_dtype == "int8" and self.dtype(data_idx) == "int8"):
            if float_op == "nn.softmax":
                # TFLite int8 softmax output is pinned to scale 1/256,
                # zp -128: qnn.softmax's contract
                if (abs(out_q.scalar_scale - SOFTMAX_OUT_SCALE) < 1e-9
                        and out_q.scalar_zp == SOFTMAX_OUT_ZP):
                    self.set(out_idx, self.b.call(
                        "qnn.softmax", x, axis=-1,
                        input_scale=in_q.scalar_scale, out_dtype="int8"))
                    return
            elif float_fn is not None:
                table = build_lut(float_fn, in_q.scalar_scale,
                                  in_q.scalar_zp, out_q.scalar_scale,
                                  out_q.scalar_zp)
                self.set(out_idx, self.b.call(
                    "qnn.lut", x, table=tuple(int(v) for v in table),
                    out_dtype="int8"))
                return
        if in_q is not None:
            x = self._dequant(x, in_q)
        out = self.b.call(float_op, x, **attrs)
        if out_q is not None:
            out = self._quant(out, out_q, out_dtype)
        self.set(out_idx, out)

    def binary(self, op: fb.Operator, qnn_op: str, float_op: str):
        ins, outs = op.inputs(), op.outputs()
        li, ri, out_idx = int(ins[0]), int(ins[1]), int(outs[0])
        o = op.builtin_options()
        act = o.scalar(0, "i8", 0) if o is not None else 0
        lq, rq = self.qparams(li), self.qparams(ri)
        out_q, out_dtype = self.qparams(out_idx), self.dtype(out_idx)
        lx, rx = self.get(li), self.get(ri)
        if lq is None:
            out = self.b.call(float_op, lx, rx)
        else:
            out = self.b.call(
                qnn_op, lx, rx,
                lhs_scale=lq.scalar_scale, lhs_zero_point=lq.scalar_zp,
                rhs_scale=rq.scalar_scale, rhs_zero_point=rq.scalar_zp,
                output_scale=out_q.scalar_scale,
                output_zero_point=out_q.scalar_zp, out_dtype=out_dtype)
        self.set(out_idx, self._fused_clip(out, act, out_q, out_dtype))

    def concatenation(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        o = op.builtin_options()
        axis = o.scalar(0, "i32", 0)
        act = o.scalar(1, "i8", 0)
        out_idx = int(outs[0])
        out_q, out_dtype = self.qparams(out_idx), self.dtype(out_idx)
        exprs = [self.get(int(i)) for i in ins]
        qs = [self.qparams(int(i)) for i in ins]
        if qs[0] is None:
            out = self.b.call("concatenate", *exprs, axis=axis)
        else:
            out = self.b.call(
                "qnn.concatenate", *exprs, axis=axis,
                input_scales=tuple(q.scalar_scale for q in qs),
                input_zero_points=tuple(q.scalar_zp for q in qs),
                output_scale=out_q.scalar_scale,
                output_zero_point=out_q.scalar_zp, out_dtype=out_dtype)
        self.set(out_idx, self._fused_clip(out, act, out_q, out_dtype))

    def reshape(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        o = op.builtin_options()
        if o is not None and o.vec_len(0):
            new_shape = [int(v) for v in o.vec_scalars(0, "i32")]
        else:
            new_shape = [int(v) for v in self.const_value(int(ins[1]))]
        self.set(int(outs[0]),
                 self.b.call("reshape", self.get(int(ins[0])),
                             newshape=tuple(new_shape)))

    def pad(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        data_idx, out_idx = int(ins[0]), int(outs[0])
        pw = self.const_value(int(ins[1]))
        in_q = self.qparams(data_idx)
        pad_value = in_q.scalar_zp if in_q is not None else 0
        self.set(out_idx, self.b.call(
            "nn.pad", self.get(data_idx),
            pad_width=tuple((int(a), int(b)) for a, b in pw),
            pad_value=pad_value))

    def mean(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        data_idx, out_idx = int(ins[0]), int(outs[0])
        axes = self.const_value(int(ins[1]))
        axes = tuple(int(a) for a in np.atleast_1d(axes))
        o = op.builtin_options()
        keep_dims = bool(o.scalar(0, "bool", False)) if o is not None else False
        in_q = self.qparams(data_idx)
        out_q, out_dtype = self.qparams(out_idx), self.dtype(out_idx)
        x = self.get(data_idx)
        if in_q is not None:
            x = self.b.call("cast", x, dtype="int32")
        out = self.b.call("mean", x, axis=axes, keepdims=keep_dims)
        if out_q is not None:
            out = self.b.call(
                "qnn.requantize", out, input_scale=in_q.scalar_scale,
                input_zero_point=in_q.scalar_zp,
                output_scale=out_q.scalar_scale,
                output_zero_point=out_q.scalar_zp, out_dtype=out_dtype)
        self.set(out_idx, out)

    def strided_slice(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        data_idx, out_idx = int(ins[0]), int(outs[0])
        begin = [int(v) for v in self.const_value(int(ins[1]))]
        end = [int(v) for v in self.const_value(int(ins[2]))]
        strides = [int(v) for v in self.const_value(int(ins[3]))]
        o = op.builtin_options()
        bm = o.scalar(0, "i32", 0) if o is not None else 0
        em = o.scalar(1, "i32", 0) if o is not None else 0
        if o is not None and (o.scalar(2, "i32", 0) or o.scalar(3, "i32", 0)):
            raise NotImplementedError("strided_slice ellipsis/new_axis mask")
        sm = o.scalar(4, "i32", 0) if o is not None else 0
        shape = self.shape(data_idx)
        rb, re_ = [], []
        for i, dim in enumerate(shape[:len(begin)]):
            b, e, s = begin[i], end[i], strides[i]
            if s <= 0:
                raise NotImplementedError("negative strided_slice stride")
            b = 0 if (bm >> i) & 1 else (b + dim if b < 0 else b)
            e = dim if (em >> i) & 1 else (e + dim if e < 0 else e)
            if (sm >> i) & 1:
                e = b + 1
            rb.append(min(max(b, 0), dim))
            re_.append(min(max(e, 0), dim))
        out = self.b.call(
            "strided_slice", self.get(data_idx), begin=tuple(rb),
            end=tuple(re_), strides=tuple(strides),
            axes=tuple(range(len(rb))))
        if sm:
            out = self.b.call("reshape", out,
                              newshape=self.shape(out_idx))
        self.set(out_idx, out)

    def quantize_op(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        data_idx, out_idx = int(ins[0]), int(outs[0])
        in_q, out_q = self.qparams(data_idx), self.qparams(out_idx)
        x = self.get(data_idx)
        if in_q is not None:
            # requantize int->int
            x = self.b.call(
                "qnn.requantize", x, input_scale=in_q.scalar_scale,
                input_zero_point=in_q.scalar_zp,
                output_scale=out_q.scalar_scale,
                output_zero_point=out_q.scalar_zp,
                out_dtype=self.dtype(out_idx))
        else:
            x = self._quant(x, out_q, self.dtype(out_idx))
        self.set(out_idx, x)

    def dequantize_op(self, op: fb.Operator):
        ins, outs = op.inputs(), op.outputs()
        q = self.qparams(int(ins[0]))
        self.set(int(outs[0]), self._dequant(self.get(int(ins[0])), q))

    # -- the walk -------------------------------------------------------------

    def run(self) -> Graph:
        for idx in self.sg.inputs():
            idx = int(idx)
            shape = self.input_shapes.get(self.tensors[idx].name(),
                                          self.shape(idx))
            self.set(idx, self.b.var(self.tensors[idx].name() or f"in{idx}",
                                     tuple(shape), self.dtype(idx)))
        for op in self.sg.operators():
            code = self.opcodes[op.opcode_index()]
            self.convert(code, op)
        outs = [self.env[int(i)] for i in self.sg.outputs()]
        return infer_types(self.b.build(outs))

    def convert(self, code: int, op: fb.Operator):
        O = fb.Op
        if code == O.CONV_2D:
            self.conv(op, depthwise=False)
        elif code == O.DEPTHWISE_CONV_2D:
            self.conv(op, depthwise=True)
        elif code == O.FULLY_CONNECTED:
            self.fully_connected(op)
        elif code == O.AVERAGE_POOL_2D:
            self.pool2d(op, "average")
        elif code == O.MAX_POOL_2D:
            self.pool2d(op, "max")
        elif code == O.SOFTMAX:
            self.dequant_op_quant(op, "nn.softmax", axis=-1)
        elif code == O.LOGISTIC:
            self.dequant_op_quant(op, "sigmoid", float_fn=lambda v: 1.0 / (1.0 + np.exp(-v)))
        elif code == O.TANH:
            self.dequant_op_quant(op, "tanh", float_fn=np.tanh)
        elif code == O.HARD_SWISH:
            # x * clip(x+3, 0, 6) / 6 in float, re-quantized
            ins, outs = op.inputs(), op.outputs()
            di, oi = int(ins[0]), int(outs[0])
            in_q, out_q = self.qparams(di), self.qparams(oi)
            x = self.get(di)
            if in_q is not None:
                x = self._dequant(x, in_q)
            three = self.b.const(np.float32(3.0))
            six = self.b.const(np.float32(6.0))
            gate = self.b.call("clip", self.b.call("add", x, three),
                               a_min=0.0, a_max=6.0)
            out = self.b.call("divide", self.b.call("multiply", x, gate), six)
            if out_q is not None:
                out = self._quant(out, out_q, self.dtype(oi))
            self.set(oi, out)
        elif code == O.ADD:
            self.binary(op, "qnn.add", "add")
        elif code == O.SUB:
            self.binary(op, "qnn.subtract", "subtract")
        elif code == O.MUL:
            self.binary(op, "qnn.mul", "multiply")
        elif code == O.CONCATENATION:
            self.concatenation(op)
        elif code == O.RESHAPE:
            self.reshape(op)
        elif code == O.SQUEEZE:
            ins, outs = op.inputs(), op.outputs()
            self.set(int(outs[0]), self.b.call(
                "reshape", self.get(int(ins[0])),
                newshape=self.shape(int(outs[0]))))
        elif code == O.STRIDED_SLICE:
            self.strided_slice(op)
        elif code == O.PAD:
            self.pad(op)
        elif code == O.MEAN:
            self.mean(op)
        elif code == O.QUANTIZE:
            self.quantize_op(op)
        elif code == O.DEQUANTIZE:
            self.dequantize_op(op)
        elif code == O.RELU:
            ins, outs = op.inputs(), op.outputs()
            q = self.qparams(int(ins[0]))
            x = self.get(int(ins[0]))
            if q is None:
                self.set(int(outs[0]), self.b.call("nn.relu", x))
            else:
                info = np.iinfo(np.dtype(self.dtype(int(outs[0]))))
                self.set(int(outs[0]), self.b.call(
                    "clip", x, a_min=max(info.min, q.scalar_zp),
                    a_max=info.max))
        elif code == O.RELU6:
            ins, outs = op.inputs(), op.outputs()
            q = self.qparams(int(ins[0]))
            x = self.get(int(ins[0]))
            out_dtype = self.dtype(int(outs[0]))
            self.set(int(outs[0]),
                     self._fused_clip(x, fb.Act.RELU6, q, out_dtype))
        else:
            raise NotImplementedError(f"TFLite builtin op {code}")


def from_tflite(model, input_shapes: dict | None = None,
                integer_lut: bool = True) -> Graph:
    """Import a TFLite model (path, bytes, or buffer) as a Graph."""
    if isinstance(model, str):
        with open(model, "rb") as f:
            model = f.read()
    return _TFLiteImporter(memoryview(model), input_shapes,
                           integer_lut=integer_lut).run()
