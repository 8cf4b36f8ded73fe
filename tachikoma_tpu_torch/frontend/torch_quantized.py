"""Prequantized-PyTorch frontend: torch.ao-quantized models -> integer graph
(port of `tachikoma_tpu/frontend/torch_quantized.py`).

The counterpart of Relay's qnn_torch importer, on torch.fx: a model
converted with torch.ao.quantization (FX graph mode `convert_fx`, or
eager-mode `convert` with QuantStub/DeQuantStub) imports as a QDQ graph —
every quantized boundary becomes an adjacent qnn.quantize -> qnn.dequantize
pair, quantized module weights fold to float consts carrying their model
scales as qdq_scale attrs — and FQ2I (`quantize/fq2i.py`) rebuilds the
integer ops with the MODEL'S OWN scales, as for ONNX QDQ models.

dtype convention: torch quint8 activations (zero points in [0, 255]) map to
int8 with zero_point - 128 — the same real values, in the int8 domain the
kernels take.

Numerical parity: torch's fbgemm/qnnpack requantize multiplies the int32
accumulator by a FLOAT scale with round-half-even; the integer kernels use
the 31-bit fixed-point multiply (requantize.cc semantics).  The two agree
except on ties/1-ULP boundaries, so parity with torch eager is a quantum or
two per requantize, not ==.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph
from .torch_fx import _Importer, _to_np


def _np_int_repr(qt) -> np.ndarray:
    import torch

    return torch.int_repr(qt).numpy()


class _QImporter(_Importer):
    """Extends the float fx importer: quantized tensors travel through
    `env` as their DEQUANTIZED float graph values (so every float handler
    works unchanged), while each quantized boundary emits the q -> dq pair
    FQ2I consumes."""

    def __init__(self, gm, example_inputs):
        super().__init__(gm, example_inputs)
        # fx node -> (scale, zp_int8) of its quantized VALUE; scalar ops
        # (quantized::add_scalar/mul_scalar) derive their output qparams
        # from their input's, exactly as torch's qadd.cpp/qmul.cpp do
        self._qp: dict = {}

    def _q_dq(self, fxn, float_name: str, layout: str, scale: float,
              zp_int8: int):
        """Emit qnn.quantize -> qnn.dequantize; env gets the dq'd float."""
        q = self.b.call("qnn.quantize", float_name, scale=float(scale),
                        zero_point=int(zp_int8), out_dtype="int8",
                        name=fxn.name + "_q")
        dq = self.b.call("qnn.dequantize", q, scale=float(scale),
                         zero_point=int(zp_int8), name=fxn.name)
        self.set(fxn, dq, layout)
        self._qp[fxn] = (float(scale), int(zp_int8))

    def _in_qparams(self, arg):
        qp = self._qp.get(arg)
        if qp is None:
            raise NotImplementedError(
                f"scalar quantized op needs its input's quant params, but "
                f"{getattr(arg, 'name', arg)} has none recorded")
        return qp

    def _float_hardswish(self, name: str) -> str:
        c3 = self.b.const(np.float32(3.0))
        c6 = self.b.const(np.float32(6.0))
        gate = self.b.call("clip", self.b.call("add", name, c3),
                           a_min=0.0, a_max=6.0)
        return self.b.call("divide", self.b.call("multiply", name, gate),
                           c6)

    def _torch_domain(self):
        """(q_min, q_max, int8_zp_offset) of the model's activation dtype:
        scalar-op output-param math runs in torch's own integer domain
        (qadd.cpp hardcodes 0..255 for quint8)."""
        quint = self._act_dtype() == self.torch.quint8
        return (0, 255, 128) if quint else (-128, 127, 0)

    def _q_add_scalar(self, fxn, x, c: float, relu: bool = False):
        """quantized::add_scalar / scalar-form quantized.add: output
        scale/zp per aten qadd.cpp (the reference's
        _get_add_scalar_output_quant_param, qnn_torch.py:298) — torch adds
        round(c/s)*s, shifting the zero point when in range, rescaling when
        the shifted zp would clamp."""
        s, z8 = self._in_qparams(x)
        qmin, qmax, off = self._torch_domain()
        z = z8 + off
        c_q = round(c / s)
        if qmin > z - c_q:
            s2 = (float(qmax) - (z - c_q)) / (qmax - qmin) * s
            z2 = qmin
        elif qmax < z - c_q:
            s2 = (float(z - c_q) - qmin) / (qmax - qmin) * s
            z2 = qmax
        else:
            s2, z2 = s, z - c_q
        name, layout = self.env[x]
        cc = self.b.const(np.float32(c_q * s))
        out = self.b.call("add", name, cc, name=fxn.name + "_f")
        if relu:
            out = self.b.call("nn.relu", out, name=fxn.name + "_relu")
        self._q_dq(fxn, out, layout, s2, z2 - off)

    def _q_mul_scalar(self, fxn, x, c: float):
        """quantized::mul_scalar / scalar-form quantized.mul per aten
        qmul.cpp (reference qnn_torch.py:325): positive c rescales only;
        zero collapses to the zero tensor; negative c mirrors the zp."""
        s, z8 = self._in_qparams(x)
        qmin, qmax, off = self._torch_domain()
        z = z8 + off
        if c > 0.0:
            s2, z2 = c * s, z
        elif c == 0.0:
            s2, z2 = 1.0, 0     # torch-domain zero point 0
        else:
            s2, z2 = abs(c) * s, qmax - (z - qmin)
        name, layout = self.env[x]
        cc = self.b.const(np.float32(c))
        out = self.b.call("multiply", name, cc, name=fxn.name + "_f")
        self._q_dq(fxn, out, layout, s2, z2 - off)

    def _concrete(self, arg):
        """Concrete python/numpy value of an fx arg (literal, pyval, or a
        get_attr node's target attribute)."""
        if not hasattr(arg, "op"):
            return arg
        if self.is_pyval(arg):
            return self.pyval(arg)
        if arg.op == "get_attr":
            val = self.gm
            for part in arg.target.split("."):
                val = getattr(val, part)
            if isinstance(val, self.torch.Tensor):
                return _to_np(val)
            return val
        raise NotImplementedError(f"expected a concrete value, got {arg}")

    @staticmethod
    def _zp_shift(zp, torch_dtype, torch) -> int:
        return int(zp) - 128 if torch_dtype == torch.quint8 else int(zp)

    def _act_dtype(self):
        """The model's quantized-activation dtype (quint8 vs qint8).

        nnq conv/linear/add/cat modules carry output scale/zero_point but
        NOT the activation dtype, and zero-point VALUE ranges overlap in
        [0, 127] — so it is recorded from the graph's quantize entry
        points (nnq.Quantize modules / torch.quantize_per_tensor calls),
        which always precede the quantized region.  Hardcoding quint8 here
        made every qint8-activation model's zero points wrong by 128."""
        dt = getattr(self, "_seen_act_dtype", None)
        return dt if dt is not None else self.torch.quint8

    # -- fx node kinds -------------------------------------------------------

    def get_attr(self, fxn):
        val = self.gm
        for part in fxn.target.split("."):
            val = getattr(val, part)
        if isinstance(val, self.torch.Tensor) and not val.is_quantized:
            super().get_attr(fxn)
        else:
            # scale/zero_point scalars and quantized tensors stay python-side
            # (consumed concretely by the quantize handlers)
            self.set_pyval(fxn, val)

    def _mark_weight_qdq(self, wname: str, qweight, out_axis: int = 0):
        """Annotate an imported weight const with its model scales so FQ2I
        recovers the EXACT stored int8 values (frontend/onnx.py _mark_qdq).
        out_axis: torch's out-channel axis for this op family (0 for
        conv/linear OIHW/(out,in); 1 for conv_transpose (in,out,kh,kw))."""
        torch = self.torch
        if qweight.qscheme() in (torch.per_channel_affine,
                                 torch.per_channel_symmetric):
            scales = qweight.q_per_channel_scales().numpy()
            zps = qweight.q_per_channel_zero_points().numpy()
            axis = int(qweight.q_per_channel_axis())
            per_axis = True
        else:
            scales = np.asarray([qweight.q_scale()])
            zps = np.asarray([qweight.q_zero_point()])
            axis = out_axis
            per_axis = False
        if np.any(zps != 0):
            return  # integer kernels assume symmetric weights; re-absmax
        if per_axis and axis != out_axis:
            return  # unexpected per-channel axis; re-absmax is still valid
        self.b.annotate(wname, qdq_scale=[float(s) for s in scales],
                        qdq_per_axis=per_axis)

    class _FloatView:
        """Presents a quantized conv/linear module as its float equivalent
        for the parent importer's conv2d/linear handlers."""

        def __init__(self, mod, torch):
            qw = mod.weight()
            self.weight = torch.dequantize(qw)
            self.bias = mod.bias()
            for attr in ("stride", "padding", "dilation", "groups",
                         "output_padding"):
                if hasattr(mod, attr):
                    setattr(self, attr, getattr(mod, attr))

    def _quantized_conv_linear(self, fxn, mod, kind: str, relu: bool):
        torch = self.torch
        view = self._FloatView(mod, torch)
        if kind == "conv":
            self.conv2d(fxn, view)
            layout = "nhwc"
        elif kind == "conv_t":
            self.conv_transpose2d(fxn, view)
            layout = "nhwc"
        else:
            self.linear(fxn, view)
            layout = "torch"
        # torch per-channel weight axis: 0 for conv/linear (OIHW / (out,
        # in)), 1 for conv_transpose (I, OUT, H, W) — out-channel either way
        self._mark_weight_qdq(fxn.name + "_w", mod.weight(),
                              out_axis=1 if kind == "conv_t" else 0)
        out_name = self.env[fxn][0]
        if relu:
            out_name = self.b.call("nn.relu", out_name,
                                   name=fxn.name + "_relu")
        zp = self._zp_shift(mod.zero_point, self._act_dtype(), torch)
        self._q_dq(fxn, out_name, layout, float(mod.scale), zp)

    def call_module(self, fxn, mod):
        torch = self.torch
        import torch.ao.nn.intrinsic.quantized as nniq
        import torch.ao.nn.quantized as nnq

        if isinstance(mod, (nnq.Conv2d, nniq.ConvReLU2d)):
            self._quantized_conv_linear(
                fxn, mod, "conv", isinstance(mod, nniq.ConvReLU2d))
        elif isinstance(mod, nnq.ConvTranspose2d):
            self._quantized_conv_linear(fxn, mod, "conv_t", False)
        elif isinstance(mod, (nnq.Linear, nniq.LinearReLU)):
            self._quantized_conv_linear(
                fxn, mod, "linear", isinstance(mod, nniq.LinearReLU))
        elif isinstance(mod, nnq.Hardswish):
            name, layout = self.env[fxn.args[0]]
            out = self._float_hardswish(name)
            self._q_dq(fxn, out, layout, float(mod.scale),
                       self._zp_shift(int(mod.zero_point),
                                      self._act_dtype(), torch))
        elif isinstance(mod, nnq.LeakyReLU):
            name, layout = self.env[fxn.args[0]]
            out = self.b.call("nn.leaky_relu", name,
                              alpha=float(mod.negative_slope),
                              name=fxn.name + "_f")
            self._q_dq(fxn, out, layout, float(mod.scale),
                       self._zp_shift(int(mod.zero_point),
                                      self._act_dtype(), torch))
        elif isinstance(mod, nnq.ReLU6):
            name, layout = self.env[fxn.args[0]]
            out = self.b.call("clip", name, a_min=0.0, a_max=6.0,
                              name=fxn.name + "_f")
            s, z8 = self._in_qparams(fxn.args[0])
            self._q_dq(fxn, out, layout, s, z8)
        elif isinstance(mod, nnq.Quantize):
            name, layout = self.env[fxn.args[0]]
            self._seen_act_dtype = mod.dtype
            zp = self._zp_shift(int(mod.zero_point), mod.dtype, torch)
            self._q_dq(fxn, name, layout, float(mod.scale), zp)
        elif isinstance(mod, nnq.DeQuantize):
            self.set(fxn, *self.env[fxn.args[0]])  # env is already float
        elif type(mod).__name__ == "QFunctional":
            raise NotImplementedError(
                "eager QFunctional modules: use FX graph mode quantization")
        else:
            # float modules (pools, flatten, upsample, dropout...) run on
            # the dq'd float values unchanged; FQ2I re-integerizes scale-
            # transparent regions from the surrounding q/dq boundaries.
            # torch's quantized pool/upsample/reshape kernels keep the
            # input's scale/zp, so qparams propagate through for any
            # downstream scalar op.
            super().call_module(fxn, mod)
            if fxn.args and fxn.args[0] in self._qp:
                self._qp[fxn] = self._qp[fxn.args[0]]

    def call_function(self, fxn):
        torch = self.torch
        t = fxn.target
        ops_q = torch.ops.quantized

        if t is torch.quantize_per_tensor:
            x, scale, zp, dt = fxn.args
            name, layout = self.env[x]
            self._seen_act_dtype = dt
            self._q_dq(fxn, name, layout, float(self._concrete(scale)),
                       self._zp_shift(self._concrete(zp), dt, torch))
        elif t in ("dequantize", torch.dequantize):
            self.set(fxn, *self.env[fxn.args[0]])
        elif t in (ops_q.add, ops_q.add_relu, ops_q.mul) \
                and len(fxn.args) == 2 \
                and not all(hasattr(a, "op") and not self.is_pyval(a)
                            for a in fxn.args):
            # SCALAR operand form: convert_fx lowers `x + c` / `x * c` to
            # 2-arg quantized.add/mul with no output scale/zp — the output
            # params follow aten's scalar rule (qadd.cpp / qmul.cpp)
            a, c = fxn.args
            if not hasattr(a, "op") or self.is_pyval(a):
                a, c = c, a
            c = float(self._concrete(c))
            if t is ops_q.mul:
                self._q_mul_scalar(fxn, a, c)
            else:
                self._q_add_scalar(fxn, a, c, relu=t is ops_q.add_relu)
        elif t in (ops_q.add, ops_q.add_relu, ops_q.mul):
            # tensor-tensor form: eager QFunctional traces put scale/zp in
            # KWARGS; convert_fx puts them in args[2:4]
            if len(fxn.args) >= 4:
                a, b_, scale, zp = fxn.args[:4]
            else:
                a, b_ = fxn.args[:2]
                scale = fxn.kwargs["scale"]
                zp = fxn.kwargs["zero_point"]
            op = "multiply" if t is ops_q.mul else "add"
            la, lb = self.layout_of(a), self.layout_of(b_)
            if la == lb:
                an, bn, layout = self.env[a][0], self.env[b_][0], la
            else:
                an, bn, layout = self.as_torch(a), self.as_torch(b_), "torch"
            out = self.b.call(op, an, bn, name=fxn.name + "_f")
            if t is ops_q.add_relu:
                out = self.b.call("nn.relu", out, name=fxn.name + "_relu")
            self._q_dq(fxn, out, layout, float(self._concrete(scale)),
                       self._zp_shift(self._concrete(zp), self._act_dtype(),
                                      torch))
        elif t is ops_q.hardswish:
            # quantized::hardswish(qx, output_scale, output_zero_point) —
            # torch computes in fp32 and requantizes
            # (QuantizedOpKernels.cpp); same float compute here + q_dq
            x = fxn.args[0]
            scale = self._concrete(
                fxn.kwargs.get("output_scale", fxn.args[1]
                               if len(fxn.args) > 1 else None))
            zp = self._concrete(
                fxn.kwargs.get("output_zero_point", fxn.args[2]
                               if len(fxn.args) > 2 else None))
            name, layout = self.env[x]
            out = self._float_hardswish(name)
            self._q_dq(fxn, out, layout, float(scale),
                       self._zp_shift(zp, self._act_dtype(), torch))
        elif t is ops_q.leaky_relu:
            # quantized::leaky_relu(qx, negative_slope, inplace,
            #                       output_scale, output_zero_point)
            x, alpha = fxn.args[0], float(self._concrete(fxn.args[1]))
            scale = self._concrete(
                fxn.kwargs.get("output_scale", fxn.args[3]
                               if len(fxn.args) > 3 else None))
            zp = self._concrete(
                fxn.kwargs.get("output_zero_point", fxn.args[4]
                               if len(fxn.args) > 4 else None))
            name, layout = self.env[x]
            out = self.b.call("nn.leaky_relu", name, alpha=alpha,
                              name=fxn.name + "_f")
            self._q_dq(fxn, out, layout, float(scale),
                       self._zp_shift(zp, self._act_dtype(), torch))
        elif t is ops_q.relu6:
            # quantized::relu6 keeps the input's scale/zp (qrelu.cpp clips
            # at [zp, q(6)]); float clip(0, 6) + requantize at the same
            # params reproduces it to the 1-quantum parity bar
            x = fxn.args[0]
            name, layout = self.env[x]
            out = self.b.call("clip", name, a_min=0.0, a_max=6.0,
                              name=fxn.name + "_f")
            s, z8 = self._in_qparams(x)
            self._q_dq(fxn, out, layout, s, z8)
        elif t is ops_q.add_scalar:
            self._q_add_scalar(fxn, fxn.args[0],
                               float(self._concrete(fxn.args[1])))
        elif t is ops_q.mul_scalar:
            self._q_mul_scalar(fxn, fxn.args[0],
                               float(self._concrete(fxn.args[1])))
        elif t is ops_q.cat:
            tensors, dim, scale, zp = (fxn.args[0], fxn.args[1],
                                       fxn.args[2], fxn.args[3])
            names = [self.as_torch(x) for x in tensors]
            out = self.b.call("concatenate", *names, axis=int(dim),
                              name=fxn.name + "_f")
            self._q_dq(fxn, out, "torch", float(self._concrete(scale)),
                       self._zp_shift(self._concrete(zp), self._act_dtype(),
                                      torch))
        else:
            super().call_function(fxn)
            # scale-preserving float fallbacks (pools, flatten, reshape,
            # interpolate) keep the producer's qparams flowing
            if fxn.args and hasattr(fxn.args[0], "op") \
                    and fxn.args[0] in self._qp and fxn in self.env:
                self._qp[fxn] = self._qp[fxn.args[0]]


def _subclasses(cls):
    for c in cls.__subclasses__():
        yield c
        yield from _subclasses(c)


def torch_load(path):
    """`torch.load` of a torch.save'd model (weights_only=False, onto the
    CPU) that also reads torch.ao-quantized modules.  Their `__setstate__`
    (quantized convs: `_ConvNd`) sets attributes on the object pickle made
    without `__init__`, so the module lacks `_modules` and the fx
    GraphModule that holds it fails while it is being unpickled; while the
    file is read, each such `__setstate__` first gives the object
    `nn.Module.__init__`'s state."""
    import torch
    import torch.ao.nn.intrinsic.quantized  # noqa: F401  (defines the classes)
    import torch.ao.nn.quantized  # noqa: F401

    saved = []
    for cls in set(_subclasses(torch.nn.Module)):
        if cls.__module__.startswith(("torch.ao.nn.quantized",
                                      "torch.ao.nn.intrinsic.quantized")) \
                and "__setstate__" in vars(cls):
            orig = vars(cls)["__setstate__"]

            def setstate(self, state, _orig=orig):
                if "_modules" not in self.__dict__:
                    torch.nn.Module.__init__(self)
                _orig(self, state)

            saved.append((cls, orig))
            cls.__setstate__ = setstate
    try:
        return torch.load(path, weights_only=False, map_location="cpu")
    finally:
        for cls, orig in saved:
            cls.__setstate__ = orig


def from_torch_quantized(model, example_inputs,
                         input_dtypes: dict[str, str] | None = None) -> Graph:
    """Import a torch.ao-quantized model as a QDQ float graph (run
    `quantize.fq2i.fq2i` on the result for the integer graph, or use
    `import_torch_quantized`).

    model: the output of torch.ao convert_fx (a GraphModule), or an
    eager-converted nn.Module (QuantStub/DeQuantStub style — symbolically
    traced here).  example_inputs: dict name -> TORCH shape (NCHW for
    vision), or a single shape tuple."""
    import torch
    import torch.fx

    if isinstance(example_inputs, (tuple, list)) and example_inputs and \
            isinstance(example_inputs[0], int):
        example_inputs = {"x": tuple(example_inputs)}
    gm = model if isinstance(model, torch.fx.GraphModule) \
        else torch.fx.symbolic_trace(model.eval())

    dts = input_dtypes or {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    ex, var_names = {}, {}
    names = list(example_inputs)
    for i, p in enumerate(placeholders):
        key = p.name if p.name in example_inputs else names[i]
        ex[p.name] = (tuple(example_inputs[key]), dts.get(key, "float32"))
        var_names[p.name] = key
    imp = _QImporter(gm, ex)
    imp.var_names = var_names
    return imp.run()


def import_torch_quantized(model, example_inputs,
                           input_dtypes: dict[str, str] | None = None,
                           config=None) -> Graph:
    """One call: torch.ao-quantized model -> integer-only graph using the
    model's own scales (no calibration)."""
    from ..quantize.fq2i import fq2i

    return fq2i(from_torch_quantized(model, example_inputs, input_dtypes),
                config)
