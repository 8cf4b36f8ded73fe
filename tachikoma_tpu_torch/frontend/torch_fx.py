"""PyTorch frontend: torch.fx graph -> Graph (port of
`tachikoma_tpu/frontend/torch_fx.py`, handler for handler).

The counterpart of Relay's `from_pytorch`, built on torch.fx, converting
NCHW to NHWC at import time because the op set is NHWC/HWIO-only.

Layout tracking: every produced value carries a layout tag —
  'nhwc'  : a 4D conv-domain tensor stored transposed (torch NCHW -> NHWC)
  'torch' : stored exactly as torch would (any rank)
Shape-sensitive ops (reshape/flatten/matmul/linear/cat-on-C...) coerce their
input back to 'torch' layout with an explicit transpose; conv/pool/bn run in
'nhwc'.

The graph is the JAX importer's, byte for byte (`Graph.to_json`), so every
op a handler emits has its relation, oracle and torch impl in the port's
ops/ (`nn.silu` in nn.py, `nn.upsampling` in tail2.py).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types


def _to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Importer:
    def __init__(self, gm, example_inputs: dict[str, tuple[tuple[int, ...], str]]):
        import torch

        self.torch = torch
        self.gm = gm
        self.b = GraphBuilder("from_torch")
        # fx node -> (graph node name, layout)
        self.env: dict[Any, tuple[str, str]] = {}
        self.example_inputs = example_inputs
        self.modules = dict(gm.named_modules())

    # -- static python values (shape arithmetic folds at import) ------------
    _PYVAL = "#pyval"

    def set_pyval(self, fxn, value):
        self.env[fxn] = (self._PYVAL, value)

    def is_pyval(self, arg) -> bool:
        return hasattr(arg, "op") and arg in self.env and self.env[arg][0] == self._PYVAL

    def pyval(self, arg):
        """Concrete python value of an fx arg (int/tuple/slice or literal)."""
        if self.is_pyval(arg):
            return self.env[arg][1]
        if hasattr(arg, "op"):
            raise NotImplementedError(f"expected a static value, got node {arg}")
        return arg

    def shape_via_infer(self, fxn) -> tuple[int, ...]:
        name = self.as_torch(fxn)
        g_tmp = infer_types(self.b.build([name]))
        return g_tmp[name].shape

    # -- layout helpers -----------------------------------------------------
    def as_torch(self, fxn) -> str:
        name, layout = self.env[fxn]
        if layout == "nhwc":
            name = self.b.call("transpose", name, axes=(0, 3, 1, 2))
            self.env[fxn] = (name, "torch")
        return name

    def as_nhwc(self, fxn) -> str:
        name, layout = self.env[fxn]
        if layout == "torch":
            name = self.b.call("transpose", name, axes=(0, 2, 3, 1))
            self.env[fxn] = (name, "nhwc")
        return name

    def layout_of(self, fxn) -> str:
        return self.env[fxn][1]

    def set(self, fxn, name: str, layout: str):
        self.env[fxn] = (name, layout)

    # -- module handlers ----------------------------------------------------
    def conv2d(self, fxn, mod):
        x = self.as_nhwc(fxn.args[0])
        w = _to_np(mod.weight)  # OIHW
        groups = mod.groups
        w_hwio = np.transpose(w, (2, 3, 1, 0))  # -> HW I O  (I = in/groups)
        wn = self.b.const(np.ascontiguousarray(w_hwio), name=fxn.name + "_w")
        pad = mod.padding
        if isinstance(pad, str):
            raise NotImplementedError("string padding not supported")
        ph, pw = (pad, pad) if isinstance(pad, int) else pad
        out = self.b.call(
            "nn.conv2d", x, wn,
            strides=mod.stride if not isinstance(mod.stride, int) else (mod.stride,) * 2,
            padding=(ph, pw, ph, pw),
            dilation=mod.dilation if not isinstance(mod.dilation, int) else (mod.dilation,) * 2,
            groups=groups, name=fxn.name,
        )
        if mod.bias is not None:
            bn = self.b.const(_to_np(mod.bias), name=fxn.name + "_b")
            out = self.b.call("nn.bias_add", out, bn, axis=-1)
        self.set(fxn, out, "nhwc")

    def conv_transpose2d(self, fxn, mod):
        """torch ConvTranspose2d: weight (IN, OUT/groups, KH, KW); torch
        `padding` crops the full transposed output on BOTH sides, matching
        nn.conv2d_transpose's padding attr (ops/nn.py) directly."""
        x = self.as_nhwc(fxn.args[0])
        if getattr(mod, "groups", 1) != 1:
            raise NotImplementedError("grouped ConvTranspose2d")
        w = _to_np(mod.weight)  # (in, out, kh, kw)
        w_hwio = np.transpose(w, (2, 3, 0, 1))  # -> (kh, kw, in, out)
        wn = self.b.const(np.ascontiguousarray(w_hwio), name=fxn.name + "_w")
        pad = mod.padding
        ph, pw = (pad, pad) if isinstance(pad, int) else pad
        st = mod.stride if not isinstance(mod.stride, int) \
            else (mod.stride,) * 2
        op = mod.output_padding if not isinstance(mod.output_padding, int) \
            else (mod.output_padding,) * 2
        dil = mod.dilation if not isinstance(mod.dilation, int) \
            else (mod.dilation,) * 2
        if tuple(dil) != (1, 1):
            raise NotImplementedError("dilated ConvTranspose2d")
        out = self.b.call("nn.conv2d_transpose", x, wn, strides=tuple(st),
                          padding=(ph, pw, ph, pw),
                          output_padding=tuple(op), name=fxn.name)
        if mod.bias is not None:
            bn = self.b.const(_to_np(mod.bias), name=fxn.name + "_b")
            out = self.b.call("nn.bias_add", out, bn, axis=-1)
        self.set(fxn, out, "nhwc")

    def linear(self, fxn, mod):
        x = self.as_torch(fxn.args[0])
        w = _to_np(mod.weight)  # (out, in)
        wn = self.b.const(np.ascontiguousarray(w.T), name=fxn.name + "_w")
        out = self.b.call("nn.dense", x, wn, name=fxn.name)
        if mod.bias is not None:
            bn = self.b.const(_to_np(mod.bias), name=fxn.name + "_b")
            out = self.b.call("nn.bias_add", out, bn, axis=-1)
        self.set(fxn, out, "torch")

    def batch_norm(self, fxn, mod):
        x = self.as_nhwc(fxn.args[0])
        out = self.b.call(
            "nn.batch_norm", x,
            self.b.const(_to_np(mod.weight), name=fxn.name + "_g"),
            self.b.const(_to_np(mod.bias), name=fxn.name + "_b"),
            self.b.const(_to_np(mod.running_mean), name=fxn.name + "_m"),
            self.b.const(_to_np(mod.running_var), name=fxn.name + "_v"),
            epsilon=mod.eps, name=fxn.name,
        )
        self.set(fxn, out, "nhwc")

    def layer_norm(self, fxn, mod):
        x = self.as_torch(fxn.args[0])
        out = self.b.call(
            "nn.layer_norm", x,
            self.b.const(_to_np(mod.weight), name=fxn.name + "_g"),
            self.b.const(_to_np(mod.bias), name=fxn.name + "_b"),
            axis=-1, epsilon=mod.eps, name=fxn.name,
        )
        self.set(fxn, out, "torch")

    def embedding(self, fxn, mod):
        idx = self.as_torch(fxn.args[0])
        tbl = self.b.const(_to_np(mod.weight), name=fxn.name + "_w")
        out = self.b.call("take", tbl, idx, axis=0, name=fxn.name)
        self.set(fxn, out, "torch")

    def pool2d(self, fxn, mod, kind: str):
        x = self.as_nhwc(fxn.args[0])
        ks = mod.kernel_size if not isinstance(mod.kernel_size, int) else (mod.kernel_size,) * 2
        st = mod.stride or mod.kernel_size
        st = st if not isinstance(st, int) else (st,) * 2
        pad = mod.padding if not isinstance(mod.padding, int) else (mod.padding,) * 2
        attrs = dict(
            pool_size=ks, strides=st, padding=(pad[0], pad[1], pad[0], pad[1]),
            ceil_mode=getattr(mod, "ceil_mode", False),
        )
        if kind == "avg":
            attrs["count_include_pad"] = getattr(mod, "count_include_pad", True)
        out = self.b.call(f"nn.{kind}_pool2d", x, name=fxn.name, **attrs)
        self.set(fxn, out, "nhwc")

    def adaptive_avg_pool2d(self, fxn, output_size):
        x = self.as_nhwc(fxn.args[0])
        if isinstance(output_size, int):
            output_size = (output_size, output_size)
        out = self.b.call("nn.adaptive_avg_pool2d", x, output_size=tuple(output_size), name=fxn.name)
        self.set(fxn, out, "nhwc")

    # -- generic elementwise -------------------------------------------------
    def _same_layout_unary(self, fxn, op, **attrs):
        name, layout = self.env[fxn.args[0]]
        out = self.b.call(op, name, name=fxn.name, **attrs)
        self.set(fxn, out, layout)

    def _binary(self, fxn, op):
        a, c = fxn.args[0], fxn.args[1]
        a_is_node = hasattr(a, "op")
        c_is_node = hasattr(c, "op")
        if a_is_node and c_is_node:
            la, lc = self.layout_of(a), self.layout_of(c)
            if la == lc:
                an, cn = self.env[a][0], self.env[c][0]
                layout = la
            else:
                an, cn = self.as_torch(a), self.as_torch(c)
                layout = "torch"
            out = self.b.call(op, an, cn, name=fxn.name)
            self.set(fxn, out, layout)
        else:
            node, scalar = (a, c) if a_is_node else (c, a)
            nn_, layout = self.env[node]
            sc = self.b.const(np.asarray(scalar, dtype=np.float32))
            args = (nn_, sc) if a_is_node else (sc, nn_)
            out = self.b.call(op, *args, name=fxn.name)
            self.set(fxn, out, layout)

    # -- the walk ------------------------------------------------------------
    def run(self) -> Graph:
        for fxn in self.gm.graph.nodes:
            if fxn.op == "placeholder":
                shape, dtype = self.example_inputs[fxn.name]
                var_name = getattr(self, "var_names", {}).get(fxn.name, fxn.name)
                name = self.b.var(var_name, shape, dtype)
                self.set(fxn, name, "torch")
            elif fxn.op == "get_attr":
                self.get_attr(fxn)
            elif fxn.op == "call_module":
                self.call_module(fxn, self.modules[fxn.target])
            elif fxn.op == "call_function" or fxn.op == "call_method":
                self.call_function(fxn)
            elif fxn.op == "output":
                outs = fxn.args[0]
                if isinstance(outs, dict):
                    outs = list(outs.values())  # insertion order = model order
                elif not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                out_names = [self.as_torch(o) for o in outs if hasattr(o, "op")]
                return infer_types(self.b.build(out_names))
        raise RuntimeError("fx graph had no output node")

    def get_attr(self, fxn):
        val = self.gm
        for part in fxn.target.split("."):
            val = getattr(val, part)
        cn = self.b.const(_to_np(val), name=fxn.name)
        self.set(fxn, cn, "torch")

    def call_module(self, fxn, mod):
        torch = self.torch
        nnm = torch.nn

        MODULE_MAP: dict[type, Callable] = {
            nnm.Conv2d: self.conv2d,
            nnm.ConvTranspose2d: self.conv_transpose2d,
            nnm.Linear: self.linear,
            nnm.BatchNorm2d: self.batch_norm,
            nnm.LayerNorm: self.layer_norm,
            nnm.Embedding: self.embedding,
        }
        h = MODULE_MAP.get(type(mod))
        if h is not None:
            h(fxn, mod)
        elif isinstance(mod, nnm.ReLU):
            self._same_layout_unary(fxn, "nn.relu")
        elif isinstance(mod, nnm.ReLU6):
            self._same_layout_unary(fxn, "clip", a_min=0.0, a_max=6.0)
        elif isinstance(mod, nnm.Hardtanh):
            self._same_layout_unary(fxn, "clip", a_min=mod.min_val, a_max=mod.max_val)
        elif isinstance(mod, nnm.GELU):
            self._same_layout_unary(
                fxn, "nn.gelu",
                approximate="tanh" if mod.approximate == "tanh" else "none",
            )
        elif isinstance(mod, nnm.SiLU):
            self._same_layout_unary(fxn, "nn.silu")
        elif isinstance(mod, nnm.Sigmoid):
            self._same_layout_unary(fxn, "sigmoid")
        elif isinstance(mod, nnm.Tanh):
            self._same_layout_unary(fxn, "tanh")
        elif isinstance(mod, nnm.Softmax):
            x = self.as_torch(fxn.args[0])
            out = self.b.call("nn.softmax", x, axis=mod.dim, name=fxn.name)
            self.set(fxn, out, "torch")
        elif isinstance(mod, (nnm.Dropout, nnm.Identity)):
            self.set(fxn, *self.env[fxn.args[0]])
        elif isinstance(mod, nnm.MaxPool2d):
            self.pool2d(fxn, mod, "max")
        elif isinstance(mod, nnm.AvgPool2d):
            self.pool2d(fxn, mod, "avg")
        elif isinstance(mod, nnm.AdaptiveAvgPool2d):
            self.adaptive_avg_pool2d(fxn, mod.output_size)
        elif isinstance(mod, nnm.Flatten):
            x = self.as_torch(fxn.args[0])
            assert mod.start_dim == 1 and mod.end_dim == -1
            out = self.b.call("nn.batch_flatten", x, name=fxn.name)
            self.set(fxn, out, "torch")
        elif isinstance(mod, nnm.LeakyReLU):
            self._same_layout_unary(fxn, "nn.leaky_relu",
                                    alpha=float(mod.negative_slope))
        elif isinstance(mod, (nnm.Upsample, nnm.UpsamplingNearest2d)):
            if getattr(mod, "mode", "nearest") != "nearest":
                raise NotImplementedError(
                    f"Upsample mode {mod.mode} (nearest only)")
            sf = mod.scale_factor
            sh, sw = (sf, sf) if not isinstance(sf, (tuple, list)) else sf
            x = self.as_nhwc(fxn.args[0])
            out = self.b.call("nn.upsampling", x, scale_h=float(sh),
                              scale_w=float(sw), name=fxn.name)
            self.set(fxn, out, "nhwc")
        elif isinstance(mod, nnm.Hardswish):
            name, layout = self.env[fxn.args[0]]
            c3 = self.b.const(np.float32(3.0))
            c6 = self.b.const(np.float32(6.0))
            s = self.b.call("add", name, c3)
            s = self.b.call("clip", s, a_min=0.0, a_max=6.0)
            s = self.b.call("multiply", name, s)
            out = self.b.call("divide", s, c6, name=fxn.name)
            self.set(fxn, out, layout)
        elif isinstance(mod, nnm.Hardsigmoid):
            name, layout = self.env[fxn.args[0]]
            c3 = self.b.const(np.float32(3.0))
            c6 = self.b.const(np.float32(6.0))
            s = self.b.call("add", name, c3)
            s = self.b.call("clip", s, a_min=0.0, a_max=6.0)
            out = self.b.call("divide", s, c6, name=fxn.name)
            self.set(fxn, out, layout)
        else:
            raise NotImplementedError(f"module {type(mod).__name__} ({fxn.target})")

    def call_function(self, fxn):
        import operator

        torch = self.torch
        F = torch.nn.functional
        t = fxn.target

        # shape arithmetic/comparison on static values folds eagerly
        if t in (operator.add, operator.sub, operator.mul, operator.truediv,
                 operator.floordiv, operator.mod, operator.pow,
                 operator.eq, operator.ne, operator.lt, operator.le,
                 operator.gt, operator.ge) and all(
            self.is_pyval(a) or not hasattr(a, "op") for a in fxn.args
        ):
            vals = [self.pyval(a) for a in fxn.args]
            self.set_pyval(fxn, t(*vals))
            return
        if t in (operator.add, torch.add, "add"):
            self._binary(fxn, "add")
        elif t in (operator.sub, torch.sub, "sub"):
            self._binary(fxn, "subtract")
        elif t in (operator.mul, torch.mul, "mul"):
            self._binary(fxn, "multiply")
        elif t in (operator.truediv, torch.div, "div"):
            self._binary(fxn, "divide")
        elif t in (operator.matmul, torch.matmul, "matmul", torch.bmm, "bmm"):
            a = self.as_torch(fxn.args[0])
            c = self.as_torch(fxn.args[1])
            out = self.b.call("nn.batch_matmul", a, c, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in (F.relu, torch.relu, "relu"):
            self._same_layout_unary(fxn, "nn.relu")
        elif t is F.relu6:
            self._same_layout_unary(fxn, "clip", a_min=0.0, a_max=6.0)
        elif t in (F.gelu, "gelu"):
            approx = fxn.kwargs.get("approximate", "none")
            self._same_layout_unary(fxn, "nn.gelu", approximate=approx)
        elif t is F.silu:
            self._same_layout_unary(fxn, "nn.silu")
        elif t is torch.nn.functional.hardswish:
            # x * clip(x+3, 0, 6) / 6 (NOT silu — distinct activation)
            x, layout = self.env[fxn.args[0]]
            three = self.b.const(np.float32(3.0))
            six = self.b.const(np.float32(6.0))
            gate = self.b.call("clip", self.b.call("add", x, three),
                               a_min=0.0, a_max=6.0)
            out = self.b.call(
                "divide", self.b.call("multiply", x, gate), six,
                name=fxn.name)
            self.set(fxn, out, layout)
        elif t in (torch.sigmoid, F.sigmoid, "sigmoid"):
            self._same_layout_unary(fxn, "sigmoid")
        elif t in (torch.tanh, F.tanh, "tanh"):
            self._same_layout_unary(fxn, "tanh")
        elif t in (F.softmax, torch.softmax, "softmax"):
            x = self.as_torch(fxn.args[0])
            dim = fxn.kwargs.get("dim", fxn.args[1] if len(fxn.args) > 1 else -1)
            out = self.b.call("nn.softmax", x, axis=dim, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in (torch.flatten, "flatten"):
            x = self.as_torch(fxn.args[0])
            start = fxn.args[1] if len(fxn.args) > 1 else fxn.kwargs.get("start_dim", 0)
            assert start == 1, "only flatten(start_dim=1) supported"
            out = self.b.call("nn.batch_flatten", x, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in ("view", "reshape", torch.reshape):
            x = self.as_torch(fxn.args[0])
            shape = fxn.args[1:] if not isinstance(fxn.args[1], (list, tuple)) else fxn.args[1]
            shape = tuple(int(self.pyval(s)) if (self.is_pyval(s) or not hasattr(s, "op")) else -1
                          for s in shape)
            out = self.b.call("reshape", x, newshape=shape, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in ("expand", torch.Tensor.expand if hasattr(torch.Tensor, "expand") else "expand"):
            x = self.as_torch(fxn.args[0])
            in_shape = self.shape_via_infer(fxn.args[0])
            tgt = [self.pyval(a) for a in fxn.args[1:]]
            tgt = [in_shape[i] if v == -1 else int(v) for i, v in enumerate(tgt)]
            out = self.b.call("broadcast_to", x, shape=tuple(tgt), name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in ("unsqueeze", torch.unsqueeze):
            name, layout = self.env[fxn.args[0]]
            out = self.b.call("expand_dims", name, axis=fxn.args[1], name=fxn.name)
            self.set(fxn, out, "torch" if layout == "torch" else layout)
        elif t in ("to", "type_as", "float", "long", "int"):
            # dtype casts: map to our cast or passthrough
            src = fxn.args[0]
            name, layout = self.env[src]
            target = None
            if t == "float":
                target = "float32"
            elif t in ("long", "int"):
                target = "int32"
            elif len(fxn.args) > 1 and isinstance(fxn.args[1], torch.dtype):
                target = {torch.float32: "float32", torch.int64: "int32",
                          torch.int32: "int32", torch.bool: "bool",
                          torch.float16: "float32"}.get(fxn.args[1])
            if target is None:
                self.set(fxn, name, layout)
            else:
                self.set(fxn, self.b.call("cast", name, dtype=target, name=fxn.name), layout)
        elif t in ("permute", torch.permute):
            x = self.as_torch(fxn.args[0])
            axes = fxn.args[1:] if not isinstance(fxn.args[1], (list, tuple)) else fxn.args[1]
            out = self.b.call("transpose", x, axes=tuple(axes), name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in ("transpose", torch.transpose):
            x = self.as_torch(fxn.args[0])
            d0, d1 = fxn.args[1], fxn.args[2]
            # our transpose needs a full permutation; recover the rank by
            # type-inferring the graph built so far up to x
            g_tmp = infer_types(self.b.build([x]))
            rank = len(g_tmp[x].shape)
            axes = list(range(rank))
            axes[d0 % rank], axes[d1 % rank] = axes[d1 % rank], axes[d0 % rank]
            out = self.b.call("transpose", x, axes=tuple(axes), name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in (torch.cat, "cat"):
            tensors = fxn.args[0]
            dim = fxn.kwargs.get("dim", fxn.args[1] if len(fxn.args) > 1 else 0)
            layouts = {self.layout_of(x) for x in tensors}
            if layouts == {"nhwc"}:
                names = [self.env[x][0] for x in tensors]
                axis = {0: 0, 1: 3, 2: 1, 3: 2}[dim % 4]
                out = self.b.call("concatenate", *names, axis=axis, name=fxn.name)
                self.set(fxn, out, "nhwc")
            else:
                names = [self.as_torch(x) for x in tensors]
                out = self.b.call("concatenate", *names, axis=dim, name=fxn.name)
                self.set(fxn, out, "torch")
        elif t in (torch.chunk, "chunk"):
            x = self.as_torch(fxn.args[0])
            chunks = fxn.args[1]
            dim = fxn.kwargs.get("dim", fxn.args[2] if len(fxn.args) > 2 else 0)
            out = self.b.call("split", x, indices_or_sections=chunks, axis=dim, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in (torch.mean, "mean"):
            x = self.as_torch(fxn.args[0])
            dim = fxn.kwargs.get("dim", fxn.args[1] if len(fxn.args) > 1 else None)
            keepdim = fxn.kwargs.get("keepdim", fxn.args[2] if len(fxn.args) > 2 else False)
            out = self.b.call(
                "mean", x,
                axis=tuple(dim) if isinstance(dim, (list, tuple)) else dim,
                keepdims=keepdim, name=fxn.name,
            )
            self.set(fxn, out, "torch")
        elif t in ("contiguous", torch.clone, "clone", F.dropout, torch.dropout, "detach"):
            self.set(fxn, *self.env[fxn.args[0]])
        elif t is operator.getitem:
            src = fxn.args[0]
            idx = fxn.args[1]
            if self.is_pyval(src):
                self.set_pyval(fxn, self.pyval(src)[self.pyval(idx)])
                return
            src_name, layout = self.env[src]
            if isinstance(idx, int):
                out = self.b.get_item(src_name, idx, name=fxn.name)
                self.set(fxn, out, layout)
            elif isinstance(idx, (slice, tuple)) or idx is None:
                # tensor slicing, e.g. position_ids[:, :seq_len]
                name = self.as_torch(src)
                rank = len(self.shape_via_infer(src))
                idxs = idx if isinstance(idx, tuple) else (idx,)
                begin, end, strides, axes = [], [], [], []
                int_axes = []
                out = name
                ax = 0
                for it in idxs:
                    if it is None:
                        out = self.b.call("expand_dims", out, axis=ax)
                        rank += 1
                        ax += 1
                        continue
                    if isinstance(it, slice):
                        if it != slice(None):
                            begin.append(self.pyval(it.start) if it.start is not None else 0)
                            end.append(self.pyval(it.stop) if it.stop is not None else None)
                            strides.append(self.pyval(it.step) if it.step is not None else 1)
                            axes.append(ax)
                        ax += 1
                    elif isinstance(it, int):
                        begin.append(it)
                        end.append(it + 1)
                        strides.append(1)
                        axes.append(ax)
                        int_axes.append(ax)
                        ax += 1
                    else:
                        raise NotImplementedError(f"getitem index {it!r}")
                if begin:
                    out = self.b.call(
                        "strided_slice", out, begin=tuple(begin), end=tuple(end),
                        strides=tuple(strides), axes=tuple(axes), name=fxn.name,
                    )
                if int_axes:
                    out = self.b.call("squeeze", out, axis=tuple(int_axes))
                self.set(fxn, out, "torch")
            else:
                raise NotImplementedError(f"getitem with {idx!r}")
        elif t in (F.adaptive_avg_pool2d,):
            self.adaptive_avg_pool2d(fxn, fxn.args[1])
        elif t in (F.avg_pool2d,):
            x = self.as_nhwc(fxn.args[0])
            ks = fxn.args[1]
            ks = (ks, ks) if isinstance(ks, int) else tuple(ks)
            out = self.b.call("nn.avg_pool2d", x, pool_size=ks, strides=ks, name=fxn.name)
            self.set(fxn, out, "nhwc")
        elif t in (F.max_pool2d,):
            x = self.as_nhwc(fxn.args[0])
            ks = fxn.args[1]
            ks = (ks, ks) if isinstance(ks, int) else tuple(ks)
            out = self.b.call("nn.max_pool2d", x, pool_size=ks, strides=ks, name=fxn.name)
            self.set(fxn, out, "nhwc")
        elif t in (torch.pow, operator.pow, "pow"):
            self._binary(fxn, "power")
        elif t is getattr:
            attr = fxn.args[1]
            if self.is_pyval(fxn.args[0]):
                self.set_pyval(fxn, getattr(self.pyval(fxn.args[0]), attr))
            elif attr == "shape":
                self.set_pyval(fxn, tuple(int(v) for v in self.shape_via_infer(fxn.args[0])))
            elif attr in ("dtype", "device"):
                self.set_pyval(fxn, attr)  # opaque; only used by to()/casts we ignore
            else:
                raise NotImplementedError(f"getattr {attr!r}")
        elif t in ("size", torch.Tensor.size):
            shape = self.shape_via_infer(fxn.args[0])
            if len(fxn.args) > 1:
                self.set_pyval(fxn, int(shape[fxn.args[1]]))
            else:
                self.set_pyval(fxn, tuple(int(v) for v in shape))
        elif t == "dim":
            self.set_pyval(fxn, len(self.shape_via_infer(fxn.args[0])))
        elif t is F.scaled_dot_product_attention:
            q = self.as_torch(fxn.args[0])
            k = self.as_torch(fxn.args[1])
            v = self.as_torch(fxn.args[2])
            attn_mask = fxn.kwargs.get("attn_mask",
                                       fxn.args[3] if len(fxn.args) > 3 else None)
            assert not fxn.kwargs.get("is_causal", False), "causal sdpa unsupported"
            head_dim = self.shape_via_infer(fxn.args[0])[-1]
            scale = fxn.kwargs.get("scale") or head_dim ** -0.5
            kt = self.b.call("nn.batch_matmul", q, k, transpose_b=True)
            sc = self.b.call("multiply", kt, self.b.const(np.float32(scale)))
            if attn_mask is not None:
                sc = self.b.call("add", sc, self.as_torch(attn_mask))
            att = self.b.call("nn.softmax", sc, axis=-1)
            out = self.b.call("nn.batch_matmul", att, v, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in ("masked_fill", torch.masked_fill):
            x = self.as_torch(fxn.args[0])
            mask = self.as_torch(fxn.args[1])
            fill = self.pyval(fxn.args[2])
            fill = float(fill) if not isinstance(fill, (int, float)) else fill
            fc = self.b.const(np.float32(fill))
            out = self.b.call("where", mask, fc, x, name=fxn.name)
            self.set(fxn, out, "torch")
        elif t in ("mul_", "add_"):
            self._binary(fxn, "multiply" if t == "mul_" else "add")
        elif t is torch.finfo:
            self.set_pyval(fxn, torch.finfo(torch.float32))
        elif t is torch.iinfo:
            self.set_pyval(fxn, torch.iinfo(torch.int32))
        elif t is torch.tensor:
            val = self.pyval(fxn.args[0])
            dtype = fxn.kwargs.get("dtype")
            np_dt = {torch.long: "int32", torch.int64: "int32", torch.int32: "int32",
                     torch.float32: "float32", None: None}.get(dtype)
            arr = np.asarray(val)
            if np_dt:
                arr = arr.astype(np_dt)
            elif arr.dtype == np.int64:
                arr = arr.astype(np.int32)
            cn = self.b.const(arr, name=fxn.name)
            self.set(fxn, cn, "torch")
        elif t in (torch.arange,):
            args = [self.pyval(a) for a in fxn.args]
            dtype = fxn.kwargs.get("dtype")
            np_dt = "int32" if dtype in (torch.long, torch.int64, torch.int32, None) else "float32"
            arr = np.arange(*args).astype(np_dt)
            cn = self.b.const(arr, name=fxn.name)
            self.set(fxn, cn, "torch")
        elif t in (torch.zeros, torch.ones):
            shape = [self.pyval(a) for a in (fxn.args[0] if isinstance(fxn.args[0], (list, tuple)) else fxn.args)]
            fill = np.zeros if t is torch.zeros else np.ones
            arr = fill(tuple(int(v) for v in shape), dtype=np.float32)
            cn = self.b.const(arr, name=fxn.name)
            self.set(fxn, cn, "torch")
        elif t in (torch.rsub,):
            # rsub(a, b) = b - a with b usually scalar
            a = fxn.args[0]
            bscalar = fxn.args[1]
            an, layout = self.env[a]
            sc = self.b.const(np.asarray(self.pyval(bscalar), dtype=np.float32))
            out = self.b.call("subtract", sc, an, name=fxn.name)
            self.set(fxn, out, layout)
        else:
            raise NotImplementedError(f"fx target {t} ({fxn.op})")


def from_torch(model, example_inputs, input_dtypes: dict[str, str] | None = None) -> Graph:
    """Import a torch.nn.Module.

    example_inputs: dict name -> shape tuple, or a single shape tuple for
    single-input models.  Shapes are the TORCH shapes (e.g. NCHW for vision);
    the importer transposes to NHWC internally and the produced Graph's input
    keeps the torch shape.
    """
    import torch
    import torch.fx

    model = model.eval()
    if isinstance(example_inputs, (tuple, list)) and example_inputs and isinstance(
        example_inputs[0], int
    ):
        example_inputs = {"x": tuple(example_inputs)}

    try:
        gm = torch.fx.symbolic_trace(model)
    except Exception:
        # HF transformers models need their specialized tracer
        from transformers.utils import fx as hf_fx

        gm = hf_fx.symbolic_trace(model, input_names=list(example_inputs))

    dts = input_dtypes or {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    ex = {}
    var_names = {}
    names = list(example_inputs)
    for i, p in enumerate(placeholders):
        key = p.name if p.name in example_inputs else names[i]
        ex[p.name] = (tuple(example_inputs[key]), dts.get(key, "float32"))
        var_names[p.name] = key  # graph input keeps the user's name
    imp = _Importer(gm, ex)
    imp.var_names = var_names
    return imp.run()
