"""The long-tail ops of the ONNX importer (port of part of
`tachikoma_tpu/ops/extra.py`): the trigonometric and hyperbolic functions,
`isnan` / `isinf`, `logical_xor`, `bitwise_not`, `nn.lrn` and `nn.instance_norm`,
`reverse`, `cumsum` and `topk`; and `stack`, the TensorFlow importer's Pack.
The rest of that file waits for ROADMAP Queue 1 item 9.4.

Each op has the JAX package's relation and numpy oracle, copied, and a torch
impl that computes the oracle's values on any device:
- the unary functions cast to float32 and back, as the oracle does;
- `cumsum` accumulates int8 to int32 inputs in int32 (wrapping as numpy's);
- `topk` is a stable ascending sort of a sort key that reverses the order
  of the values: `-a` for floats (exact, so float results are the oracle's
  bit for bit), `~a` for integers and bools (`-a - 1`, which never wraps).
  Ties go to the lowest index, as in `lax.top_k` and the oracle.  The
  oracle negates integers in their own dtype, so int8 -128 (and every
  nonzero uint8) sorts wrongly there; the port follows `lax.top_k`
  (ROADMAP Queue 3).  torch.topk's tie order is unspecified on CUDA;
- `nn.lrn` sums the window's squares one shifted slice at a time, in the
  oracle's order, and `nn.instance_norm` runs the oracle's float32 sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import infer_rule, np_impl, register_op, torch_impl
from .fixed_point import torch_dtype
from .nn import _dtype_name, _same_rel, broadcast_shapes


def _register_unary(name: str, np_fn, torch_fn):
    def np_i(x, *, node: Node):
        return np_fn(x.astype(np.float32)).astype(x.dtype)

    def torch_i(x: torch.Tensor, *, node: Node) -> torch.Tensor:
        return torch_fn(x.to(torch.float32)).to(x.dtype)

    register_op(name, infer=_same_rel, np_impl=np_i, torch_impl=torch_i)


for _n, (_f, _tf) in {
    "sin": (np.sin, torch.sin), "cos": (np.cos, torch.cos), "tan": (np.tan, torch.tan),
    "asin": (np.arcsin, torch.asin), "acos": (np.arccos, torch.acos),
    "atan": (np.arctan, torch.atan), "sinh": (np.sinh, torch.sinh),
    "cosh": (np.cosh, torch.cosh),
}.items():
    _register_unary(_n, _f, _tf)


def _pred_rel(node, ins):
    (a, _) = ins[0]
    return tuple(a), "bool"


for _n, (_f, _tf) in {"isnan": (np.isnan, torch.isnan), "isinf": (np.isinf, torch.isinf)}.items():
    def _mk(f, tf):
        def np_i(x, *, node: Node):
            return f(x.astype(np.float32))

        def torch_i(x: torch.Tensor, *, node: Node) -> torch.Tensor:
            return tf(x.to(torch.float32))
        return np_i, torch_i
    _np_i, _torch_i = _mk(_f, _tf)
    register_op(_n, infer=_pred_rel, np_impl=_np_i, torch_impl=_torch_i)


@infer_rule("logical_xor")
def _lxor_rel(node, ins):
    (a, _), (b, _) = ins[0], ins[1]
    return broadcast_shapes(a, b), "bool"


@np_impl("logical_xor")
def _lxor_np(a, b, *, node: Node):
    return np.logical_xor(a, b)


@torch_impl("logical_xor")
def _lxor_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.logical_xor(a, b)


register_op("bitwise_not", infer=_same_rel,
            np_impl=lambda a, *, node: np.bitwise_not(a),
            torch_impl=lambda a, *, node: torch.bitwise_not(a))


# -- normalization -----------------------------------------------------------

@infer_rule("nn.lrn")
def _lrn_rel(node, ins):
    return ins[0]


def _lrn_args(node: Node, ndim: int):
    return (int(node.attrs.get("size", 5)), int(node.attrs.get("axis", -1)) % ndim,
            np.float32(node.attrs.get("alpha", 1e-4)), np.float32(node.attrs.get("beta", 0.75)),
            np.float32(node.attrs.get("bias", 2.0)))


def _lrn_math(x, size, axis, alpha, beta, bias):
    half = size // 2
    sq = x * x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (half, half)
    sq_p = np.pad(sq, pads)
    acc = np.zeros_like(x)
    for i in range(size):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + x.shape[axis])
        acc = acc + sq_p[tuple(sl)]
    return x / (bias + (alpha / size) * acc) ** beta


@np_impl("nn.lrn")
def _lrn_np(x, *, node: Node):
    return _lrn_math(x.astype(np.float32), *_lrn_args(node, x.ndim)).astype(x.dtype)


@torch_impl("nn.lrn")
def _lrn_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's float32 sequence: the squares zero-padded along `axis`,
    summed one shifted slice at a time, then x / (bias + alpha / size *
    acc) ** beta with the scalars in float32 (numpy's weak-scalar rule keeps
    every step float32)."""
    size, axis, alpha, beta, bias = _lrn_args(node, x.ndim)
    x32 = x.to(torch.float32)
    sq = x32 * x32
    pad = [0, 0] * (x.ndim - 1 - axis) + [size // 2, size // 2]
    sq_p = torch.nn.functional.pad(sq, pad)
    acc = torch.zeros_like(x32)
    for i in range(size):
        acc = acc + sq_p.narrow(axis, i, x.shape[axis])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    coef = f32(alpha / size)  # np.float32 / int: float32
    return (x32 / torch.pow(f32(bias) + coef * acc, f32(beta))).to(x.dtype)


@infer_rule("nn.instance_norm")
def _in_rel(node, ins):
    return ins[0]


def _instance_norm(x, gamma, beta, axis, eps, xp):
    """The oracle's `_inst_group_norm` at one group per channel, over numpy
    (`xp` = np) or torch: normalize over the spatial dims, float32."""
    n, c = x.shape[0], x.shape[axis]
    moved = xp.moveaxis(x, axis, -1)
    spatial = moved.shape[1:-1]
    grouped = moved.reshape(n, int(np.prod(spatial)), c, 1)
    if xp is np:
        mu = grouped.mean(axis=(1, 3), keepdims=True)
        var = ((grouped - mu) ** 2).mean(axis=(1, 3), keepdims=True)
    else:
        mu = grouped.mean(dim=(1, 3), keepdim=True)
        var = ((grouped - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    normed = (grouped - mu) / xp.sqrt(var + eps)
    normed = normed.reshape(moved.shape)
    bshape = (1,) * (moved.ndim - 1) + (-1,)
    normed = normed * gamma.reshape(bshape) + beta.reshape(bshape)
    return xp.moveaxis(normed, -1, axis)


@np_impl("nn.instance_norm")
def _in_np(x, gamma, beta, *, node: Node):
    axis = int(node.attrs.get("axis", -1)) % x.ndim
    out = _instance_norm(x.astype(np.float32), gamma, beta, axis,
                         np.float32(node.attrs.get("epsilon", 1e-5)), np)
    return out.astype(x.dtype)


@torch_impl("nn.instance_norm")
def _in_torch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
              node: Node) -> torch.Tensor:
    axis = int(node.attrs.get("axis", -1)) % x.ndim
    eps = torch.tensor(np.float32(node.attrs.get("epsilon", 1e-5)), device=x.device)
    return _instance_norm(x.to(torch.float32), gamma, beta, axis, eps, torch).to(x.dtype)


# -- transforms --------------------------------------------------------------

@infer_rule("reverse")
def _rev_rel(node, ins):
    return ins[0]


@np_impl("reverse")
def _rev_np(a, *, node: Node):
    return np.flip(a, axis=int(node.attrs["axis"]))


@torch_impl("reverse")
def _rev_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.flip(a, dims=(int(node.attrs["axis"]),))


def _cumsum_dtype(node: Node, adt: str) -> str:
    return node.attrs.get("dtype") or (
        "int32" if adt in ("int8", "uint8", "int16", "int32") else adt)


@infer_rule("cumsum")
def _cumsum_rel(node, ins):
    (a, adt) = ins[0]
    if str(adt) in ("int8", "uint8", "int16", "int32"):
        return tuple(a), node.attrs.get("dtype", "int32")
    return tuple(a), node.attrs.get("dtype", adt)


@np_impl("cumsum")
def _cumsum_np(a, *, node: Node):
    axis = node.attrs.get("axis")
    dtype = _cumsum_dtype(node, str(a.dtype))
    return np.cumsum(a.astype(dtype), axis=axis).astype(dtype)


@torch_impl("cumsum")
def _cumsum_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """In the oracle's dtype (int32 for int8 to int32 inputs): an integer
    sum is exact modulo 2^64 in torch's int64 accumulator and wraps into it
    as numpy's does; with no axis, over the flattened input."""
    axis = node.attrs.get("axis")
    dtype = torch_dtype(_cumsum_dtype(node, _dtype_name(a)))
    x = a.to(dtype)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=int(axis), dtype=dtype)


@infer_rule("topk")
def _topk_rel(node, ins):
    (a, adt) = ins[0]
    k = int(node.attrs["k"])
    axis = int(node.attrs.get("axis", -1)) % len(a)
    shape = list(a)
    shape[axis] = k
    ret = node.attrs.get("ret_type", "both")
    if ret == "both":
        return [(tuple(shape), adt), (tuple(shape), node.attrs.get("dtype", "int32"))]
    if ret == "values":
        return tuple(shape), adt
    return tuple(shape), node.attrs.get("dtype", "int32")


def _topk_out(vals, idx, node: Node):
    ret = node.attrs.get("ret_type", "both")
    if ret == "both":
        return [vals, idx]
    return vals if ret == "values" else idx


@np_impl("topk")
def _topk_np(a, *, node: Node):
    k = int(node.attrs["k"])
    axis = int(node.attrs.get("axis", -1)) % a.ndim
    moved = np.moveaxis(a, axis, -1)
    idx = np.argsort(_descending_key(moved), axis=-1, kind="stable")[..., :k]
    vals = np.take_along_axis(moved, idx, axis=-1)
    vals = np.moveaxis(vals, -1, axis)
    idx = np.moveaxis(idx, -1, axis).astype(node.attrs.get("dtype", "int32"))
    return _topk_out(vals, idx, node)


def _descending_key(a):
    """A key whose ascending order is `a`'s descending order: -a for floats,
    ~a (= -a - 1, no wrap at the dtype's minimum) for integers and bools."""
    if isinstance(a, torch.Tensor):
        return torch.neg(a) if a.dtype.is_floating_point else torch.bitwise_not(a)
    return -a if a.dtype.kind in "fc" else np.invert(a)


@torch_impl("topk")
def _topk_torch(a: torch.Tensor, *, node: Node):
    """A stable ascending sort of the descending key, its first k indices,
    the values gathered from a."""
    k = int(node.attrs["k"])
    axis = int(node.attrs.get("axis", -1)) % a.ndim
    moved = a.movedim(axis, -1)
    _, order = torch.sort(_descending_key(moved), dim=-1, stable=True)
    idx = order[..., :k]
    vals = torch.gather(moved, -1, idx).movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(torch_dtype(node.attrs.get("dtype", "int32")))
    return _topk_out(vals, idx, node)


# ---------------------------------------------------------------------------
# stack: TensorFlow's Pack
# ---------------------------------------------------------------------------

@infer_rule("stack")
def _stack_rel(node, ins):
    axis = int(node.attrs.get("axis", 0))
    (a, adt) = ins[0]
    axis = axis % (len(a) + 1)
    return tuple(a[:axis]) + (len(ins),) + tuple(a[axis:]), adt


@np_impl("stack")
def _stack_np(*args, node: Node):
    return np.stack(args, axis=int(node.attrs.get("axis", 0)))


@torch_impl("stack")
def _stack_torch(*args: torch.Tensor, node: Node) -> torch.Tensor:
    """np.stack of inputs of one dtype (TensorFlow's Pack), a negative axis
    counted from the end of the output's shape."""
    return torch.stack(args, dim=int(node.attrs.get("axis", 0)))
