"""Core float/int op set of int8 ResNet and MobileNetV2, and the layout ops of
graphs imported from NCHW frameworks (port of `tachikoma_tpu/ops/nn.py`).

Each op gets the JAX package's shape/dtype relation and numpy oracle, copied;
the ops that the fused graphs run outside the kernels also get a torch
implementation that computes the same values on any device.

Layouts are the JAX package's: conv2d data NHWC, weight HWIO; dense data
(..., K), weight (K, N).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import TensorType, infer_rule, np_impl, register_op, torch_impl
from ..utils import dtypes as dt


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def broadcast_shapes(a: Sequence[int], b: Sequence[int]) -> tuple[int, ...]:
    return tuple(int(s) for s in np.broadcast_shapes(tuple(a), tuple(b)))


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v), int(v))
    t = tuple(int(x) for x in v)
    return (t[0], t[0]) if len(t) == 1 else t


def _pad4(v) -> tuple[int, int, int, int]:
    """Normalize padding to (top, left, bottom, right)."""
    if isinstance(v, (int, np.integer)):
        return (int(v),) * 4
    t = tuple(int(x) for x in v)
    if len(t) == 2:
        return (t[0], t[1], t[0], t[1])
    if len(t) == 4:
        return t
    raise ValueError(f"bad padding {v}")


def conv2d_out_hw(h, w, kh, kw, strides, padding, dilation) -> tuple[int, int]:
    sh, sw = _pair(strides)
    dh, dw = _pair(dilation)
    pt, pl, pb, pr = _pad4(padding)
    oh = (h + pt + pb - dh * (kh - 1) - 1) // sh + 1
    ow = (w + pl + pr - dw * (kw - 1) - 1) // sw + 1
    return oh, ow


def _accum_dtype(node: Node, in_dtype: str) -> str:
    out_dtype = node.attrs.get("out_dtype")
    if out_dtype:
        return out_dtype
    return in_dtype


def _same_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    return ins[0]


# ---------------------------------------------------------------------------
# conv2d / dense / bias_add
# ---------------------------------------------------------------------------

@infer_rule("nn.conv2d")
def _conv2d_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt), (wshape, wdt) = ins[0], ins[1]
    n, h, w, cin = dshape
    kh, kw, wcin, cout = wshape
    groups = int(node.attrs.get("groups", 1))
    assert cin == wcin * groups, f"conv2d channel mismatch: {cin} vs {wcin}*{groups}"
    oh, ow = conv2d_out_hw(
        h, w, kh, kw,
        node.attrs.get("strides", (1, 1)),
        node.attrs.get("padding", (0, 0, 0, 0)),
        node.attrs.get("dilation", (1, 1)),
    )
    return (n, oh, ow, cout), _accum_dtype(node, dt.promote(ddt, wdt))


def _im2col(data: np.ndarray, kh, kw, strides, padding, dilation, pad_value=0):
    """NHWC im2col -> (N, OH, OW, KH*KW*C)."""
    n, h, w, c = data.shape
    sh, sw = _pair(strides)
    dh, dw = _pair(dilation)
    pt, pl, pb, pr = _pad4(padding)
    if pt or pl or pb or pr:
        data = np.pad(
            data, ((0, 0), (pt, pb), (pl, pr), (0, 0)), constant_values=pad_value
        )
    oh, ow = conv2d_out_hw(h, w, kh, kw, (sh, sw), (pt, pl, pb, pr), (dh, dw))
    s = data.strides
    windows = np.lib.stride_tricks.as_strided(
        data,
        shape=(n, oh, ow, kh, kw, c),
        strides=(s[0], s[1] * sh, s[2] * sw, s[1] * dh, s[2] * dw, s[3]),
        writeable=False,
    )
    return windows.reshape(n, oh, ow, kh * kw * c), oh, ow


@np_impl("nn.conv2d")
def _conv2d_np(data: np.ndarray, weight: np.ndarray, *, node: Node) -> np.ndarray:
    kh, kw, wcin, cout = weight.shape
    groups = int(node.attrs.get("groups", 1))
    strides = node.attrs.get("strides", (1, 1))
    padding = node.attrs.get("padding", (0, 0, 0, 0))
    dilation = node.attrs.get("dilation", (1, 1))
    out_dtype = node.attrs.get("out_dtype")
    integer = dt.is_int(str(data.dtype))
    acc = np.int64 if integer else np.float32
    cols, oh, ow = _im2col(data.astype(acc), kh, kw, strides, padding, dilation)
    n = data.shape[0]
    cin = data.shape[3]
    if groups == 1:
        out = cols @ weight.reshape(kh * kw * wcin, cout).astype(acc)
    else:
        cpg = cin // groups      # input channels per group
        opg = cout // groups     # output channels per group
        cols_g = cols.reshape(n, oh, ow, kh * kw, cin)
        out = np.empty((n, oh, ow, cout), dtype=acc)
        wflat = weight.astype(acc)
        for g in range(groups):
            patch = cols_g[..., :, g * cpg : (g + 1) * cpg].reshape(n, oh, ow, kh * kw * cpg)
            wg = wflat[:, :, :, g * opg : (g + 1) * opg].reshape(kh * kw * cpg, opg)
            out[..., g * opg : (g + 1) * opg] = patch @ wg
    if out_dtype:
        # Two's-complement truncation: int64 accumulate then cast == int32
        # wraparound accumulation (mod-2^32 arithmetic is associative).
        return out.astype(out_dtype)
    return out.astype(data.dtype if not integer else np.int32)


@infer_rule("nn.dense")
def _dense_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt), (wshape, wdt) = ins[0], ins[1]
    k, nout = wshape
    assert dshape[-1] == k, f"dense reduction mismatch {dshape} x {wshape}"
    return tuple(dshape[:-1]) + (nout,), _accum_dtype(node, dt.promote(ddt, wdt))


@np_impl("nn.dense")
def _dense_np(data: np.ndarray, weight: np.ndarray, *, node: Node) -> np.ndarray:
    integer = dt.is_int(str(data.dtype))
    acc = np.int64 if integer else np.float32
    out = data.astype(acc) @ weight.astype(acc)
    od = node.attrs.get("out_dtype")
    if od:
        return out.astype(od)
    return out.astype(data.dtype if not integer else np.int32)


@infer_rule("nn.bias_add")
def _bias_add_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt), (bshape, bdt) = ins[0], ins[1]
    return tuple(dshape), dt.promote(ddt, bdt)


@np_impl("nn.bias_add")
def _bias_add_np(data: np.ndarray, bias: np.ndarray, *, node: Node) -> np.ndarray:
    axis = int(node.attrs.get("axis", -1))
    shape = [1] * data.ndim
    shape[axis] = -1
    return data + bias.reshape(shape).astype(data.dtype)


@torch_impl("nn.bias_add")
def _bias_add_torch(data: torch.Tensor, bias: torch.Tensor, *, node: Node) -> torch.Tensor:
    axis = int(node.attrs.get("axis", -1))
    shape = [1] * data.ndim
    shape[axis] = -1
    b = bias.reshape(shape).to(data.dtype)
    if data.dtype.is_floating_point:
        return data + b
    # integer adds wrap around in the data's dtype, as the oracle's do
    return (data.to(torch.int64) + b.to(torch.int64)).to(data.dtype)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _pool_geometry(node: Node, h: int, w: int):
    """(kh, kw, sh, sw, (pt, pl, pb, pr), oh, ow); ceil_mode widens the
    bottom/right padding so every window fits."""
    kh, kw = _pair(node.attrs["pool_size"])
    sh, sw = _pair(node.attrs.get("strides", (1, 1)))
    pt, pl, pb, pr = _pad4(node.attrs.get("padding", (0, 0, 0, 0)))
    if node.attrs.get("ceil_mode", False):
        oh = -((h + pt + pb - kh) // -sh) + 1
        ow = -((w + pl + pr - kw) // -sw) + 1
        pb = max(pb, (oh - 1) * sh + kh - h - pt)
        pr = max(pr, (ow - 1) * sw + kw - w - pl)
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    return kh, kw, sh, sw, (pt, pl, pb, pr), oh, ow


@infer_rule("nn.max_pool2d")
def _pool_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt) = ins[0]
    n, h, w, c = dshape
    *_, oh, ow = _pool_geometry(node, h, w)
    return (n, oh, ow, c), ddt


@np_impl("nn.max_pool2d")
def _max_pool2d_np(data: np.ndarray, *, node: Node) -> np.ndarray:
    lo = np.iinfo(data.dtype).min if dt.is_int(str(data.dtype)) else -np.inf
    n, h, w, c = data.shape
    kh, kw, sh, sw, (pt, pl, pb, pr), oh, ow = _pool_geometry(node, h, w)
    padded = np.pad(data, ((0, 0), (pt, pb), (pl, pr), (0, 0)), constant_values=lo)
    s = padded.strides
    win = np.lib.stride_tricks.as_strided(
        padded,
        shape=(n, oh, ow, kh, kw, c),
        strides=(s[0], s[1] * sh, s[2] * sw, s[1], s[2], s[3]),
        writeable=False,
    )
    return win.max(axis=(3, 4))


@torch_impl("nn.max_pool2d")
def _max_pool2d_torch(data: torch.Tensor, *, node: Node) -> torch.Tensor:
    # pad with the dtype minimum (as the oracle does), then a max over
    # strided windows: exact for every dtype on every device (no float
    # round trip, no int8 pooling kernel needed)
    if data.dtype.is_floating_point:
        lo = float("-inf")
    else:
        lo = int(torch.iinfo(data.dtype).min)
    n, h, w, c = data.shape
    kh, kw, sh, sw, (pt, pl, pb, pr), oh, ow = _pool_geometry(node, h, w)
    padded = torch.nn.functional.pad(data, (0, 0, pl, pr, pt, pb), value=lo)
    win = padded.unfold(1, kh, sh).unfold(2, kw, sw)  # (n, oh, ow, c, kh, kw)
    return win.amax(dim=(-2, -1))


def _int_avg(total, count: int):
    """Round-half-away-from-zero integer division (numpy or torch int64)."""
    half = count // 2
    if isinstance(total, torch.Tensor):
        pos = torch.div(total + half, count, rounding_mode="floor")
        neg = -torch.div(-total + half, count, rounding_mode="floor")
        return torch.where(total >= 0, pos, neg)
    return np.where(total >= 0, (total + half) // count, -((-total + half) // count))


@infer_rule("nn.global_avg_pool2d")
def _gap_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt) = ins[0]
    n, h, w, c = dshape
    if node.attrs.get("keepdims", True):
        return (n, 1, 1, c), ddt
    return (n, c), ddt


@np_impl("nn.global_avg_pool2d")
def _gap_np(data: np.ndarray, *, node: Node) -> np.ndarray:
    keepdims = node.attrs.get("keepdims", True)
    integer = dt.is_int(str(data.dtype))
    if integer:
        total = data.astype(np.int64).sum(axis=(1, 2), keepdims=keepdims)
        out = _int_avg(total, data.shape[1] * data.shape[2])
        return out.astype(data.dtype)
    out = data.astype(np.float32).mean(axis=(1, 2), keepdims=keepdims)
    return out.astype(data.dtype)


@torch_impl("nn.global_avg_pool2d")
def _gap_torch(data: torch.Tensor, *, node: Node) -> torch.Tensor:
    keepdims = bool(node.attrs.get("keepdims", True))
    if data.dtype.is_floating_point:
        return data.to(torch.float32).mean(dim=(1, 2), keepdim=keepdims).to(data.dtype)
    total = data.to(torch.int64).sum(dim=(1, 2), keepdim=keepdims)
    return _int_avg(total, data.shape[1] * data.shape[2]).to(data.dtype)


# The JAX package's adaptive pool reads NHWC and takes no layout attr (its
# torch frontend bridges an NCHW pool with transposes around it).
@infer_rule("nn.adaptive_avg_pool2d")
def _aap_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt) = ins[0]
    n, h, w, c = dshape
    oh, ow = _pair(node.attrs["output_size"])
    return (n, oh, ow, c), ddt


def _aap_windows(h: int, w: int, node: Node):
    """((i, j), (h0, h1, w0, w1)) of each output cell, torch's adaptive bins."""
    oh, ow = _pair(node.attrs["output_size"])
    for i in range(oh):
        h0, h1 = (i * h) // oh, -((-(i + 1) * h) // oh)
        for j in range(ow):
            yield (i, j), (h0, h1, (j * w) // ow, -((-(j + 1) * w) // ow))


@np_impl("nn.adaptive_avg_pool2d")
def _aap_np(data: np.ndarray, *, node: Node) -> np.ndarray:
    n, h, w, c = data.shape
    oh, ow = _pair(node.attrs["output_size"])
    integer = dt.is_int(str(data.dtype))
    acc = np.int64 if integer else np.float32
    out = np.empty((n, oh, ow, c), dtype=acc)
    for (i, j), (h0, h1, w0, w1) in _aap_windows(h, w, node):
        tot = data[:, h0:h1, w0:w1, :].astype(acc).sum(axis=(1, 2))
        cnt = (h1 - h0) * (w1 - w0)
        out[:, i, j, :] = _int_avg(tot, cnt) if integer else tot / cnt
    return out.astype(data.dtype)


@torch_impl("nn.adaptive_avg_pool2d")
def _aap_torch(data: torch.Tensor, *, node: Node) -> torch.Tensor:
    n, h, w, c = data.shape
    oh, ow = _pair(node.attrs["output_size"])
    integer = not data.dtype.is_floating_point
    acc = torch.int64 if integer else torch.float32
    out = torch.empty((n, oh, ow, c), dtype=acc, device=data.device)
    for (i, j), (h0, h1, w0, w1) in _aap_windows(h, w, node):
        tot = data[:, h0:h1, w0:w1, :].to(acc).sum(dim=(1, 2))
        cnt = (h1 - h0) * (w1 - w0)
        out[:, i, j, :] = _int_avg(tot, cnt) if integer else tot / cnt
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# normalization (inference-mode), activations, softmax, clip, add
# ---------------------------------------------------------------------------

register_op("nn.batch_norm", infer=_same_rel)


@np_impl("nn.batch_norm")
def _bn_np(data, gamma, beta, mean, var, *, node: Node):
    eps = float(node.attrs.get("epsilon", 1e-5))
    axis = int(node.attrs.get("axis", -1))
    shape = [1] * data.ndim
    shape[axis] = -1
    inv = (1.0 / np.sqrt(var.astype(np.float32) + np.float32(eps))).astype(np.float32)
    out = (data.astype(np.float32) - mean.reshape(shape)) * (gamma * inv).reshape(shape) + beta.reshape(shape)
    return out.astype(data.dtype)


register_op("nn.relu", infer=_same_rel)
register_op("nn.softmax", infer=_same_rel)


@np_impl("nn.relu")
def _relu_np(x, *, node: Node):
    return np.maximum(x, np.zeros((), dtype=x.dtype))


@np_impl("nn.softmax")
def _softmax_np(x, *, node: Node):
    axis = int(node.attrs.get("axis", -1))
    x32 = x.astype(np.float32)
    m = x32.max(axis=axis, keepdims=True)
    e = np.exp(x32 - m)
    return (e / e.sum(axis=axis, keepdims=True)).astype(x.dtype)


@torch_impl("nn.softmax")
def _softmax_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    axis = int(node.attrs.get("axis", -1))
    return torch.softmax(x.to(torch.float32), dim=axis).to(x.dtype)


@infer_rule("clip")
def _clip_rel(node: Node, ins):
    return ins[0]


@np_impl("clip")
def _clip_np(x, *, node: Node):
    a_min, a_max = node.attrs["a_min"], node.attrs["a_max"]
    if dt.is_int(str(x.dtype)):
        return np.clip(x, int(a_min), int(a_max)).astype(x.dtype)
    return np.clip(x, np.float32(a_min), np.float32(a_max)).astype(x.dtype)


@torch_impl("clip")
def _clip_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    a_min, a_max = node.attrs["a_min"], node.attrs["a_max"]
    if x.dtype.is_floating_point:
        lo = float(np.float32(a_min))
        hi = float(np.float32(a_max))
        return x.clamp(lo, hi)
    info = torch.iinfo(x.dtype)
    # bounds outside the dtype range saturate, as np.clip + astype does
    lo = min(max(int(a_min), info.min), info.max)
    hi = min(max(int(a_max), info.min), info.max)
    return x.clamp(lo, hi)


def _broadcast_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, adt), (b, bdt) = ins[0], ins[1]
    return broadcast_shapes(a, b), dt.promote(adt, bdt)


@np_impl("add")
def _add_np(a, b, *, node: Node):
    out_dt = np.dtype(dt.promote(str(a.dtype), str(b.dtype)))
    return np.add(a.astype(out_dt), b.astype(out_dt))


register_op("add", infer=_broadcast_rel)


# ---------------------------------------------------------------------------
# layout: transpose, batch_flatten
# ---------------------------------------------------------------------------

def _perm(node: Node, ndim: int):
    axes = node.attrs.get("axes")
    return tuple(reversed(range(ndim))) if axes is None else tuple(int(a) for a in axes)


@infer_rule("transpose")
def _transpose_rel(node: Node, ins):
    (a, adt) = ins[0]
    return tuple(a[i] for i in _perm(node, len(a))), adt


@np_impl("transpose")
def _transpose_np(a, *, node: Node):
    return np.transpose(a, node.attrs.get("axes"))


@torch_impl("transpose")
def _transpose_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return a.permute(_perm(node, a.ndim))


@infer_rule("nn.batch_flatten")
def _bflat_rel(node: Node, ins):
    (a, adt) = ins[0]
    return (a[0], int(np.prod(a[1:]))), adt


@np_impl("nn.batch_flatten")
def _bflat_np(a, *, node: Node):
    return a.reshape(a.shape[0], -1)


@torch_impl("nn.batch_flatten")
def _bflat_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)
