"""Core float/int op set of int8 ResNet and MobileNetV2, the layout ops of
graphs imported from NCHW frameworks, the float op set of the transformer
zoo (BERT, GPT-2, ViT), the ops the rest of the vision zoo keeps after
quantization (avg_pool2d, batch_norm, relu, sigmoid, exp, split, max, mean,
conv2d_transpose), and the ops of this file that the ONNX importer emits
(elementwise math, maximum / minimum / mod / divide / power, sum / prod /
min / argmax / argmin, squeeze / expand_dims / tile, gather, one_hot,
leaky_relu, prelu, log_softmax, global_max_pool2d, image.resize2d,
depth_to_space, space_to_depth), the bitwise binaries and shifts, and the
TensorFlow importer's rsqrt, floor_divide, all and any (port of
`tachikoma_tpu/ops/nn.py`).

Each op gets the JAX package's shape/dtype relation and numpy oracle, copied;
the ops that the fused graphs run outside the kernels also get a torch
implementation that computes the same values on any device, following
`tachikoma_tpu/ops/jax_ops.py`.

Layouts are the JAX package's: conv2d data NHWC, weight HWIO; dense data
(..., K), weight (K, N).

Float products (nn.dense, nn.batch_matmul, float nn.conv2d,
nn.conv2d_transpose) are torch.matmul and cuDNN calls in float32: each runs
under `float32_products`, which turns TF32 off for cuDNN (torch's default is
on) and for matmuls whatever the caller set, so that a float32 product on
the card is a float32 product and not TF32.  An integer nn.dense (operands
of at most 16 bits) sums exactly through float64, as K1's plain version does.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import (TensorType, flops_rule, get_op, infer_rule, np_impl, register_op,
                           torch_impl)
from ..utils import dtypes as dt
from .fixed_point import torch_dtype


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def float32_products():
    """TF32 off for cuDNN convolutions and matmuls inside, the caller's
    flags restored after (torch's flags are process-wide)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if saved == (False, False):
        yield
        return
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# The device of the graph walk in progress, for the ops that have no tensor
# input to take it from (`full`, `ones`, `zeros`); the torch executor and the
# control-flow ops' subgraph runner set it around each walk.
_RUN_DEVICE: contextvars.ContextVar = contextvars.ContextVar("run_device", default=None)


@contextlib.contextmanager
def walking_on(device):
    """Mark `device` as the device of the graph walk inside."""
    token = _RUN_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _RUN_DEVICE.reset(token)


def walk_device() -> torch.device:
    """The device of the graph walk in progress (the CPU outside one)."""
    dev = _RUN_DEVICE.get()
    return torch.device("cpu") if dev is None else dev


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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_out_dtype(out: torch.Tensor, node: Node, like: torch.Tensor) -> torch.Tensor:
    """`out` in the node's out_dtype, else in the dtype of `like` (the
    float products' rule, as the oracles apply it)."""
    od = node.attrs.get("out_dtype")
    return out.to(torch_dtype(od) if od else like.dtype)


def _float_only(t: torch.Tensor, node: Node) -> None:
    """The float products' torch impls take float tensors only: their integer
    forms are qnn.conv2d / qnn.dense (torch has no integer matmul on CUDA)."""
    if not t.dtype.is_floating_point:
        raise NotImplementedError(
            f"{node.name} ({node.op}): integer {node.op} has no torch impl; "
            "quantized graphs carry the qnn form")


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


def exact_int_acc(a: np.ndarray, b: np.ndarray, k: int):
    """The accumulator dtype of an integer product of `a` and `b` summed over
    `k` terms: float64 when every partial sum is an integer below 2^53 in
    magnitude (then each product and each addition is exact, in any order,
    and BLAS computes it), else int64."""
    def magnitude(v):  # without np.abs, which wraps int8 -128 to itself
        return max(-int(v.min(initial=0)), int(v.max(initial=0)), 1)

    return np.float64 if k * magnitude(a) * magnitude(b) < 2 ** 53 else np.int64


@np_impl("nn.conv2d")
def _conv2d_np(data: np.ndarray, weight: np.ndarray, *, node: Node) -> np.ndarray:
    kh, kw, wcin, cout = weight.shape
    groups = int(node.attrs.get("groups", 1))
    strides = node.attrs.get("strides", (1, 1))
    padding = node.attrs.get("padding", (0, 0, 0, 0))
    dilation = node.attrs.get("dilation", (1, 1))
    out_dtype = node.attrs.get("out_dtype")
    integer = dt.is_int(str(data.dtype))
    acc = exact_int_acc(data, weight, kh * kw * wcin) if integer else np.float32
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
    if integer:
        out = out.astype(np.int64)  # exact integers either way
    if out_dtype:
        # Two's-complement truncation: int64 accumulate then cast == int32
        # wraparound accumulation (mod-2^32 arithmetic is associative).
        return out.astype(out_dtype)
    return out.astype(data.dtype if not integer else np.int32)


@torch_impl("nn.conv2d")
def _conv2d_torch(data: torch.Tensor, weight: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Float conv (ViT's patch embedding): NHWC/HWIO seen as NCHW/OIHW by
    torch.nn.functional.conv2d, asymmetric padding applied first."""
    _float_only(data, node)
    pt, pl, pb, pr = _pad4(node.attrs.get("padding", (0, 0, 0, 0)))
    x = data.to(torch.float32).permute(0, 3, 1, 2)
    if (pt, pl) != (pb, pr):
        x = torch.nn.functional.pad(x, (pl, pr, pt, pb))
        pt, pl = 0, 0
    with float32_products():
        out = torch.nn.functional.conv2d(
            x, weight.to(torch.float32).permute(3, 2, 0, 1),
            stride=_pair(node.attrs.get("strides", (1, 1))), padding=(pt, pl),
            dilation=_pair(node.attrs.get("dilation", (1, 1))),
            groups=int(node.attrs.get("groups", 1)))
    return _to_out_dtype(out.permute(0, 2, 3, 1), node, data)


# conv2d_transpose: the float deconvolutions of the DCGAN generator

@infer_rule("nn.conv2d_transpose")
def _conv2d_t_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt), (wshape, wdt) = ins[0], ins[1]
    n, h, w, cin = dshape
    kh, kw, wcin, cout = wshape
    sh, sw = _pair(node.attrs.get("strides", (1, 1)))
    pt, pl, pb, pr = _pad4(node.attrs.get("padding", (0, 0, 0, 0)))
    oph, opw = _pair(node.attrs.get("output_padding", (0, 0)))
    oh = (h - 1) * sh + kh - pt - pb + oph
    ow = (w - 1) * sw + kw - pl - pr + opw
    return (n, oh, ow, cout), _accum_dtype(node, dt.promote(ddt, wdt))


@np_impl("nn.conv2d_transpose")
def _conv2d_t_np(data: np.ndarray, weight: np.ndarray, *, node: Node) -> np.ndarray:
    n, h, w, cin = data.shape
    kh, kw, wcin, cout = weight.shape
    sh, sw = _pair(node.attrs.get("strides", (1, 1)))
    pt, pl, pb, pr = _pad4(node.attrs.get("padding", (0, 0, 0, 0)))
    oph, opw = _pair(node.attrs.get("output_padding", (0, 0)))
    integer = dt.is_int(str(data.dtype))
    acc = np.int64 if integer else np.float32
    oh = (h - 1) * sh + kh - pt - pb + oph
    ow = (w - 1) * sw + kw - pl - pr + opw
    full = np.zeros((n, oh + pt + pb, ow + pl + pr, cout), dtype=acc)
    d = data.astype(acc)
    wf = weight.astype(acc).reshape(kh * kw, wcin, cout)
    prod = np.einsum("nhwc,kco->nhwko", d, wf)  # (n,h,w,kh*kw,cout)
    prod = prod.reshape(n, h, w, kh, kw, cout)
    for ki in range(kh):
        for kj in range(kw):
            full[:, ki : ki + h * sh : sh, kj : kj + w * sw : sw, :] += prod[:, :, :, ki, kj, :]
    out = full[:, pt : pt + oh, pl : pl + ow, :]
    od = node.attrs.get("out_dtype")
    if od:
        return out.astype(od)
    return out.astype(data.dtype if not integer else np.int32)


@torch_impl("nn.conv2d_transpose")
def _conv2d_t_torch(data: torch.Tensor, weight: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Float deconvolution: torch.nn.functional.conv_transpose2d over the
    NHWC data and the (KH, KW, CIN, COUT) weight seen as NCHW / (CIN, COUT,
    KH, KW), unpadded: the full output ((H - 1) * SH + KH rows), then the
    output padding's zero rows appended and the padding cropped, as the
    oracle's scatter into `full` does.  The JAX package computes it on XLA
    (`jax_ops.py` _conv2d_transpose_core), outside any Pallas kernel."""
    _float_only(data, node)
    n, h, w, cin = data.shape
    kh, kw, wcin, cout = weight.shape
    sh, sw = _pair(node.attrs.get("strides", (1, 1)))
    pt, pl, pb, pr = _pad4(node.attrs.get("padding", (0, 0, 0, 0)))
    oph, opw = _pair(node.attrs.get("output_padding", (0, 0)))
    oh = (h - 1) * sh + kh - pt - pb + oph
    ow = (w - 1) * sw + kw - pl - pr + opw
    with float32_products():
        full = torch.nn.functional.conv_transpose2d(
            data.to(torch.float32).permute(0, 3, 1, 2),
            weight.to(torch.float32).permute(2, 3, 0, 1), stride=(sh, sw))
    full = torch.nn.functional.pad(full, (0, opw, 0, oph))
    out = full[:, :, pt:pt + oh, pl:pl + ow]
    return _to_out_dtype(out.permute(0, 2, 3, 1), node, data)


@flops_rule("nn.conv2d")
def _conv2d_flops(node: Node, ins: Sequence[TensorType]) -> int:
    (wshape, _) = ins[1]
    out_shape, _ = _conv2d_rel(node, ins)
    kh, kw, wcin, cout = wshape
    return 2 * int(np.prod(out_shape)) * kh * kw * wcin


@flops_rule("nn.dense")
def _dense_flops(node: Node, ins: Sequence[TensorType]) -> int:
    (dshape, _), (wshape, _) = ins[0], ins[1]
    return 2 * int(np.prod(dshape)) * wshape[1]


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


# integer operand dtypes whose products a float64 sum holds exactly over any
# reduction of fewer than 2^53 / (max |a| * max |b|) terms
_EXACT_INT_BITS = {torch.int8: 7, torch.uint8: 8, torch.int16: 15}


@torch_impl("nn.dense")
def _dense_torch(data: torch.Tensor, weight: torch.Tensor, *, node: Node) -> torch.Tensor:
    if not data.dtype.is_floating_point:
        # the oracle's int64 sum, exact through float64 where the operands are
        # at most 16 bits wide (torch has no integer matmul on CUDA); then
        # the out_dtype cast, wrapping as numpy's astype does
        bits = (_EXACT_INT_BITS.get(data.dtype), _EXACT_INT_BITS.get(weight.dtype))
        if None in bits or data.shape[-1] >= 1 << (53 - sum(bits)):
            raise NotImplementedError(
                f"{node.name} (nn.dense): an integer product of {data.dtype} x {weight.dtype} "
                f"over K = {data.shape[-1]} has no exact torch impl")
        out = (data.to(torch.float64) @ weight.to(torch.float64)).to(torch.int64)
        return out.to(torch_dtype(node.attrs.get("out_dtype") or "int32"))
    with float32_products():
        out = torch.matmul(data.to(torch.float32), weight.to(torch.float32))
    return _to_out_dtype(out, node, data)


@infer_rule("nn.batch_matmul")
def _bmm_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, adt), (b, bdt) = ins[0], ins[1]
    ta = bool(node.attrs.get("transpose_a", False))
    tb = bool(node.attrs.get("transpose_b", False))
    am, ak = (a[-1], a[-2]) if ta else (a[-2], a[-1])
    bk, bn = (b[-1], b[-2]) if tb else (b[-2], b[-1])
    assert ak == bk, f"batch_matmul K mismatch {a} x {b}"
    batch = broadcast_shapes(a[:-2], b[:-2])
    return batch + (am, bn), _accum_dtype(node, dt.promote(adt, bdt))


@np_impl("nn.batch_matmul")
def _bmm_np(a: np.ndarray, b: np.ndarray, *, node: Node) -> np.ndarray:
    integer = dt.is_int(str(a.dtype))
    acc = np.int64 if integer else np.float32
    x = a.astype(acc)
    y = b.astype(acc)
    if node.attrs.get("transpose_a", False):
        x = np.swapaxes(x, -1, -2)
    if node.attrs.get("transpose_b", False):
        y = np.swapaxes(y, -1, -2)
    out = x @ y
    od = node.attrs.get("out_dtype")
    if od:
        return out.astype(od)
    return out.astype(a.dtype if not integer else np.int32)


@flops_rule("nn.batch_matmul")
def _bmm_flops(node: Node, ins: Sequence[TensorType]) -> int:
    out_shape, _ = _bmm_rel(node, ins)
    a, _ = ins[0]
    k = a[-2] if node.attrs.get("transpose_a", False) else a[-1]
    return 2 * int(np.prod(out_shape)) * k


@torch_impl("nn.batch_matmul")
def _bmm_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    _float_only(a, node)
    x, y = a.to(torch.float32), b.to(torch.float32)
    if node.attrs.get("transpose_a", False):
        x = x.transpose(-1, -2)
    if node.attrs.get("transpose_b", False):
        y = y.transpose(-1, -2)
    with float32_products():
        out = torch.matmul(x, y)
    return _to_out_dtype(out, node, a)


def _alias(name: str, target: str) -> None:
    """Register `name` as another name of `target` (the JAX package's
    `ops/extra.py _alias`), with its torch impl."""
    t = get_op(target)

    def _np(*args, node: Node):
        return get_op(target).np_impl(*args, node=node)

    def _torch(*args, node: Node):
        return get_op(target).torch_impl(*args, node=node)

    register_op(name, infer=t.infer, np_impl=_np, torch_impl=_torch, flops=t.flops)


_alias("nn.matmul", "nn.batch_matmul")


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


def _pool_windows(data, kh, kw, strides, padding, pad_value, ceil_mode):
    n, h, w, c = data.shape
    sh, sw = _pair(strides)
    pt, pl, pb, pr = _pad4(padding)
    if ceil_mode:
        # extend right/bottom padding so every window fits
        oh = -((h + pt + pb - kh) // -sh) + 1
        ow = -((w + pl + pr - kw) // -sw) + 1
        pb = max(pb, (oh - 1) * sh + kh - h - pt)
        pr = max(pr, (ow - 1) * sw + kw - w - pl)
    padded = np.pad(data, ((0, 0), (pt, pb), (pl, pr), (0, 0)), constant_values=pad_value)
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    s = padded.strides
    return np.lib.stride_tricks.as_strided(
        padded,
        shape=(n, oh, ow, kh, kw, c),
        strides=(s[0], s[1] * sh, s[2] * sw, s[1], s[2], s[3]),
        writeable=False,
    )


@infer_rule("nn.max_pool2d")
def _pool_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (dshape, ddt) = ins[0]
    n, h, w, c = dshape
    *_, oh, ow = _pool_geometry(node, h, w)
    return (n, oh, ow, c), ddt


@np_impl("nn.max_pool2d")
def _max_pool2d_np(data: np.ndarray, *, node: Node) -> np.ndarray:
    lo = np.iinfo(data.dtype).min if dt.is_int(str(data.dtype)) else -np.inf
    kh, kw = _pair(node.attrs["pool_size"])
    win = _pool_windows(data, kh, kw, node.attrs.get("strides", (1, 1)),
                        node.attrs.get("padding", (0, 0, 0, 0)), lo,
                        node.attrs.get("ceil_mode", False))
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


register_op("nn.avg_pool2d", infer=_pool_rel)


def _avg_counts_window(node: Node) -> bool:
    """Whether every window divides by kh * kw (count_include_pad, or no
    padding attr); else by the number of its cells inside the image."""
    return bool(node.attrs.get("count_include_pad", False)) or \
        _pad4(node.attrs.get("padding", (0, 0, 0, 0))) == (0, 0, 0, 0)


@np_impl("nn.avg_pool2d")
def _avg_pool2d_np(data: np.ndarray, *, node: Node) -> np.ndarray:
    kh, kw = _pair(node.attrs["pool_size"])
    integer = dt.is_int(str(data.dtype))
    acc = np.int64 if integer else np.float32

    def windows(a):
        return _pool_windows(a, kh, kw, node.attrs.get("strides", (1, 1)),
                             node.attrs.get("padding", (0, 0, 0, 0)), 0,
                             node.attrs.get("ceil_mode", False))

    total = windows(data.astype(acc)).sum(axis=(3, 4))
    if _avg_counts_window(node):
        count = kh * kw
    else:
        ones = np.ones(data.shape[1:3] + (1,), dtype=acc)[None]
        count = windows(np.broadcast_to(ones, data.shape).astype(acc)).sum(axis=(3, 4))
    if integer:
        # round-half-away-from-zero integer average (qnn avg_pool's rule)
        return _int_avg(total, count).astype(data.dtype)
    return (total / count).astype(data.dtype)


@torch_impl("nn.avg_pool2d")
def _avg_pool2d_torch(data: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Window sums over the zero-padded image (int64 for integers), divided
    by kh * kw or by each window's count of image cells, as the oracle."""
    n, h, w, c = data.shape
    kh, kw, sh, sw, (pt, pl, pb, pr), oh, ow = _pool_geometry(node, h, w)
    integer = not data.dtype.is_floating_point
    acc = torch.int64 if integer else torch.float32

    def window_sum(t):
        padded = torch.nn.functional.pad(t, (0, 0, pl, pr, pt, pb))
        return padded.unfold(1, kh, sh).unfold(2, kw, sw).sum(dim=(-2, -1))

    total = window_sum(data.to(acc))
    if _avg_counts_window(node):
        count = kh * kw
    else:
        count = window_sum(torch.ones((1, h, w, 1), dtype=acc, device=data.device))
    if integer:
        return _int_avg(total, count).to(data.dtype)
    return (total / count).to(data.dtype)


def _int_avg(total, count):
    """Round-half-away-from-zero integer division (numpy or torch int64) by
    a positive count, an int or an array of the total's shape."""
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


@torch_impl("nn.batch_norm")
def _bn_torch(data, gamma, beta, mean, var, *, node: Node):
    """The oracle op for op in float32: 1 / sqrt(var + eps), then (x - mean)
    * (gamma * inv) + beta, each a correctly rounded float32 operation on
    either device (no rsqrt, no fused multiply-add, no cuDNN), so the result
    is the oracle's bit for bit: a batch norm that feeds qnn.quantize
    (DenseNet's, the 3D ResNet's) quantizes the same on the card.  The sqrt
    and the division are taken in float64 and rounded once to float32,
    which is their correctly rounded float32 result (torch's CPU float32
    sqrt is an ulp off on some inputs, e.g. 1.0478698)."""
    eps = float(np.float32(node.attrs.get("epsilon", 1e-5)))
    axis = int(node.attrs.get("axis", -1))
    shape = [1] * data.ndim
    shape[axis] = -1
    f32, f64 = torch.float32, torch.float64
    s = torch.sqrt((var.to(f32) + eps).to(f64)).to(f32)
    inv = (1.0 / s.to(f64)).to(f32)
    scale = gamma.to(f32) * inv
    centred = data.to(f32) - mean.to(f32).reshape(shape)
    out = centred * scale.reshape(shape) + beta.to(f32).reshape(shape)
    return out.to(data.dtype)


register_op("nn.relu", infer=_same_rel)
register_op("nn.softmax", infer=_same_rel)


@np_impl("nn.relu")
def _relu_np(x, *, node: Node):
    return np.maximum(x, np.zeros((), dtype=x.dtype))


@torch_impl("nn.relu")
def _relu_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


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


@infer_rule("nn.layer_norm")
def _ln_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    return ins[0]


@np_impl("nn.layer_norm")
def _ln_np(data, gamma, beta, *, node: Node):
    axis = int(node.attrs.get("axis", -1))
    eps = float(node.attrs.get("epsilon", 1e-5))
    x = data.astype(np.float32)
    mu = x.mean(axis=axis, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=axis, keepdims=True)
    shape = [1] * data.ndim
    shape[axis] = -1
    out = (x - mu) / np.sqrt(var + eps) * gamma.reshape(shape) + beta.reshape(shape)
    return out.astype(data.dtype)


@torch_impl("nn.layer_norm")
def _ln_torch(data, gamma, beta, *, node: Node):
    axis = int(node.attrs.get("axis", -1))
    eps = float(np.float32(node.attrs.get("epsilon", 1e-5)))
    x = data.to(torch.float32)
    mu = x.mean(dim=axis, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=axis, keepdim=True)
    shape = [1] * data.ndim
    shape[axis] = -1
    out = (x - mu) / torch.sqrt(var + eps) * gamma.reshape(shape) + beta.reshape(shape)
    return out.to(data.dtype)


register_op("tanh", infer=_same_rel)
register_op("nn.gelu", infer=_same_rel)


@np_impl("tanh")
def _tanh_np(x, *, node: Node):
    return np.tanh(x.astype(np.float32)).astype(x.dtype)


@torch_impl("tanh")
def _tanh_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.tanh(x.to(torch.float32)).to(x.dtype)


register_op("sigmoid", infer=_same_rel)
register_op("exp", infer=_same_rel)


@np_impl("sigmoid")
def _sigmoid_np(x, *, node: Node):
    x32 = x.astype(np.float32)
    return (1.0 / (1.0 + np.exp(-x32))).astype(x.dtype)


@torch_impl("sigmoid")
def _sigmoid_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    # the oracle's formula, not torch.sigmoid: only the exp is not correctly
    # rounded on the card; the add and the division are
    x32 = x.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return (one / (one + torch.exp(-x32))).to(x.dtype)


@np_impl("exp")
def _exp_np(x, *, node: Node):
    return np.exp(x.astype(np.float32)).astype(x.dtype)


@torch_impl("exp")
def _exp_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.exp(x.to(torch.float32)).to(x.dtype)


@np_impl("nn.gelu")
def _gelu_np(x, *, node: Node):
    x32 = x.astype(np.float32)
    if node.attrs.get("approximate", "none") == "tanh":
        c = np.float32(math.sqrt(2.0 / math.pi))
        out = 0.5 * x32 * (1.0 + np.tanh(c * (x32 + 0.044715 * x32**3)))
    else:
        try:
            from scipy.special import erf as _erf  # type: ignore

            out = 0.5 * x32 * (1.0 + _erf(x32 / np.float32(math.sqrt(2.0))))
        except ImportError:
            out = 0.5 * x32 * (1.0 + np.vectorize(math.erf)(x32.astype(np.float64)).astype(np.float32))
    return out.astype(x.dtype)


@torch_impl("nn.gelu")
def _gelu_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's float32 sequence: x / sqrt(2) divided in float32 (by a
    tensor: a CUDA division by a host scalar multiplies by its reciprocal),
    erf in float64 rounded to float32 (scipy's float32 erf), 0.5 x (1 + erf)
    in float32.  torch's own gelu differs from it by up to 2e-5 relative
    near 0 on CUDA, and by an ulp on the CPU, which rounds a quantized
    model's next qnn.quantize the other way."""
    x32 = x.to(torch.float32)
    if node.attrs.get("approximate", "none") == "tanh":
        return torch.nn.functional.gelu(x32, approximate="tanh").to(x.dtype)
    root2 = torch.full((), float(np.float32(math.sqrt(2.0))), dtype=torch.float32,
                       device=x32.device)
    e = torch.erf((x32 / root2).to(torch.float64)).to(torch.float32)
    return (0.5 * x32 * (1.0 + e)).to(x.dtype)


register_op("nn.silu", infer=_same_rel)


@np_impl("nn.silu")
def _silu_np(x, *, node: Node):
    x32 = x.astype(np.float32)
    return (x32 / (1.0 + np.exp(-x32))).astype(x.dtype)


@torch_impl("nn.silu")
def _silu_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    # the oracle's formula, as sigmoid's: torch.exp and numpy's exp differ
    # by an ulp, the add and the division are correctly rounded
    x32 = x.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return (x32 / (one + torch.exp(-x32))).to(x.dtype)


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


# the elementwise binaries of the JAX package's _BINOPS table that the
# port's graphs hold; numpy's and torch's integer add/subtract/multiply wrap
_BINOPS = {
    "add": (np.add, torch.add),
    "subtract": (np.subtract, torch.sub),
    "multiply": (np.multiply, torch.mul),
}

for _n, (_f, _tf) in _BINOPS.items():
    def _mkb(f, tf):
        def np_fn(a, b, *, node: Node):
            out_dt = np.dtype(dt.promote(str(a.dtype), str(b.dtype)))
            return f(a.astype(out_dt), b.astype(out_dt))

        def torch_fn(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
            out_dt = torch_dtype(dt.promote(_dtype_name(a), _dtype_name(b)))
            return tf(a.to(out_dt), b.to(out_dt))
        return np_fn, torch_fn
    _np_fn, _torch_fn = _mkb(_f, _tf)
    register_op(_n, infer=_broadcast_rel, np_impl=_np_fn, torch_impl=_torch_fn)


# comparisons, logical ops and where: the decode step's position mask
# (models/decoding.py) is `where(less_equal(arange, pos), 0, -30)`

def _cmp_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _), (b, _) = ins[0], ins[1]
    return broadcast_shapes(a, b), "bool"


_CMPOPS = {
    "equal": (np.equal, torch.eq), "not_equal": (np.not_equal, torch.ne),
    "less": (np.less, torch.lt), "less_equal": (np.less_equal, torch.le),
    "greater": (np.greater, torch.gt), "greater_equal": (np.greater_equal, torch.ge),
    "logical_and": (np.logical_and, torch.logical_and),
    "logical_or": (np.logical_or, torch.logical_or),
}

for _n, (_f, _tf) in _CMPOPS.items():
    def _mkc(f, tf):
        def np_fn(a, b, *, node: Node):
            return f(a, b)

        def torch_fn(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
            return tf(a, b)
        return np_fn, torch_fn
    _np_fn, _torch_fn = _mkc(_f, _tf)
    register_op(_n, infer=_cmp_rel, np_impl=_np_fn, torch_impl=_torch_fn)


@infer_rule("logical_not")
def _lnot_rel(node: Node, ins):
    (a, _) = ins[0]
    return a, "bool"


@np_impl("logical_not")
def _lnot_np(a, *, node: Node):
    return np.logical_not(a)


@torch_impl("logical_not")
def _lnot_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.logical_not(a)


@infer_rule("where")
def _where_rel(node: Node, ins):
    (c, _), (a, adt), (b, bdt) = ins
    return broadcast_shapes(broadcast_shapes(c, a), b), dt.promote(adt, bdt)


@np_impl("where")
def _where_np(c, a, b, *, node: Node):
    return np.where(c, a, b)


@torch_impl("where")
def _where_torch(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The branches in the relation's dtype (`dt.promote`, numpy's rule: an
    int32 branch with a float32 one gives float64, as the oracle does); a
    nonzero condition selects `a`, as numpy's truth value does."""
    out_dt = torch_dtype(dt.promote(_dtype_name(a), _dtype_name(b)))
    return torch.where(c.to(torch.bool), a.to(out_dt), b.to(out_dt))


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


# ---------------------------------------------------------------------------
# shape ops of the transformer graphs: reshape, concatenate, strided_slice,
# take, broadcast_to
# ---------------------------------------------------------------------------

@infer_rule("reshape")
def _reshape_rel(node: Node, ins):
    (a, adt) = ins[0]
    newshape = list(node.attrs["newshape"])
    total = int(np.prod(a))
    if -1 in newshape:
        known = int(np.prod([s for s in newshape if s != -1]))
        newshape[newshape.index(-1)] = total // max(known, 1)
    assert int(np.prod(newshape)) == total, f"reshape {a} -> {newshape}"
    return tuple(int(s) for s in newshape), adt


@np_impl("reshape")
def _reshape_np(a, *, node: Node):
    newshape = tuple(int(s) for s in node.attrs["newshape"])
    return a.reshape(newshape)


@torch_impl("reshape")
def _reshape_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    shape, _ = _reshape_rel(node, [(tuple(a.shape), _dtype_name(a))])
    return a.reshape(shape)


@infer_rule("concatenate")
def _concat_rel(node: Node, ins):
    axis = int(node.attrs.get("axis", 0))
    shapes = [s for s, _ in ins]
    axis = axis % len(shapes[0])
    out = list(shapes[0])
    out[axis] = sum(s[axis] for s in shapes)
    dtype = ins[0][1]
    for _, d in ins[1:]:
        dtype = dt.promote(dtype, d)
    return tuple(out), dtype


@np_impl("concatenate")
def _concat_np(*args, node: Node):
    return np.concatenate(args, axis=int(node.attrs.get("axis", 0)))


@torch_impl("concatenate")
def _concat_torch(*args: torch.Tensor, node: Node) -> torch.Tensor:
    dtype = _dtype_name(args[0])
    for a in args[1:]:
        dtype = dt.promote(dtype, _dtype_name(a))
    return torch.cat([a.to(torch_dtype(dtype)) for a in args], dim=int(node.attrs.get("axis", 0)))


@infer_rule("split")
def _split_rel(node: Node, ins):
    (a, adt) = ins[0]
    axis = int(node.attrs.get("axis", 0)) % len(a)
    iops = node.attrs["indices_or_sections"]
    if isinstance(iops, int):
        assert a[axis] % iops == 0
        sec = a[axis] // iops
        sizes = [sec] * iops
    else:
        pts = [0] + list(iops) + [a[axis]]
        sizes = [pts[i + 1] - pts[i] for i in range(len(pts) - 1)]
    out = []
    for s in sizes:
        sh = list(a)
        sh[axis] = s
        out.append((tuple(sh), adt))
    return out


@np_impl("split")
def _split_np(a, *, node: Node):
    axis = int(node.attrs.get("axis", 0))
    iops = node.attrs["indices_or_sections"]
    if not isinstance(iops, int):
        iops = list(iops)
    return list(np.split(a, iops, axis=axis))


@torch_impl("split")
def _split_torch(a: torch.Tensor, *, node: Node) -> list[torch.Tensor]:
    """A list of views, as the oracle's np.split: equal sections (the
    relation asserts they divide the axis) or the pieces between indices."""
    axis = int(node.attrs.get("axis", 0))
    iops = node.attrs["indices_or_sections"]
    if not isinstance(iops, int):
        iops = [int(i) for i in iops]
    return list(torch.tensor_split(a, iops, dim=axis))


def _slices(node: Node, ndim: int) -> list[slice]:
    """The python slice of each axis of a strided_slice."""
    begin = list(node.attrs["begin"])
    end = list(node.attrs["end"])
    strides = list(node.attrs.get("strides") or [1] * len(begin))
    axes = node.attrs.get("axes")
    idx = [slice(None)] * ndim
    idx_axes = axes if axes is not None else range(len(begin))
    for k, ax in enumerate(idx_axes):
        e = end[k]
        idx[ax] = slice(begin[k], None if e is None else e, strides[k])
    return idx


@infer_rule("strided_slice")
def _sslice_rel(node: Node, ins):
    (a, adt) = ins[0]
    begin = list(node.attrs["begin"])
    end = list(node.attrs["end"])
    strides = list(node.attrs.get("strides") or [1] * len(begin))
    axes = node.attrs.get("axes")
    out = list(a)
    idx_axes = axes if axes is not None else range(len(begin))
    for k, ax in enumerate(idx_axes):
        b, e, s = begin[k], end[k], strides[k]
        dim = a[ax]
        out[ax] = len(range(*slice(b, e, s).indices(dim)))
    return tuple(out), adt


@np_impl("strided_slice")
def _sslice_np(a, *, node: Node):
    return a[tuple(_slices(node, a.ndim))]


@torch_impl("strided_slice")
def _sslice_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    # torch slices take positive steps only: a negative step gathers the
    # indices numpy's slice would visit
    for ax, s in enumerate(_slices(node, a.ndim)):
        if s.step is not None and s.step < 0:
            keep = torch.arange(*s.indices(a.shape[ax]), device=a.device)
            a = a.index_select(ax, keep)
        else:
            a = a[(slice(None),) * ax + (s,)]
    return a


@infer_rule("take")
def _take_rel(node: Node, ins):
    (a, adt), (i, _) = ins[0], ins[1]
    axis = node.attrs.get("axis")
    if axis is None:
        return tuple(i), adt
    axis = int(axis) % len(a)
    return tuple(a[:axis]) + tuple(i) + tuple(a[axis + 1 :]), adt


@np_impl("take")
def _take_np(a, indices, *, node: Node):
    axis = node.attrs.get("axis")
    mode = node.attrs.get("mode", "clip")
    if mode == "clip":
        hi = (a.size if axis is None else a.shape[int(axis)]) - 1
        indices = np.clip(indices, 0, hi)
    elif mode == "wrap":
        n = a.size if axis is None else a.shape[int(axis)]
        indices = indices % n
    return np.take(a, indices, axis=None if axis is None else int(axis))


@torch_impl("take")
def _take_torch(a: torch.Tensor, indices: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Row gather; ids are clamped (clip, the default) or wrapped before the
    gather, as the oracle does: on CUDA an id out of range would assert on
    the device.  The JAX package's one-hot matmul for embeddings is a TPU
    tactic and is not ported."""
    axis = node.attrs.get("axis")
    mode = node.attrs.get("mode", "clip")
    src = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else int(axis) % a.ndim
    n = src.shape[ax]
    idx = indices.to(torch.int64)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx.remainder(n)
    out = src.index_select(ax, idx.reshape(-1))
    return out.reshape(src.shape[:ax] + indices.shape + src.shape[ax + 1:])


@infer_rule("nn.pad")
def _pad_rel(node: Node, ins):
    (a, adt) = ins[0]
    pw = node.attrs["pad_width"]
    return tuple(int(s + b + e) for s, (b, e) in zip(a, pw)), adt


@np_impl("nn.pad")
def _pad_np(a, *, node: Node):
    pw = [(int(b), int(e)) for b, e in node.attrs["pad_width"]]
    mode = node.attrs.get("pad_mode", "constant")
    if mode == "constant":
        val = node.attrs.get("pad_value", 0)
        if dt.is_int(str(a.dtype)):
            val = int(val)
        return np.pad(a, pw, constant_values=val)
    return np.pad(a, pw, mode={"edge": "edge", "reflect": "reflect"}[mode])


@torch_impl("nn.pad")
def _pad_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """A constant pad through torch's (widths last axis first, the value cast
    as the oracle casts it); "edge" and "reflect" gather each padded axis at
    the indices numpy's pad of an arange gives."""
    pw = [(int(b), int(e)) for b, e in node.attrs["pad_width"]]
    mode = node.attrs.get("pad_mode", "constant")
    if mode == "constant":
        val = node.attrs.get("pad_value", 0)
        val = int(val) if not a.dtype.is_floating_point else float(np.float32(val))
        flat = [v for b, e in reversed(pw) for v in (b, e)]
        return torch.nn.functional.pad(a, flat, mode="constant", value=val)
    np_mode = {"edge": "edge", "reflect": "reflect"}[mode]
    for ax, (b, e) in enumerate(pw):
        if b or e:
            idx = np.pad(np.arange(a.shape[ax]), (b, e), mode=np_mode)
            a = a.index_select(ax, torch.as_tensor(idx, device=a.device))
    return a


@infer_rule("cast")
def _cast_rel(node: Node, ins):
    (a, _) = ins[0]
    return tuple(a), node.attrs["dtype"]


@np_impl("cast")
def _cast_np(a, *, node: Node):
    # C-style truncation cast for float->int (TVM semantics)
    target = node.attrs["dtype"]
    if dt.is_float(str(a.dtype)) and dt.is_int(target):
        return np.trunc(a).astype(target)
    return a.astype(target)


@torch_impl("cast")
def _cast_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's cast: float -> int truncates toward zero, an integer
    narrowing wraps around, as numpy's astype does."""
    target = torch_dtype(node.attrs["dtype"])
    if a.dtype.is_floating_point and not target.is_floating_point:
        return torch.trunc(a).to(target)
    return a.to(target)


@infer_rule("broadcast_to")
def _bto_rel(node: Node, ins):
    (a, adt) = ins[0]
    return tuple(int(s) for s in node.attrs["shape"]), adt


@np_impl("broadcast_to")
def _bto_np(a, *, node: Node):
    return np.broadcast_to(a, tuple(int(s) for s in node.attrs["shape"])).copy()


@torch_impl("broadcast_to")
def _bto_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return a.expand(tuple(int(s) for s in node.attrs["shape"])).contiguous()


# ---------------------------------------------------------------------------
# reductions: the SSD head's best-class score (max) and the 3D ResNet's
# spatio-temporal pool (mean)
# ---------------------------------------------------------------------------

def _reduce_rel(node: Node, ins):
    (a, adt) = ins[0]
    axes = node.attrs.get("axis")
    keepdims = node.attrs.get("keepdims", False)
    if axes is None:
        axes = tuple(range(len(a)))
    elif not isinstance(axes, (tuple, list)):
        axes = (axes,)
    axes = tuple(ax % len(a) for ax in axes)
    if keepdims:
        shape = tuple(1 if i in axes else s for i, s in enumerate(a))
    else:
        shape = tuple(s for i, s in enumerate(a) if i not in axes)
    return shape, adt


def _norm_axes(node: Node, ndim: int):
    axes = node.attrs.get("axis")
    if axes is None:
        return None
    if not isinstance(axes, (tuple, list)):
        axes = (axes,)
    return tuple(ax % ndim for ax in axes)


@np_impl("max")
def _max_np(a, *, node: Node):
    out = np.max(a, axis=_norm_axes(node, a.ndim), keepdims=bool(node.attrs.get("keepdims", False)))
    return np.asarray(out, dtype=a.dtype)


@torch_impl("max")
def _max_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    axes = _norm_axes(node, a.ndim)
    return torch.amax(a, dim=axes if axes is not None else tuple(range(a.ndim)),
                      keepdim=bool(node.attrs.get("keepdims", False)))


@np_impl("mean")
def _mean_np(a, *, node: Node):
    axes = _norm_axes(node, a.ndim)
    keepdims = bool(node.attrs.get("keepdims", False))
    if not dt.is_float(str(a.dtype)):
        return np.mean(a.astype(np.float64), axis=axes, keepdims=keepdims).astype(a.dtype)
    return np.asarray(np.mean(a.astype(np.float32), axis=axes, keepdims=keepdims), dtype=a.dtype)


@torch_impl("mean")
def _mean_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Float: a float32 mean (its sum order is torch's, not numpy's pairwise
    one).  Integer: the oracle's float64 mean truncated toward zero, computed
    exactly as the int64 sum over the count in float64 (the sum of int32 or
    narrower values stays below 2^53, so every order gives it)."""
    axes = _norm_axes(node, a.ndim)
    dims = axes if axes is not None else tuple(range(a.ndim))
    keepdims = bool(node.attrs.get("keepdims", False))
    if a.dtype.is_floating_point:
        return a.to(torch.float32).mean(dim=dims, keepdim=keepdims).to(a.dtype)
    count = int(np.prod([a.shape[d] for d in dims]))
    total = a.to(torch.int64).sum(dim=dims, keepdim=keepdims).to(torch.float64)
    return torch.trunc(total / count).to(a.dtype)


register_op("max", infer=_reduce_rel)
register_op("mean", infer=_reduce_rel)


# ---------------------------------------------------------------------------
# the ONNX importer's ops (frontend/onnx.py): elementwise math, binaries,
# reductions, shape and index ops, resize, depth/space moves.  Each torch
# impl computes the oracle's values: a float32 cast where the oracle casts,
# numpy's promotion, numpy's rules at a zero divisor and for negative and
# out-of-range indices (an index out of range raises, as numpy's does,
# instead of reaching a device-side assert).
# ---------------------------------------------------------------------------

for _name in ("nn.log_softmax", "erf", "log", "sqrt", "negative", "abs", "round", "floor", "ceil",
              "sign"):
    register_op(_name, infer=_same_rel)


def _int_exact(np_fn):
    # the oracle keeps integer negative / abs / sign in the input's dtype
    return np_fn in (np.negative, np.abs, np.sign)


def _torch_sign(x: torch.Tensor) -> torch.Tensor:
    """np.sign: NaN stays NaN (torch.sign gives 0 there)."""
    s = torch.sign(x)
    return torch.where(torch.isnan(x), x, s) if x.dtype.is_floating_point else s


for _n, (_f, _tf) in {
    "log": (np.log, torch.log), "sqrt": (np.sqrt, torch.sqrt),
    "negative": (np.negative, torch.neg), "abs": (np.abs, torch.abs),
    "floor": (np.floor, torch.floor), "ceil": (np.ceil, torch.ceil),
    "sign": (np.sign, _torch_sign),
}.items():
    def _mku(f, tf):
        def np_fn(x, *, node: Node):
            if dt.is_int(str(x.dtype)) and _int_exact(f):
                return f(x)
            return f(x.astype(np.float32)).astype(x.dtype)

        def torch_fn(x: torch.Tensor, *, node: Node) -> torch.Tensor:
            if _int_exact(f) and not x.dtype.is_floating_point and x.dtype != torch.bool:
                return tf(x)
            return tf(x.to(torch.float32)).to(x.dtype)
        return np_fn, torch_fn
    _np_fn, _torch_fn = _mku(_f, _tf)
    register_op(_n, np_impl=_np_fn, torch_impl=_torch_fn)


@np_impl("round")
def _round_np(x, *, node: Node):
    # TVM `round` lowers to nearbyint (ties-to-even) == np.rint
    return np.rint(x.astype(np.float32)).astype(x.dtype)


@torch_impl("round")
def _round_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.round(x.to(torch.float32)).to(x.dtype)  # ties to even, as np.rint


@np_impl("erf")
def _erf_np(x, *, node: Node):
    try:
        from scipy.special import erf as _serf  # type: ignore

        return _serf(x.astype(np.float32)).astype(x.dtype)
    except ImportError:
        out = np.vectorize(math.erf)(x.astype(np.float64))
        return out.astype(x.dtype)


@torch_impl("erf")
def _erf_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.erf(x.to(torch.float32)).to(x.dtype)


@np_impl("nn.log_softmax")
def _log_softmax_np(x, *, node: Node):
    axis = int(node.attrs.get("axis", -1))
    x32 = x.astype(np.float32)
    m = x32.max(axis=axis, keepdims=True)
    s = np.log(np.exp(x32 - m).sum(axis=axis, keepdims=True))
    return (x32 - m - s).astype(x.dtype)


@torch_impl("nn.log_softmax")
def _log_softmax_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's sequence in float32: the max, the log of the summed
    exponentials, (x - m) - s."""
    axis = int(node.attrs.get("axis", -1))
    x32 = x.to(torch.float32)
    m = x32.amax(dim=axis, keepdim=True)
    s = torch.log(torch.exp(x32 - m).sum(dim=axis, keepdim=True))
    return (x32 - m - s).to(x.dtype)


@infer_rule("nn.leaky_relu")
def _lrelu_rel(node: Node, ins):
    return ins[0]


@np_impl("nn.leaky_relu")
def _lrelu_np(x, *, node: Node):
    alpha = np.float32(node.attrs.get("alpha", 0.01))
    return np.where(x >= 0, x, (x.astype(np.float32) * alpha).astype(x.dtype))


@torch_impl("nn.leaky_relu")
def _lrelu_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    alpha = torch.tensor(np.float32(node.attrs.get("alpha", 0.01)), device=x.device)
    return torch.where(x >= 0, x, (x.to(torch.float32) * alpha).to(x.dtype))


@infer_rule("nn.prelu")
def _prelu_rel(node: Node, ins):
    return ins[0]


@np_impl("nn.prelu")
def _prelu_np(x, alpha, *, node: Node):
    axis = int(node.attrs.get("axis", -1))
    shape = [1] * x.ndim
    shape[axis] = -1
    return np.where(x >= 0, x, x * alpha.reshape(shape)).astype(x.dtype)


@torch_impl("nn.prelu")
def _prelu_torch(x: torch.Tensor, alpha: torch.Tensor, *, node: Node) -> torch.Tensor:
    axis = int(node.attrs.get("axis", -1))
    shape = [1] * x.ndim
    shape[axis] = -1
    p = torch_dtype(dt.promote(_dtype_name(x), _dtype_name(alpha)))
    xp = x.to(p)
    return torch.where(x >= 0, xp, xp * alpha.reshape(shape).to(p)).to(x.dtype)


# binaries: maximum and minimum (NaN propagates in both), numpy's floor mod,
# C division on integers, power

for _n, (_f, _tf) in {"maximum": (np.maximum, torch.maximum),
                      "minimum": (np.minimum, torch.minimum)}.items():
    _np_fn, _torch_fn = _mkb(_f, _tf)
    register_op(_n, infer=_broadcast_rel, np_impl=_np_fn, torch_impl=_torch_fn)


# the bitwise binaries and shifts of the JAX package's _BINOPS table (an
# integer graph's `right_shift` by a constant, tests/test_placement.py); a
# shift by the width or more, or by a negative count, gives 0 (or -1 for a
# negative value shifted right) in both numpy and torch
for _n, (_f, _tf) in {"bitwise_and": (np.bitwise_and, torch.bitwise_and),
                      "bitwise_or": (np.bitwise_or, torch.bitwise_or),
                      "bitwise_xor": (np.bitwise_xor, torch.bitwise_xor),
                      "left_shift": (np.left_shift, torch.bitwise_left_shift),
                      "right_shift": (np.right_shift, torch.bitwise_right_shift)}.items():
    _np_fn, _torch_fn = _mkb(_f, _tf)
    register_op(_n, infer=_broadcast_rel, np_impl=_np_fn, torch_impl=_torch_fn)


def _promoted(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    out_dt = torch_dtype(dt.promote(_dtype_name(a), _dtype_name(b)))
    return a.to(out_dt), b.to(out_dt)


def _nonzero_divisor(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(b == 0, b with its zeros made 1): an integer division by zero gives
    0 in numpy (with a warning), raises in torch on the CPU and is undefined
    on CUDA."""
    zero = b == 0
    return zero, torch.where(zero, torch.ones_like(b), b)


@np_impl("mod")
def _mod_np(a, b, *, node: Node):
    out_dt = np.dtype(dt.promote(str(a.dtype), str(b.dtype)))
    return np.mod(a.astype(out_dt), b.astype(out_dt))


@torch_impl("mod")
def _mod_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """np.mod, a floor mod: the sign of the divisor.  Integers: 0 at a zero
    divisor.  Floats: NaN at a zero divisor (as torch gives), and a zero
    result carries the divisor's sign, as numpy's does (torch's carries the
    dividend's)."""
    a, b = _promoted(a, b)
    if not a.dtype.is_floating_point:
        zero, b1 = _nonzero_divisor(b)
        return torch.where(zero, torch.zeros_like(a), torch.remainder(a, b1))
    r = torch.remainder(a, b)
    return torch.where(r == 0, torch.copysign(torch.zeros_like(r), b), r)


register_op("mod", infer=_broadcast_rel)


@infer_rule("divide")
def _div_rel(node: Node, ins):
    return _broadcast_rel(node, ins)


@np_impl("divide")
def _div_np(a, b, *, node: Node):
    out_dt = np.dtype(dt.promote(str(a.dtype), str(b.dtype)))
    if dt.is_int(str(out_dt)):
        # TVM integer divide truncates toward zero (C semantics)
        q = a.astype(np.int64) // b.astype(np.int64)
        r = a.astype(np.int64) % b.astype(np.int64)
        q = np.where((r != 0) & ((a < 0) != (b < 0)), q + 1, q)
        return q.astype(out_dt)
    return (a.astype(out_dt) / b.astype(out_dt))


@torch_impl("divide")
def _div_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Integers: the quotient truncated toward zero, computed in int64 and
    wrapped into the promoted dtype as the oracle's astype does; 0 at a
    zero divisor, the oracle's value there.  Floats: IEEE division."""
    out_dt = torch_dtype(dt.promote(_dtype_name(a), _dtype_name(b)))
    if out_dt.is_floating_point:
        return a.to(out_dt) / b.to(out_dt)
    zero, b1 = _nonzero_divisor(b.to(torch.int64))
    q = torch.div(a.to(torch.int64), b1, rounding_mode="trunc")
    return torch.where(zero, torch.zeros_like(q), q).to(out_dt)


@infer_rule("power")
def _pow_rel(node: Node, ins):
    return _broadcast_rel(node, ins)


@np_impl("power")
def _pow_np(a, b, *, node: Node):
    out_dt = np.dtype(dt.promote(str(a.dtype), str(b.dtype)))
    return np.power(a.astype(out_dt), b.astype(out_dt))


@torch_impl("power")
def _pow_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """np.power in the promoted dtype; an integer power wraps as numpy's.
    A negative integer exponent raises, as numpy's does (torch would give 0
    or 1); checking it reads one flag on the host."""
    a, b = _promoted(a, b)
    if not a.dtype.is_floating_point and a.dtype != torch.bool and bool((b < 0).any()):
        raise ValueError(f"{node.name}: integers to negative integer powers are not allowed")
    return torch.pow(a, b)


# reductions: sum, prod, min, argmax, argmin

def _reduce_dims(node: Node, ndim: int) -> tuple[int, ...]:
    axes = _norm_axes(node, ndim)
    return tuple(range(ndim)) if axes is None else axes


def _narrow_int(dtype: str) -> bool:
    return dtype in ("int8", "uint8", "int16", "int32")


@infer_rule("sum")
def _sum_rel(node: Node, ins):
    shape, adt = _reduce_rel(node, ins)
    if str(adt) in ("int8", "uint8", "int16", "int32"):
        return shape, "int32"
    return shape, adt


register_op("prod", infer=_reduce_rel)
register_op("min", infer=_reduce_rel)

for _n, _f in {"sum": np.sum, "min": np.min, "prod": np.prod}.items():
    def _mkr(f, name):
        def impl(a, *, node: Node):
            axes = _norm_axes(node, a.ndim)
            keepdims = bool(node.attrs.get("keepdims", False))
            if name in ("sum", "prod") and dt.is_int(str(a.dtype)):
                return f(a.astype(np.int64), axis=axes, keepdims=keepdims).astype(
                    "int32" if str(a.dtype) in ("int8", "uint8", "int16", "int32") else a.dtype
                )
            out = f(a, axis=axes, keepdims=keepdims)
            return np.asarray(out, dtype=a.dtype)
        return impl
    register_op(_n, np_impl=_mkr(_f, _n))


def _prod_dims(a: torch.Tensor, dims: tuple[int, ...], keepdim: bool) -> torch.Tensor:
    # torch.prod reduces one dim a call: the highest first keeps the others'
    # indices
    for d in sorted(dims, reverse=True):
        a = a.prod(dim=d, keepdim=keepdim)
    return a


def _int_reduce_out(a: torch.Tensor) -> torch.dtype:
    return torch.int32 if _narrow_int(_dtype_name(a)) else a.dtype


@torch_impl("sum")
def _sum_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Integers: the int64 sum (exact modulo 2^64 in every order) in int32
    for int32 and narrower inputs, wrapping as the oracle's astype does.
    Floats: torch's sum order, not numpy's pairwise one."""
    dims = _reduce_dims(node, a.ndim)
    integer = not a.dtype.is_floating_point and a.dtype != torch.bool
    x = a.to(torch.int64) if integer else a
    if dims:
        x = x.sum(dim=dims, keepdim=bool(node.attrs.get("keepdims", False)))
    return x.to(_int_reduce_out(a) if integer else a.dtype)


@torch_impl("prod")
def _prod_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """As `sum`: an int64 product (exact modulo 2^64 in every order) in the
    oracle's dtype; floats in torch's order."""
    dims = _reduce_dims(node, a.ndim)
    integer = not a.dtype.is_floating_point and a.dtype != torch.bool
    x = _prod_dims(a.to(torch.int64) if integer else a, dims,
                   bool(node.attrs.get("keepdims", False)))
    return x.to(_int_reduce_out(a) if integer else a.dtype)


@torch_impl("min")
def _min_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    dims = _reduce_dims(node, a.ndim)
    return torch.amin(a, dim=dims, keepdim=bool(node.attrs.get("keepdims", False))) if dims else a


def _arg_rel(node: Node, ins):
    shape, _ = _reduce_rel(node, ins)
    return shape, "int32"


for _n, (_f, _tf) in {"argmax": (np.argmax, torch.argmax),
                      "argmin": (np.argmin, torch.argmin)}.items():
    def _mka(f, tf):
        def np_fn(a, *, node: Node):
            axes = _norm_axes(node, a.ndim)
            ax = axes[0] if axes else None
            out = f(a, axis=ax)
            if node.attrs.get("keepdims", False) and ax is not None:
                out = np.expand_dims(out, ax)
            return out.astype(np.int32)

        def torch_fn(a: torch.Tensor, *, node: Node) -> torch.Tensor:
            # the first index of the extreme, NaN counted the extreme, as numpy
            axes = _norm_axes(node, a.ndim)
            ax = axes[0] if axes else None
            out = tf(a, dim=ax)
            if node.attrs.get("keepdims", False) and ax is not None:
                out = out.unsqueeze(ax)
            return out.to(torch.int32)
        return np_fn, torch_fn
    _np_fn, _torch_fn = _mka(_f, _tf)
    register_op(_n, infer=_arg_rel, np_impl=_np_fn, torch_impl=_torch_fn)


# shape ops: squeeze, expand_dims, tile

@infer_rule("squeeze")
def _squeeze_rel(node: Node, ins):
    (a, adt) = ins[0]
    axes = node.attrs.get("axis")
    if axes is None:
        return tuple(s for s in a if s != 1), adt
    axes = [ax % len(a) for ax in (axes if isinstance(axes, (tuple, list)) else [axes])]
    return tuple(s for i, s in enumerate(a) if i not in axes), adt


@np_impl("squeeze")
def _squeeze_np(a, *, node: Node):
    axes = node.attrs.get("axis")
    if axes is not None and not isinstance(axes, (tuple, list)):
        axes = (axes,)
    return np.squeeze(a, axis=tuple(axes) if axes is not None else None)


@torch_impl("squeeze")
def _squeeze_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """np.squeeze: an axis named that is not of size 1 raises, as numpy's
    does (torch's squeeze would leave it)."""
    axes = node.attrs.get("axis")
    if axes is not None:
        for ax in (axes if isinstance(axes, (tuple, list)) else [axes]):
            if a.shape[int(ax) % a.ndim] != 1:
                raise ValueError(f"{node.name}: cannot squeeze axis {ax} of size "
                                 f"{a.shape[int(ax) % a.ndim]}")
    shape, _ = _squeeze_rel(node, [(tuple(a.shape), _dtype_name(a))])
    return a.reshape(shape)


@infer_rule("expand_dims")
def _expand_rel(node: Node, ins):
    (a, adt) = ins[0]
    axis = int(node.attrs["axis"])
    num = int(node.attrs.get("num_newaxis", 1))
    axis = axis % (len(a) + 1)
    return tuple(a[:axis]) + (1,) * num + tuple(a[axis:]), adt


@np_impl("expand_dims")
def _expand_np(a, *, node: Node):
    axis = int(node.attrs["axis"]) % (a.ndim + 1)
    num = int(node.attrs.get("num_newaxis", 1))
    shape = a.shape[:axis] + (1,) * num + a.shape[axis:]
    return a.reshape(shape)


@torch_impl("expand_dims")
def _expand_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    shape, _ = _expand_rel(node, [(tuple(a.shape), _dtype_name(a))])
    return a.reshape(shape)


@infer_rule("tile")
def _tile_rel(node: Node, ins):
    (a, adt) = ins[0]
    reps = tuple(int(r) for r in node.attrs["reps"])
    return tuple(int(s) for s in np.tile(np.empty(a, dtype=np.bool_), reps).shape), adt


@np_impl("tile")
def _tile_np(a, *, node: Node):
    return np.tile(a, tuple(int(r) for r in node.attrs["reps"]))


@torch_impl("tile")
def _tile_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return a.tile(tuple(int(r) for r in node.attrs["reps"]))  # np.tile's rule for short reps


# index ops: gather (take_along_axis), one_hot

def index_in_range(idx: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """`idx` (int64) with negative entries counted from the end, as numpy's
    indexing counts them; an entry outside [-n, n) raises IndexError, as
    numpy's does, instead of reaching a device-side assert.  The check reads
    one flag on the host."""
    if idx.numel() and bool(((idx < -n) | (idx >= n)).any()):
        raise IndexError(f"{what}: index out of range for an axis of size {n}")
    return torch.where(idx < 0, idx + n, idx)


@infer_rule("gather")
def _gather_rel(node: Node, ins):
    (_, adt), (i, _) = ins[0], ins[1]
    return tuple(i), adt


@np_impl("gather")
def _gather_np(a, indices, *, node: Node):
    axis = int(node.attrs.get("axis", 0))
    return np.take_along_axis(a, indices.astype(np.int64), axis=axis)


@torch_impl("gather")
def _gather_torch(a: torch.Tensor, indices: torch.Tensor, *, node: Node) -> torch.Tensor:
    """np.take_along_axis: the axes other than `axis` broadcast between the
    data and the indices, as numpy's do (torch.gather would read a corner)."""
    if a.ndim != indices.ndim:
        raise ValueError(f"{node.name}: indices rank {indices.ndim} != data rank {a.ndim}")
    axis = int(node.attrs.get("axis", 0)) % a.ndim
    idx = index_in_range(indices.to(torch.int64), a.shape[axis], node.name)
    other = [1 if d == axis else s for d, s in enumerate(a.shape)]
    other_i = [1 if d == axis else s for d, s in enumerate(idx.shape)]
    shape = list(broadcast_shapes(other, other_i))
    a_shape, i_shape = list(shape), list(shape)
    a_shape[axis], i_shape[axis] = a.shape[axis], idx.shape[axis]
    return torch.gather(a.expand(a_shape), axis, idx.expand(i_shape))


@infer_rule("one_hot")
def _onehot_rel(node: Node, ins):
    (i, _) = ins[0]
    depth = int(node.attrs["depth"])
    axis = int(node.attrs.get("axis", -1))
    shape = list(i)
    if axis == -1:
        shape = shape + [depth]
    else:
        shape.insert(axis, depth)
    return tuple(shape), node.attrs.get("dtype", "float32")


@np_impl("one_hot")
def _onehot_np(indices, *, node: Node):
    depth = int(node.attrs["depth"])
    on = node.attrs.get("on_value", 1)
    off = node.attrs.get("off_value", 0)
    dtype = node.attrs.get("dtype", "float32")
    out = np.full(indices.shape + (depth,), off, dtype=dtype)
    idx = np.clip(indices, 0, depth - 1)
    np.put_along_axis(out, idx[..., None].astype(np.int64), np.asarray(on, dtype=dtype), axis=-1)
    mask = (indices >= 0) & (indices < depth)
    out = np.where(mask[..., None], out, np.asarray(off, dtype=dtype))
    axis = int(node.attrs.get("axis", -1))
    if axis != -1:
        out = np.moveaxis(out, -1, axis)
    return out


@torch_impl("one_hot")
def _onehot_torch(indices: torch.Tensor, *, node: Node) -> torch.Tensor:
    """`on` where the index, clipped to [0, depth) and truncated as the
    oracle's astype truncates, meets the depth position and the index lies
    in [0, depth); `off` elsewhere (a row out of range is all `off`)."""
    depth = int(node.attrs["depth"])
    dtype = node.attrs.get("dtype", "float32")
    dev = indices.device
    on = torch.from_numpy(np.asarray(node.attrs.get("on_value", 1), dtype=dtype)).to(dev)
    off = torch.from_numpy(np.asarray(node.attrs.get("off_value", 0), dtype=dtype)).to(dev)
    idx = indices.clamp(0, depth - 1).to(torch.int64)
    inside = (indices >= 0) & (indices < depth)
    hit = (idx.unsqueeze(-1) == torch.arange(depth, device=dev)) & inside.unsqueeze(-1)
    out = torch.where(hit, on, off)
    axis = int(node.attrs.get("axis", -1))
    return out if axis == -1 else out.movedim(-1, axis)


# NHWC pooling and layout moves: global max pool, resize, depth <-> space

@infer_rule("nn.global_max_pool2d")
def _gmp_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    return _gap_rel(node, ins)


@np_impl("nn.global_max_pool2d")
def _gmp_np(data: np.ndarray, *, node: Node) -> np.ndarray:
    return data.max(axis=(1, 2), keepdims=node.attrs.get("keepdims", True))


@torch_impl("nn.global_max_pool2d")
def _gmp_torch(data: torch.Tensor, *, node: Node) -> torch.Tensor:
    return torch.amax(data, dim=(1, 2), keepdim=bool(node.attrs.get("keepdims", True)))


@infer_rule("image.resize2d")
def _resize2d_rel(node: Node, ins):
    (a, adt) = ins[0]
    n, h, w, c = a
    oh, ow = _pair(node.attrs["size"])
    return (n, oh, ow, c), adt


def _resize2d_src_coords(in_size: int, out_size: int, ctm: str) -> np.ndarray:
    """Float source coordinates for each output index, per the ONNX / TVM
    coordinate_transformation_mode semantics (TVM's topi/image/resize.py
    get_inx)."""
    x = np.arange(out_size, dtype=np.float64)
    if ctm == "asymmetric":
        return x * in_size / out_size
    if ctm == "half_pixel":
        return (x + 0.5) * in_size / out_size - 0.5
    if ctm == "align_corners":
        return x * (in_size - 1) / max(out_size - 1, 1)
    raise NotImplementedError(
        f"resize2d coordinate_transformation_mode {ctm!r}")


def _resize2d_nn_index(in_size: int, out_size: int, ctm: str,
                       rm: str) -> np.ndarray:
    xin = _resize2d_src_coords(in_size, out_size, ctm)
    if rm == "floor":
        idx = np.floor(xin)
    elif rm == "ceil":
        idx = np.ceil(xin)
    elif rm == "round_prefer_floor":
        idx = np.ceil(xin - 0.5)
    elif rm == "round_prefer_ceil":
        idx = np.floor(xin + 0.5)
    else:
        raise NotImplementedError(f"resize2d rounding_method {rm!r}")
    return np.clip(idx, 0, in_size - 1).astype(np.int64)


def _resize2d_linear_taps(in_size: int, out_size: int, ctm: str):
    """(lo_index, hi_index, hi_weight) static arrays for 1-D linear resize."""
    xin = np.clip(_resize2d_src_coords(in_size, out_size, ctm), 0, in_size - 1)
    lo = np.floor(xin).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (xin - lo).astype(np.float32)


def _resize2d_common(a, node, take=lambda v, ax, idx: np.take(v, idx, axis=ax),
                     const=lambda v, like: v):
    """resize2d over static numpy tables (the shapes are static): the
    nearest gathers, or linear's `top + (bot - top) * w` in the input's
    float dtype, op for op.  The oracle runs it on numpy arrays; the torch
    impl passes a gather and a conversion of the weights to its device."""
    oh, ow = _pair(node.attrs["size"])
    method = node.attrs.get("method", "nearest_neighbor")
    ctm = node.attrs.get("coordinate_transformation_mode", "asymmetric")
    n, h, w, c = a.shape
    if method in ("nearest_neighbor", "nearest"):
        rm = node.attrs.get("rounding_method", "floor")
        ys = _resize2d_nn_index(h, oh, ctm, rm)
        xs = _resize2d_nn_index(w, ow, ctm, rm)
        return take(take(a, 1, ys), 2, xs)
    if method in ("linear", "bilinear"):
        if not _is_float_array(a):
            raise NotImplementedError(
                "resize2d linear requires float input (dequantize first); "
                f"got {a.dtype}")
        ylo, yhi, wy = _resize2d_linear_taps(h, oh, ctm)
        xlo, xhi, wx = _resize2d_linear_taps(w, ow, ctm)
        dtype = str(a.dtype).removeprefix("torch.")
        wy = const(wy.reshape(1, oh, 1, 1).astype(dtype), a)
        wx = const(wx.reshape(1, 1, ow, 1).astype(dtype), a)
        top = take(a, 1, ylo)
        bot = take(a, 1, yhi)
        row = top + (bot - top) * wy
        left = take(row, 2, xlo)
        right = take(row, 2, xhi)
        return left + (right - left) * wx
    raise NotImplementedError(f"resize2d method {method}")


def _is_float_array(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype.is_floating_point
    return np.issubdtype(np.dtype(str(a.dtype)), np.floating)


@np_impl("image.resize2d")
def _resize2d_np(a, *, node: Node):
    return _resize2d_common(a, node)


@torch_impl("image.resize2d")
def _resize2d_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's gather tables and its three linear ops, not
    F.interpolate (whose coordinates and rounding differ); nearest runs on
    any dtype, int8 included (the quantizer passes it through)."""
    dev = a.device
    return _resize2d_common(
        a, node, take=lambda v, ax, idx: v.index_select(ax, torch.from_numpy(idx).to(dev)),
        const=lambda v, like: torch.from_numpy(v).to(dev))


@infer_rule("nn.depth_to_space")
def _d2s_rel(node: Node, ins):
    (a, adt) = ins[0]
    n, h, w, c = a
    b = int(node.attrs["block_size"])
    return (n, h * b, w * b, c // (b * b)), adt


def _d2s(a, node: Node):
    # numpy and torch share reshape; transpose is permute on a tensor
    n, h, w, c = a.shape
    b = int(node.attrs["block_size"])
    perm = (lambda x, p: x.transpose(p)) if isinstance(a, np.ndarray) else \
        (lambda x, p: x.permute(p))
    if node.attrs.get("mode", "DCR") == "DCR":
        x = a.reshape(n, h, w, b, b, c // (b * b))
    else:
        x = perm(a.reshape(n, h, w, c // (b * b), b, b), (0, 1, 2, 4, 5, 3))
    x = perm(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(n, h * b, w * b, c // (b * b))


@np_impl("nn.depth_to_space")
def _d2s_np(a, *, node: Node):
    return _d2s(a, node)


@torch_impl("nn.depth_to_space")
def _d2s_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    return _d2s(a, node)


@infer_rule("nn.space_to_depth")
def _s2d_rel(node: Node, ins):
    (a, adt) = ins[0]
    n, h, w, c = a
    b = int(node.attrs["block_size"])
    return (n, h // b, w // b, c * b * b), adt


@np_impl("nn.space_to_depth")
def _s2d_np(a, *, node: Node):
    n, h, w, c = a.shape
    b = int(node.attrs["block_size"])
    x = a.reshape(n, h // b, b, w // b, b, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, b * b * c)


@torch_impl("nn.space_to_depth")
def _s2d_torch(a: torch.Tensor, *, node: Node) -> torch.Tensor:
    n, h, w, c = a.shape
    b = int(node.attrs["block_size"])
    x = a.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, b * b * c)


# ---------------------------------------------------------------------------
# the TensorFlow importer's ops (frontend/tensorflow.py): rsqrt (Keras 3's
# batch norm), floor_divide (FloorDiv), all / any (All, Any)
# ---------------------------------------------------------------------------

register_op("rsqrt", infer=_same_rel)


@np_impl("rsqrt")
def _rsqrt_np(x, *, node: Node):
    return (1.0 / np.sqrt(x.astype(np.float32))).astype(x.dtype)


@torch_impl("rsqrt")
def _rsqrt_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's float32 1 / sqrt(x): each operation computed in float64
    and rounded to float32, which gives the correctly rounded float32 result
    (float64 carries more than twice float32's bits), as numpy's is.  So the
    result is the oracle's bit for bit on either device: torch's float32
    sqrt on the CPU can be an ulp off, and CUDA's rsqrtf (torch.rsqrt) is
    not correctly rounded."""
    f32, f64 = torch.float32, torch.float64
    s = torch.sqrt(x.to(f32).to(f64)).to(f32)
    return (1.0 / s.to(f64)).to(f32).to(x.dtype)


@np_impl("floor_divide")
def _floor_divide_np(a, b, *, node: Node):
    out_dt = np.dtype(dt.promote(str(a.dtype), str(b.dtype)))
    return np.floor_divide(a.astype(out_dt), b.astype(out_dt))


@torch_impl("floor_divide")
def _floor_divide_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """np.floor_divide in the promoted dtype.  Integers: 0 at a zero
    divisor, numpy's value.  Floats: torch's floor division is numpy's
    (the quotient of a - fmod(a, b), inf or NaN at a zero divisor)."""
    a, b = _promoted(a, b)
    if a.dtype.is_floating_point:
        return torch.div(a, b, rounding_mode="floor")
    zero, b1 = _nonzero_divisor(b)
    return torch.where(zero, torch.zeros_like(a), torch.div(a, b1, rounding_mode="floor"))


register_op("floor_divide", infer=_broadcast_rel)


def _bool_reduce_rel(node: Node, ins):
    return _reduce_rel(node, ins)[0], "bool"


for _n, (_f, _tf) in {"all": (np.all, torch.all), "any": (np.any, torch.any)}.items():
    def _mkbool(f, tf):
        def np_fn(a, *, node: Node):
            out = f(a, axis=_norm_axes(node, a.ndim),
                    keepdims=bool(node.attrs.get("keepdims", False)))
            return np.asarray(out, dtype="bool")

        def torch_fn(a: torch.Tensor, *, node: Node) -> torch.Tensor:
            """The truth of each value (nonzero, NaN true), reduced one axis
            at a time, the highest first; the oracle reads only `axis` and
            `keepdims`."""
            keepdim = bool(node.attrs.get("keepdims", False))
            x = a.to(torch.bool)
            for d in sorted(_reduce_dims(node, a.ndim), reverse=True):
                x = tf(x, dim=d, keepdim=keepdim)
            return x
        return np_fn, torch_fn
    _np_fn, _torch_fn = _mkbool(_f, _tf)
    register_op(_n, infer=_bool_reduce_rel, np_impl=_np_fn, torch_impl=_torch_fn)
