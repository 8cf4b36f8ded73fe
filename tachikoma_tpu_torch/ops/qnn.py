"""QNN ops of the int8 CNN and transformer paths (port of
`tachikoma_tpu/ops/qnn.py`).

Zero points and scales are node attrs.  The numpy oracles are the JAX
package's, copied; every op also gets a torch implementation with the same
integer (and float32) sequence of operations as its oracle, so its outputs
equal the oracle's bit for bit on any device.

  * qnn.quantize   — cast(clip(rint(x/scale) + zp, qmin, qmax)), ties-to-even.
  * qnn.dequantize — (cast(x, i32) - zp) * scale, in float32.
  * qnn.requantize — ops/fixed_point.py.
  * qnn.conv2d / qnn.dense — (x - izp) . (w - kzp) with int32 accumulation;
                     the torch impls run K4 (ops/kernels), with kzp = 0.
                     With out_dtype int64 (W8A16: int16 data), the sum is
                     int64, on qgemm_wide / qconv_wide / qdwconv_wide
                     (kernels/wide.py).
  * qnn.batch_matmul — (a - za) @ (b - zb), int32 on K1's batched mode; with
                     out_dtype int64 (W8A16: int16 operands) on qbmm_wide.
  * qnn.add / qnn.subtract — requantize both sides to the output qparams
                     (int32), add (subtract), take one zp off (put it back).
  * qnn.mul        — (lhs - zp)(rhs - zp) in int32, requantized from the
                     product of the scales.
  * qnn.concatenate — each input requantized to the output qparams.
  * qnn.avg_pool2d — (x - izp) pooled to the integer average (round half
                     away from zero), requantized to the output qparams.
  * qnn.softmax, qnn.lut, qnn.attention, qnn.layer_norm — the JAX package's
                     pinned integer semantics, tables built on the host in
                     float64 numpy.  Its TPU tactics are not carried over: the
                     torch impls gather from the tables (`table[x + 128]`, the
                     Q15 exp table) where it selects, divide with integer
                     floor division where it divides in float32, and multiply
                     in int64 where it emulates 64 bits in u32.
  * qnn.simulated_quantize / qnn.simulated_dequantize — the fake-quant
                     pair of quantization-aware training (quantize/qat.py):
                     float in, float out, the oracle's values; the quantize
                     is a torch.autograd.Function whose gradient is the JAX
                     impl's straight-through estimator (1/scale inside the
                     representable range, 0 where the clip saturates).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..ir.graph import Node
from ..ir.registry import TensorType, infer_rule, np_impl, register_op, torch_impl
from ..utils import dtypes as dt
from . import nn as _nn
from .fixed_point import fixed_point_multiplier_shift, requantize, requantize_np, torch_dtype
from .kernels import wide as _wide
from .kernels._lib import LEGACY_ITEM
from .kernels.conv import qconv2d_flat
from .kernels.matmul_int8 import qbmm_int8, qmatmul_int8


def _channel_shape(node: Node, ndim: int):
    shape = [1] * ndim
    shape[int(node.attrs.get("axis", -1))] = -1
    return shape


# -- quantize / dequantize / requantize -------------------------------------

@infer_rule("qnn.quantize")
def _quantize_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), node.attrs.get("out_dtype", "int8")


@np_impl("qnn.quantize")
def _quantize_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    out_dtype = node.attrs.get("out_dtype", "int8")
    scale = np.asarray(node.attrs["scale"], dtype=np.float32)
    zp = np.asarray(node.attrs.get("zero_point", 0), dtype=np.int32)
    if scale.ndim > 0:
        shape = _channel_shape(node, x.ndim)
        scale = scale.reshape(shape)
        zp = np.asarray(zp).reshape(shape) if np.ndim(zp) > 0 else zp
    scaled = np.rint(x.astype(np.float32) / scale)  # nearbyint: ties-to-even
    shifted = scaled + zp.astype(np.float32)
    lo, hi = dt.qmin(out_dtype), dt.qmax(out_dtype)
    return np.clip(shifted, lo, hi).astype(out_dtype)


@functools.lru_cache(maxsize=1024)
def _qparams_on(scale, zp, device: str):
    """(scale float32, zero point int32) tensors on `device`, made once per
    device.  The scale must stay a device tensor: CUDA divides a tensor by a
    host scalar through the scalar's reciprocal, which is not the oracle's
    float32 division."""
    return (torch.as_tensor(np.asarray(scale, np.float32), device=device),
            torch.as_tensor(np.asarray(zp, np.int32), device=device))


def _qparams_torch(node: Node, x: torch.Tensor):
    """(scale float32, zero point) tensors broadcastable against x."""
    def key(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    scale, zp = _qparams_on(key(node.attrs["scale"]), key(node.attrs.get("zero_point", 0)),
                            str(x.device))
    if scale.ndim > 0:
        shape = _channel_shape(node, x.ndim)
        scale = scale.reshape(shape)
        zp = zp.reshape(shape) if zp.ndim > 0 else zp
    return scale, zp


@torch_impl("qnn.quantize")
def _quantize_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    out_dtype = node.attrs.get("out_dtype", "int8")
    scale, zp = _qparams_torch(node, x)
    # float32 division, ties-to-even rounding, float32 zp add: the oracle's order
    shifted = torch.round(x.to(torch.float32) / scale) + zp.to(torch.float32)
    lo, hi = dt.qmin(out_dtype), dt.qmax(out_dtype)
    return shifted.clamp(lo, hi).to(torch_dtype(out_dtype))


@infer_rule("qnn.dequantize")
def _dequantize_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), "float32"


@np_impl("qnn.dequantize")
def _dequantize_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    scale = np.asarray(node.attrs["scale"], dtype=np.float32)
    zp = np.asarray(node.attrs.get("zero_point", 0), dtype=np.int32)
    if scale.ndim > 0:
        shape = _channel_shape(node, x.ndim)
        scale = scale.reshape(shape)
        zp = np.asarray(zp).reshape(shape) if np.ndim(zp) > 0 else zp
    return ((x.astype(np.int32) - zp).astype(np.float32) * scale).astype(np.float32)


@torch_impl("qnn.dequantize")
def _dequantize_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    scale, zp = _qparams_torch(node, x)
    return (x.to(torch.int32) - zp).to(torch.float32) * scale


@infer_rule("qnn.requantize")
def _requantize_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), node.attrs.get("out_dtype", "int8")


@np_impl("qnn.requantize")
def _requantize_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    return requantize_np(
        x,
        node.attrs["input_scale"],
        int(node.attrs.get("input_zero_point", 0)),
        float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        axis=int(node.attrs.get("axis", -1)),
        rounding=node.attrs.get("rounding", "UPWARD"),
        out_dtype=node.attrs.get("out_dtype", "int8"),
    )


@torch_impl("qnn.requantize")
def _requantize_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    return requantize(
        x,
        node.attrs["input_scale"],
        int(node.attrs.get("input_zero_point", 0)),
        float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        axis=int(node.attrs.get("axis", -1)),
        rounding=node.attrs.get("rounding", "UPWARD"),
        out_dtype=node.attrs.get("out_dtype", "int8"),
    )


# -- quantized conv / dense ---------------------------------------------------

def _check_raw_operands(node: Node, data: torch.Tensor, weight: torch.Tensor) -> tuple:
    """(input zero point, kernel zero point) of an unfused qnn.conv2d /
    qnn.dense that the port's kernels can run: int8 or uint8 data and
    weights, the weights with any zero point (legacy uint8 TFLite models),
    into an int32 accumulator (K4, K5); or int8 / int16 data and int8
    weights with zero point 0 into an int64 one (W8A16's own kernels,
    `kernels/wide.py`)."""
    kzp = node.attrs.get("kernel_zero_point", 0)
    out_dtype = node.attrs.get("out_dtype", "int32")
    u8 = (torch.int8, torch.uint8)
    data_dtypes = {"int32": (u8, u8), "int64": ((torch.int8, torch.int16), (torch.int8,))}
    if out_dtype not in data_dtypes:
        raise NotImplementedError(f"{node.name} ({node.op}): out_dtype {out_dtype} is not "
                                  "ported: int32 or int64 accumulators only")
    if data.dtype not in data_dtypes[out_dtype][0] or \
            weight.dtype not in data_dtypes[out_dtype][1]:
        legacy = f" ({LEGACY_ITEM})" if torch.uint8 in (data.dtype, weight.dtype) else ""
        raise NotImplementedError(f"{node.name} ({node.op}): operands {data.dtype} x "
                                  f"{weight.dtype} into {out_dtype}; the port's kernels take "
                                  "int8 or uint8 x int8 or uint8 into int32, int8 or int16 x "
                                  f"int8 into int64{legacy}")
    if out_dtype == "int64" and np.asarray(kzp).any():
        raise NotImplementedError(f"{node.name} ({node.op}): a nonzero kernel_zero_point into "
                                  "int64 is not ported (ROADMAP Queue 1 item 2: W8A16's "
                                  "kernels take weights with zero point 0)")
    return int(node.attrs.get("input_zero_point", 0)), kzp


@infer_rule("qnn.conv2d")
def _qconv_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    shape, _ = _nn._conv2d_rel(node, ins)
    return shape, node.attrs.get("out_dtype", "int32")


@np_impl("qnn.conv2d")
def _qconv_np(data: np.ndarray, weight: np.ndarray, *, node: Node) -> np.ndarray:
    izp = int(node.attrs.get("input_zero_point", 0))
    kzp = node.attrs.get("kernel_zero_point", 0)
    d = data.astype(np.int64) - izp
    w = weight.astype(np.int64)
    if np.ndim(kzp) > 0:
        w = w - np.asarray(kzp, dtype=np.int64).reshape(1, 1, 1, -1)
    elif int(kzp) != 0:
        w = w - int(kzp)
    shadow = node.with_(attrs={**dict(node.attrs), "out_dtype": None})
    out = _nn._conv2d_np(d, w, node=shadow)
    return out.astype(node.attrs.get("out_dtype", "int32"))


@torch_impl("qnn.conv2d")
def _qconv_torch(data: torch.Tensor, weight: torch.Tensor, *, node: Node) -> torch.Tensor:
    izp, kzp = _check_raw_operands(node, data, weight)
    geometry = dict(strides=_nn._pair(node.attrs.get("strides", (1, 1))),
                    padding=_nn._pad4(node.attrs.get("padding", (0, 0, 0, 0))),
                    groups=int(node.attrs.get("groups", 1)),
                    dilation=_nn._pair(node.attrs.get("dilation", (1, 1))))
    if node.attrs.get("out_dtype", "int32") == "int64":
        return _wide.wide_conv(data, weight, izp=izp, **geometry)
    return qconv2d_flat(data, weight, input_zero_point=izp, kernel_zero_point=kzp, **geometry)


@infer_rule("qnn.dense")
def _qdense_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    shape, _ = _nn._dense_rel(node, ins)
    return shape, node.attrs.get("out_dtype", "int32")


@np_impl("qnn.dense")
def _qdense_np(data: np.ndarray, weight: np.ndarray, *, node: Node) -> np.ndarray:
    izp = int(node.attrs.get("input_zero_point", 0))
    kzp = node.attrs.get("kernel_zero_point", 0)
    d = data.astype(np.int64) - izp
    w = weight.astype(np.int64)
    if np.ndim(kzp) > 0:
        w = w - np.asarray(kzp, dtype=np.int64).reshape(1, -1)
    elif int(kzp) != 0:
        w = w - int(kzp)
    acc = _nn.exact_int_acc(d, w, d.shape[-1])
    out = (d.astype(acc) @ w.astype(acc)).astype(np.int64)
    return out.astype(node.attrs.get("out_dtype", "int32"))


@torch_impl("qnn.dense")
def _qdense_torch(data: torch.Tensor, weight: torch.Tensor, *, node: Node) -> torch.Tensor:
    izp, kzp = _check_raw_operands(node, data, weight)
    lead = data.shape[:-1]
    x = data.reshape(-1, data.shape[-1])
    if node.attrs.get("out_dtype", "int32") == "int64":
        out = _wide.wide_dense(x, weight, izp=izp)
    else:
        out = qmatmul_int8(x, weight, input_zero_point=izp, kernel_zero_point=kzp)
    return out.reshape(*lead, weight.shape[-1])


# -- quantized add -----------------------------------------------------------

def _qbinary_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, adt), (b, _) = ins[0], ins[1]
    return _nn.broadcast_shapes(a, b), node.attrs.get("out_dtype", adt)


def _same_qparams(scale, zp, node: Node) -> bool:
    """RequantizeOrUpcast: the multiply is skipped when input and output
    qparams match."""
    scale_arr = np.asarray(scale, dtype=np.float64)
    return (scale_arr.ndim == 0 and float(scale_arr) == float(node.attrs["output_scale"])
            and int(zp) == int(node.attrs.get("output_zero_point", 0)))


def _requant_to_out(x: np.ndarray, scale, zp, node: Node) -> np.ndarray:
    """Requantize (or upcast) to the output qparams; always lands in int32."""
    if _same_qparams(scale, zp, node):
        return x.astype(np.int32)
    return requantize_np(
        x, scale, int(zp), float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        axis=int(node.attrs.get("axis", -1)),
        rounding=node.attrs.get("rounding", "UPWARD"),
        out_dtype="int32",
    )


def _qadd_like(npop):
    def impl(lhs: np.ndarray, rhs: np.ndarray, *, node: Node) -> np.ndarray:
        out_dtype = node.attrs.get("out_dtype", "int8")
        ozp = int(node.attrs.get("output_zero_point", 0))
        ql = _requant_to_out(lhs, node.attrs["lhs_scale"], node.attrs.get("lhs_zero_point", 0), node)
        qr = _requant_to_out(rhs, node.attrs["rhs_scale"], node.attrs.get("rhs_zero_point", 0), node)
        out = npop(ql.astype(np.int64), qr.astype(np.int64)).astype(np.int32)
        if npop is np.add:
            out = out - np.int32(ozp)
        else:  # subtract: zp_c - (zp_c) cancels once the other way
            out = out + np.int32(ozp)
        lo, hi = dt.qmin(out_dtype), dt.qmax(out_dtype)
        return np.clip(out, lo, hi).astype(out_dtype)

    return impl


def _requant_to_out_torch(x: torch.Tensor, scale, zp, node: Node) -> torch.Tensor:
    if _same_qparams(scale, zp, node):
        return x.to(torch.int32)
    return requantize(
        x.to(torch.int32), scale, int(zp), float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        axis=int(node.attrs.get("axis", -1)),
        rounding=node.attrs.get("rounding", "UPWARD"),
        out_dtype="int32",
    )


def _qadd_like_torch(subtract: bool):
    def impl(lhs: torch.Tensor, rhs: torch.Tensor, *, node: Node) -> torch.Tensor:
        out_dtype = node.attrs.get("out_dtype", "int8")
        ozp = int(node.attrs.get("output_zero_point", 0))
        ql = _requant_to_out_torch(lhs, node.attrs["lhs_scale"],
                                   node.attrs.get("lhs_zero_point", 0), node).to(torch.int64)
        qr = _requant_to_out_torch(rhs, node.attrs["rhs_scale"],
                                   node.attrs.get("rhs_zero_point", 0), node).to(torch.int64)
        out = (ql - qr if subtract else ql + qr).to(torch.int32)
        out = (out.to(torch.int64) + (ozp if subtract else -ozp)).to(torch.int32)
        lo, hi = dt.qmin(out_dtype), dt.qmax(out_dtype)
        return out.clamp(lo, hi).to(torch_dtype(out_dtype))

    return impl


register_op("qnn.add", infer=_qbinary_rel, np_impl=_qadd_like(np.add),
            torch_impl=_qadd_like_torch(False))
register_op("qnn.subtract", infer=_qbinary_rel, np_impl=_qadd_like(np.subtract),
            torch_impl=_qadd_like_torch(True))


@infer_rule("qnn.mul")
def _qmul_rel(node: Node, ins):
    return _qbinary_rel(node, ins)


def _qmul_scale(node: Node) -> float:
    return float(np.asarray(node.attrs["lhs_scale"]).item()) * float(
        np.asarray(node.attrs["rhs_scale"]).item())


@np_impl("qnn.mul")
def _qmul_np(lhs: np.ndarray, rhs: np.ndarray, *, node: Node) -> np.ndarray:
    out_dtype = node.attrs.get("out_dtype", "int8")
    lzp = int(node.attrs.get("lhs_zero_point", 0))
    rzp = int(node.attrs.get("rhs_zero_point", 0))
    l = lhs.astype(np.int32) - np.int32(lzp)
    r = rhs.astype(np.int32) - np.int32(rzp)
    prod = (l.astype(np.int64) * r.astype(np.int64)).astype(np.int32)
    return requantize_np(
        prod, _qmul_scale(node), 0,
        float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        rounding=node.attrs.get("rounding", "UPWARD"),
        out_dtype=out_dtype,
    )


@torch_impl("qnn.mul")
def _qmul_torch(lhs: torch.Tensor, rhs: torch.Tensor, *, node: Node) -> torch.Tensor:
    lzp = int(node.attrs.get("lhs_zero_point", 0))
    rzp = int(node.attrs.get("rhs_zero_point", 0))
    prod = ((lhs.to(torch.int64) - lzp) * (rhs.to(torch.int64) - rzp)).to(torch.int32)
    return requantize(prod, _qmul_scale(node), 0, float(node.attrs["output_scale"]),
                      int(node.attrs.get("output_zero_point", 0)),
                      rounding=node.attrs.get("rounding", "UPWARD"),
                      out_dtype=node.attrs.get("out_dtype", "int8"))


@infer_rule("qnn.concatenate")
def _qconcat_rel(node: Node, ins):
    return _nn._concat_rel(node, ins)


@np_impl("qnn.concatenate")
def _qconcat_np(*args: np.ndarray, node: Node) -> np.ndarray:
    # requantize every input to the output qparams, then concatenate
    scales = node.attrs["input_scales"]
    zps = node.attrs["input_zero_points"]
    oscale = float(node.attrs["output_scale"])
    ozp = int(node.attrs.get("output_zero_point", 0))
    out_dtype = node.attrs.get("out_dtype", str(args[0].dtype))
    rounding = node.attrs.get("rounding", "UPWARD")
    parts = []
    for x, s, z in zip(args, scales, zps):
        if float(s) == oscale and int(z) == ozp:
            parts.append(x.astype(out_dtype))
        else:
            parts.append(
                requantize_np(x, float(s), int(z), oscale, ozp,
                              rounding=rounding, out_dtype=out_dtype)
            )
    return np.concatenate(parts, axis=int(node.attrs.get("axis", 0)))


@torch_impl("qnn.concatenate")
def _qconcat_torch(*args: torch.Tensor, node: Node) -> torch.Tensor:
    oscale = float(node.attrs["output_scale"])
    ozp = int(node.attrs.get("output_zero_point", 0))
    out_dtype = node.attrs.get("out_dtype", _nn._dtype_name(args[0]))
    rounding = node.attrs.get("rounding", "UPWARD")
    parts = []
    for x, s, z in zip(args, node.attrs["input_scales"], node.attrs["input_zero_points"]):
        if float(s) == oscale and int(z) == ozp:
            parts.append(x.to(torch_dtype(out_dtype)))
        else:
            parts.append(requantize(x.to(torch.int32), float(s), int(z), oscale, ozp,
                                    rounding=rounding, out_dtype=out_dtype))
    return torch.cat(parts, dim=int(node.attrs.get("axis", 0)))


# -- quantized average pool ---------------------------------------------------

@infer_rule("qnn.avg_pool2d")
def _qavgpool_rel(node: Node, ins):
    return _nn._pool_rel(node, ins)


@np_impl("qnn.avg_pool2d")
def _qavgpool_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    # `src/relay/qnn/op/avg_pool2d.cc`: cast i32, subtract izp, pool (integer
    # average, round-half-away), requantize to output qparams, clip/cast.
    out_dtype = node.attrs.get("out_dtype", str(x.dtype))
    izp = int(node.attrs.get("input_zero_point", 0))
    v = x.astype(np.int32) - np.int32(izp)
    pooled = _nn._avg_pool2d_np(v, node=node)
    return requantize_np(
        pooled, float(node.attrs["input_scale"]), 0, float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        rounding=node.attrs.get("rounding", "UPWARD"), out_dtype=out_dtype)


@torch_impl("qnn.avg_pool2d")
def _qavgpool_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's sequence in integer torch: int32 minus the input zero
    point, nn.avg_pool2d's int64 window sums and round-half-away average
    (padded cells add 0 and, without count_include_pad, do not count), then
    the exact fixed-point requantize.  The JAX package runs it on XLA, not
    in Pallas."""
    out_dtype = node.attrs.get("out_dtype", _nn._dtype_name(x))
    izp = int(node.attrs.get("input_zero_point", 0))
    pooled = _nn._avg_pool2d_torch(x.to(torch.int32) - izp, node=node)
    return requantize(
        pooled, float(node.attrs["input_scale"]), 0, float(node.attrs["output_scale"]),
        int(node.attrs.get("output_zero_point", 0)),
        rounding=node.attrs.get("rounding", "UPWARD"), out_dtype=out_dtype)


# -- quantized batch matmul --------------------------------------------------

@infer_rule("qnn.batch_matmul")
def _qbmm_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    shape, _ = _nn._bmm_rel(node, ins)
    return shape, node.attrs.get("out_dtype", "int32")


@np_impl("qnn.batch_matmul")
def _qbmm_np(a: np.ndarray, b: np.ndarray, *, node: Node) -> np.ndarray:
    azp = int(node.attrs.get("lhs_zero_point", 0))
    bzp = int(node.attrs.get("rhs_zero_point", 0))
    x = a.astype(np.int64) - azp
    y = b.astype(np.int64) - bzp
    if node.attrs.get("transpose_a", False):
        x = np.swapaxes(x, -1, -2)
    if node.attrs.get("transpose_b", False):
        y = np.swapaxes(y, -1, -2)
    out = x @ y
    return out.astype(node.attrs.get("out_dtype", "int32"))


@torch_impl("qnn.batch_matmul")
def _qbmm_torch(a: torch.Tensor, b: torch.Tensor, *, node: Node) -> torch.Tensor:
    """K1's batched mode in its raw epilogue; into int64 (W8A16's int16
    operands) `qbmm_wide` (each the plain version on a CPU tensor)."""
    out_dtype = node.attrs.get("out_dtype", "int32")
    kw = dict(lhs_zero_point=int(node.attrs.get("lhs_zero_point", 0)),
              rhs_zero_point=int(node.attrs.get("rhs_zero_point", 0)),
              transpose_a=bool(node.attrs.get("transpose_a", False)),
              transpose_b=bool(node.attrs.get("transpose_b", False)))
    if out_dtype == "int64":
        return _wide.qbmm_wide(a, b, **kw)
    if out_dtype != "int32":
        raise NotImplementedError(f"{node.name} (qnn.batch_matmul): out_dtype {out_dtype} is "
                                  "not ported: int32 (K1's batched mode) or int64 (qbmm_wide) "
                                  "accumulators only")
    return qbmm_int8(a, b, **kw)


register_op("qnn.batch_matmul", flops=_nn._bmm_flops)
register_op("qnn.conv2d", flops=_nn._conv2d_flops)
register_op("qnn.dense", flops=_nn._dense_flops)


# -- integer softmax & LUT ops ----------------------------------------------
# The JAX package's pinned exact integer semantics, shared by the trace
# verifier.

LUT_EXP_BITS = 15          # exp table is Q15
LUT_SIZE = 256
SOFTMAX_OUT_SCALE = 1.0 / 256.0
SOFTMAX_OUT_ZP = -128


def softmax_exp_factors(input_scale: float) -> tuple[np.ndarray, np.ndarray]:
    """Factorized Q15 exp: table[k] == (hi[k >> 4] * lo[k & 15] + 2^14) >> 15.

    hi[j] ~ round(2^15 exp(-16 j s)), lo[i] ~ round(2^15 exp(-i s)).  hi is
    additionally clamped so hi[j+1] <= (hi[j] * lo[15] + 2^14) >> 15, which
    makes the composed table monotone non-increasing by construction."""
    s = float(input_scale)
    j = np.arange(16, dtype=np.float64)
    lo = np.rint((1 << LUT_EXP_BITS) * np.exp(-j * s)).astype(np.int64)
    hi = np.rint((1 << LUT_EXP_BITS) * np.exp(-16.0 * j * s)).astype(np.int64)
    r = 1 << (LUT_EXP_BITS - 1)
    for k in range(15):
        cap = (hi[k] * lo[15] + r) >> LUT_EXP_BITS
        if hi[k + 1] > cap:
            hi[k + 1] = cap
    return hi.astype(np.int32), lo.astype(np.int32)


def softmax_exp_table(input_scale: float) -> np.ndarray:
    """table[k] = (hi[k >> 4] * lo[k & 15] + 2^14) >> 15 (softmax_exp_factors);
    the saturation bucket table[255] is pinned to 0 so scores >= 255
    quantization steps below the row max contribute nothing."""
    hi, lo = softmax_exp_factors(input_scale)
    k = np.arange(LUT_SIZE)
    t = ((hi[k >> 4].astype(np.int64) * lo[k & 15]
          + (1 << (LUT_EXP_BITS - 1))) >> LUT_EXP_BITS).astype(np.int32)
    t[LUT_SIZE - 1] = 0
    return t


@functools.lru_cache(maxsize=1024)
def _table_on(values: tuple, device: str) -> torch.Tensor:
    """An int64 lookup table on `device`, made once per table and device."""
    return torch.tensor(values, dtype=torch.int64, device=device)


_NODE_CONSTS: dict = {}


def _node_consts(node: Node, device, make):
    """make() -> the node's constant tensors on `device`, made once per node
    and device (the executor calls the impl every run)."""
    key = (id(node), str(device))
    hit = _NODE_CONSTS.get(key)
    if hit is None or hit[0] is not node:
        if len(_NODE_CONSTS) >= 4096:
            _NODE_CONSTS.clear()
        hit = _NODE_CONSTS[key] = (node, make())
    return hit[1]


def _exp_table_torch(input_scale: float, device) -> torch.Tensor:
    return _table_on(tuple(int(v) for v in softmax_exp_table(input_scale)), str(device))


def _softmax_q(p: torch.Tensor, axis: int) -> torch.Tensor:
    """(p * 256 + sum // 2) // sum over `axis`, in int64 (p >= 0, sum > 0)."""
    ssum = p.sum(dim=axis, keepdim=True)
    return torch.div(p * 256 + torch.div(ssum, 2, rounding_mode="floor"), ssum,
                     rounding_mode="floor")


@infer_rule("qnn.softmax")
def _qsoftmax_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), node.attrs.get("out_dtype", "int8")


@np_impl("qnn.softmax")
def _qsoftmax_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    """Exact integer softmax:
      d    = clip(max(x) - x, 0, 255)
      p    = table[d]                      (Q15 exp)
      sum  = sum(p)
      q    = (p * 256 + sum // 2) // sum   (non-negative integer division)
      out  = clip(q - 128, -128, 127)      (scale 1/256, zp -128)
    """
    axis = int(node.attrs.get("axis", -1))
    table = softmax_exp_table(float(node.attrs["input_scale"]))
    v = x.astype(np.int64)
    m = v.max(axis=axis, keepdims=True)
    d = np.clip(m - v, 0, LUT_SIZE - 1)
    p = table[d].astype(np.int64)
    ssum = p.sum(axis=axis, keepdims=True)
    q = (p * 256 + ssum // 2) // ssum
    out = np.clip(q + SOFTMAX_OUT_ZP, -128, 127)
    return out.astype(node.attrs.get("out_dtype", "int8"))


@torch_impl("qnn.softmax")
def _qsoftmax_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    axis = int(node.attrs.get("axis", -1))
    table = _exp_table_torch(float(node.attrs["input_scale"]), x.device)
    v = x.to(torch.int64)
    d = (v.amax(dim=axis, keepdim=True) - v).clamp(0, LUT_SIZE - 1)
    q = _softmax_q(table[d], axis)
    out = (q + SOFTMAX_OUT_ZP).clamp(-128, 127)
    return out.to(torch_dtype(node.attrs.get("out_dtype", "int8")))


@infer_rule("qnn.lut")
def _qlut_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), node.attrs.get("out_dtype", "int8")


@np_impl("qnn.lut")
def _qlut_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    """Generic int8 -> int8 elementwise op as a 256-entry table lookup."""
    table = np.asarray(node.attrs["table"], dtype=np.int8)
    assert table.shape == (LUT_SIZE,)
    idx = x.astype(np.int32) + 128  # int8 -> [0, 255]
    return table[idx]


@torch_impl("qnn.lut")
def _qlut_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    table = node.attrs["table"]
    if len(table) != LUT_SIZE:
        raise ValueError(f"{node.name} (qnn.lut): a table of {LUT_SIZE} entries, got {len(table)}")
    t = _node_consts(node, x.device, lambda: torch.tensor(np.asarray(table, np.int8),
                                                          device=x.device))
    return t[x.to(torch.int64) + 128]


def build_lut(float_fn, input_scale: float, input_zp: int,
              output_scale: float, output_zp: int) -> np.ndarray:
    """table[q+128] = quantize(f(dequantize(q))) for q in [-128, 127]."""
    q = np.arange(-128, 128, dtype=np.int32)
    x = (q - input_zp).astype(np.float64) * input_scale
    y = float_fn(x.astype(np.float32)).astype(np.float64)
    out = np.rint(y / output_scale) + output_zp
    return np.clip(out, -128, 127).astype(np.int8)


# -- fused integer attention -------------------------------------------------
# qnn.attention (all integer, pinned):
#   s    = q @ k^T                  (int32)
#   p_ij = exp_table[clip(max_j s_ij - s_ij, 0, 255)]   (Q15, scores_scale)
#   u_ij = (p_ij * 256 + sum_i//2) // sum_i             (0..256)
#   ctx  = u @ v                    (int32, two's-complement wraparound)
#   out  = requantize(ctx, v_scale/256 -> output_scale, UPWARD, int8)

@infer_rule("qnn.attention")
def _qattn_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (qs, _), (ks, _), (vs, _) = ins[:3]
    return tuple(qs), node.attrs.get("out_dtype", "int8")


@np_impl("qnn.attention")
def _qattn_np(q: np.ndarray, k: np.ndarray, v: np.ndarray, *, node: Node) -> np.ndarray:
    scores_scale = float(node.attrs["scores_scale"])
    out_scale = float(node.attrs["output_scale"])
    v_scale = float(node.attrs["v_scale"])
    table = softmax_exp_table(scores_scale)
    s = q.astype(np.int64) @ np.swapaxes(k.astype(np.int64), -1, -2)
    s = s.astype(np.int32)
    m = s.max(axis=-1, keepdims=True)
    d = np.clip(m.astype(np.int64) - s, 0, LUT_SIZE - 1)
    p = table[d].astype(np.int64)
    ssum = p.sum(axis=-1, keepdims=True)
    u = (p * 256 + ssum // 2) // ssum            # (..., S, S) in [0, 256]
    ctx = (u.astype(np.int64) @ v.astype(np.int64)).astype(np.int32)
    return requantize_np(
        ctx, v_scale / 256.0, 0, out_scale, 0,
        rounding=node.attrs.get("rounding", "UPWARD"),
        out_dtype=node.attrs.get("out_dtype", "int8"),
    )


@torch_impl("qnn.attention")
def _qattn_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, node: Node) -> torch.Tensor:
    """Both products on K1's batched mode.  u (0..256) is not int8, so
    u @ v = (min(u, 255) - 128 with zero point -128) @ v + (u == 256) @ v,
    the two sums added in int32 wraparound."""
    if q.dtype != torch.int8 or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise NotImplementedError(f"{node.name} (qnn.attention): int8 q, k, v only (ROADMAP "
                                  "Queue 1 item 2: int16 qnn.attention)")
    table = _exp_table_torch(float(node.attrs["scores_scale"]), q.device)
    s = qbmm_int8(q, k, transpose_b=True).to(torch.int64)
    d = (s.amax(dim=-1, keepdim=True) - s).clamp(0, LUT_SIZE - 1)
    u = _softmax_q(table[d], -1)
    lo = (u.clamp(max=255) - 128).to(torch.int8)
    ctx = (qbmm_int8(lo, v, lhs_zero_point=-128).to(torch.int64)
           + qbmm_int8((u == 256).to(torch.int8), v).to(torch.int64)).to(torch.int32)
    return requantize(ctx, float(node.attrs["v_scale"]) / 256.0, 0,
                      float(node.attrs["output_scale"]), 0,
                      rounding=node.attrs.get("rounding", "UPWARD"),
                      out_dtype=node.attrs.get("out_dtype", "int8"))


# -- integer layer norm ------------------------------------------------------
# qnn.layer_norm pins integer-only semantics (the JAX package's):
#
#   t   = x - z_x                        (int32, |t| <= 255)
#   S   = sum(t); c = N*t - S            (int32; (x-mu)/s_x = c/N)
#   d   = rshift_round(c, k1); V = max(sum(d^2), 1)        (int32)
#   rsqrt(V) via the IEEE-754 bit pattern of float32(V) (int->f32 conversion
#       is correctly rounded): exponent e, u = mant*2^odd in [1,4),
#       r = interp(RSQRT_TABLE, u) ~= 2^15/sqrt(u), so
#       1/sqrt(V) = r * 2^-15 * 2^-e2 with e2 = (e-127)>>1
#   y   = rshift_round(c, k2) * r * sign(gamma_ch)         (|y| < 2^30)
#   out = clip(qms(y, m_ch, s_ch - e2) + bias_ch)          (int8)
#
# where (m_ch, s_ch) encode |gamma_ch| * sqrt(N) * 2^(k2-15-k1) / s_out and
# bias_ch = round(beta_ch/s_out) + z_out.  k1/k2 are pinned per N so every
# intermediate fits int32 (k1: sum of squares; k2: the Q15 product).

LN_RSQRT_BITS = 15


def rsqrt_table() -> np.ndarray:
    """513-entry Q15 table of 2^15/sqrt(u) over u in [1, 4] (monotone,
    contiguous across the even/odd-exponent halves; entry 512 = u=4)."""
    i = np.arange(513, dtype=np.float64)
    u = np.where(i < 256, 1.0 + i / 256.0, 2.0 + (i - 256.0) / 128.0)
    return np.rint((1 << LN_RSQRT_BITS) / np.sqrt(u)).astype(np.int32)


_LN_RSQRT_TABLE = rsqrt_table()


def _ln_shift_plan(n_feat: int) -> tuple[int, int]:
    maxc = 2 * 255 * n_feat
    k1 = 0
    while n_feat * (-(-maxc // (1 << k1))) ** 2 >= (1 << 31):
        k1 += 1
    k2 = max(0, maxc.bit_length() + LN_RSQRT_BITS - 30)
    return k1, k2


def plan_layer_norm(gamma, beta, in_scale: float, in_zp: int,
                    out_scale: float, out_zp: int, n_feat: int) -> dict:
    """Fold float gamma/beta into qnn.layer_norm integer attrs."""
    gamma = np.asarray(gamma, np.float64).ravel()
    beta = np.asarray(beta, np.float64).ravel()
    k1, k2 = _ln_shift_plan(n_feat)
    a_ch = (np.maximum(np.abs(gamma), 1e-12) * np.sqrt(n_feat)
            * 2.0 ** (k2 - LN_RSQRT_BITS - k1) / float(out_scale))
    ms, ss = zip(*(fixed_point_multiplier_shift(float(a)) for a in a_ch))
    bias = np.clip(np.rint(beta / float(out_scale)) + out_zp,
                   -(1 << 30), 1 << 30).astype(np.int64)
    return {
        "multiplier": [int(v) for v in ms],
        "shift": [int(v) for v in ss],
        "sign": [int(v) for v in np.where(gamma < 0, -1, 1)],
        "bias": [int(v) for v in bias],
        "k1": k1, "k2": k2,
        "input_zero_point": int(in_zp),
    }


def _rshift_round_np(v: np.ndarray, k: int) -> np.ndarray:
    if k <= 0:
        return v
    return (v + (1 << (k - 1))) >> k


@infer_rule("qnn.layer_norm")
def _qln_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), node.attrs.get("out_dtype", "int8")


@np_impl("qnn.layer_norm")
def _qln_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    a = node.attrs
    k1, k2 = int(a["k1"]), int(a["k2"])
    n = x.shape[-1]
    t = x.astype(np.int32) - np.int32(a.get("input_zero_point", 0))
    s = t.sum(axis=-1, keepdims=True, dtype=np.int32)
    c = np.int32(n) * t - s
    d = _rshift_round_np(c, k1)
    v = np.maximum((d * d).sum(axis=-1, keepdims=True, dtype=np.int32), 1)
    fb = np.float32(0) + v.astype(np.float32)      # IEEE RNE int->f32
    bits = fb.view(np.uint32).astype(np.int64)
    e = (bits >> 23).astype(np.int32)
    mant8 = ((bits >> 15) & 0xFF).astype(np.int32)
    frac = ((bits >> 7) & 0xFF).astype(np.int32)
    odd = (e - 127) & 1
    e2 = (e - 127) >> 1
    idx = odd * 256 + mant8
    t0 = _LN_RSQRT_TABLE[idx]
    t1 = _LN_RSQRT_TABLE[idx + 1]
    r = t0 - (((t0 - t1) * frac) >> 8)             # Q15
    y = _rshift_round_np(c, k2) * r                # int32 (< 2^30 by k2)
    sign = np.asarray(a["sign"], np.int32)
    y = y * sign
    # per-element fixed-point multiply: m_ch * 2^(s_ch - e2 - 31), UPWARD
    m_ch = np.asarray(a["multiplier"], np.int64)
    s_ch = np.asarray(a["shift"], np.int64)
    sh = s_ch - e2.astype(np.int64)                # broadcast rows x channels
    left = np.maximum(sh, 0)
    total_right = np.int64(31) + np.maximum(-sh, 0)
    prod = (y.astype(np.int64) << left) * m_ch
    prod = prod + (np.int64(1) << (total_right - 1))
    out = prod >> total_right
    out = out + np.asarray(a["bias"], np.int64)
    odt = a.get("out_dtype", "int8")
    return np.clip(out, dt.qmin(odt), dt.qmax(odt)).astype(odt)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's values in int32 wraparound, as int32."""
    return v.to(torch.int32)


def _rshift_round_torch(v: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return v
    return _wrap32(v.to(torch.int64) + (1 << (k - 1))) >> k


@torch_impl("qnn.layer_norm")
def _qln_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """The oracle's sequence in int32 where it keeps int32 (the sums, n t -
    S and d d wrap alike) and int64 for the fixed-point multiply; the
    float32 of V converted round-to-nearest-even and its bits read back."""
    a = node.attrs
    k1, k2 = int(a["k1"]), int(a["k2"])
    n = x.shape[-1]
    dev = x.device
    t = _wrap32(x.to(torch.int64) - int(a.get("input_zero_point", 0)))
    s = t.sum(dim=-1, keepdim=True, dtype=torch.int32)
    c = _wrap32(n * t.to(torch.int64) - s.to(torch.int64))
    d = _rshift_round_torch(c, k1)
    v = _wrap32(d.to(torch.int64) * d.to(torch.int64)).sum(dim=-1, keepdim=True,
                                                          dtype=torch.int32).clamp(min=1)
    bits = v.to(torch.float32).view(torch.int32).to(torch.int64)
    e = bits >> 23
    mant8 = (bits >> 15) & 0xFF
    frac = (bits >> 7) & 0xFF
    odd = (e - 127) & 1
    e2 = (e - 127) >> 1
    idx = odd * 256 + mant8
    table, sign, m_ch, s_ch, bias = _node_consts(node, dev, lambda: (
        _table_on(tuple(int(u) for u in _LN_RSQRT_TABLE), str(dev)),
        *(torch.tensor(np.asarray(a[key], np.int64), device=dev)
          for key in ("sign", "multiplier", "shift", "bias"))))
    t0, t1 = table[idx], table[idx + 1]
    r = t0 - (((t0 - t1) * frac) >> 8)
    y = _wrap32(_rshift_round_torch(c, k2).to(torch.int64) * r)
    y = _wrap32(y.to(torch.int64) * sign)
    sh = s_ch - e2
    left = sh.clamp(min=0)
    total_right = 31 + (-sh).clamp(min=0)
    prod = (y.to(torch.int64) << left) * m_ch
    prod = prod + (torch.ones_like(total_right) << (total_right - 1))
    out = (prod >> total_right) + bias
    odt = a.get("out_dtype", "int8")
    return out.clamp(dt.qmin(odt), dt.qmax(odt)).to(torch_dtype(odt))



# -- simulated (fake) quantization for QAT -----------------------------------
# The reference's qnn.simulated_quantize / simulated_dequantize: float-in,
# float-out ops that mimic quantize (round + zp + clip) and dequantize, so
# that a float model trains THROUGH the quantization nonlinearity.

def _sim_scale_zp(node: Node, ndim: int):
    scale = np.asarray(node.attrs["scale"], np.float32)
    zp = np.asarray(node.attrs.get("zero_point", 0), np.int32)
    if scale.ndim > 0:
        axis = int(node.attrs.get("axis", -1))
        shape = [1] * ndim
        shape[axis] = -1
        scale = scale.reshape(shape)
        zp = zp.reshape(shape) if zp.ndim > 0 else zp
    return scale, zp


@infer_rule("qnn.simulated_quantize")
def _simq_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), "float32"


@np_impl("qnn.simulated_quantize")
def _simq_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    scale, zp = _sim_scale_zp(node, x.ndim)
    odt = node.attrs.get("out_dtype", "int8")
    q = np.rint(x.astype(np.float32) / scale) + zp
    return np.clip(q, dt.qmin(odt), dt.qmax(odt)).astype(np.float32)


class _SimulatedQuantize(torch.autograd.Function):
    """clip(round(x / scale) + zp, lo, hi) in float32; backward: the
    straight-through estimator, grad / scale where lo <= round(x / scale) +
    zp <= hi before the clip, 0 where the clip saturates."""

    @staticmethod
    def forward(ctx, x, scale, zp, lo, hi):
        q = torch.round(x / scale) + zp
        ctx.save_for_backward((q >= lo) & (q <= hi), scale)
        return q.clamp(lo, hi)

    @staticmethod
    def backward(ctx, grad):
        inside, scale = ctx.saved_tensors
        return torch.where(inside, grad / scale, torch.zeros_like(grad)), None, None, None, None


@torch_impl("qnn.simulated_quantize")
def _simq_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    scale, zp = _qparams_torch(node, x)
    odt = node.attrs.get("out_dtype", "int8")
    return _SimulatedQuantize.apply(x.to(torch.float32), scale, zp.to(torch.float32),
                                    float(dt.qmin(odt)), float(dt.qmax(odt)))


@infer_rule("qnn.simulated_dequantize")
def _simdq_rel(node: Node, ins: Sequence[TensorType]) -> TensorType:
    (a, _) = ins[0]
    return tuple(a), "float32"


@np_impl("qnn.simulated_dequantize")
def _simdq_np(x: np.ndarray, *, node: Node) -> np.ndarray:
    scale, zp = _sim_scale_zp(node, x.ndim)
    return ((x.astype(np.float32) - zp) * scale).astype(np.float32)


@torch_impl("qnn.simulated_dequantize")
def _simdq_torch(x: torch.Tensor, *, node: Node) -> torch.Tensor:
    """(x - zp) is an exact integer in float32; one float32 product by the
    scale then rounds as the oracle's float64 product rounded to float32."""
    scale, zp = _qparams_torch(node, x)
    return (x.to(torch.float32) - zp.to(torch.float32)) * scale
