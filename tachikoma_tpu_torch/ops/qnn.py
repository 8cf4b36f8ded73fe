"""QNN ops of int8 ResNet (port of `tachikoma_tpu/ops/qnn.py`).

Zero points and scales are node attrs.  The numpy oracles are the JAX
package's, copied; `qnn.quantize`, `qnn.add` and `qnn.dequantize` also get a
torch implementation with the same integer (and float32) sequence of
operations, so its outputs equal the oracle's bit for bit on any device.

  * qnn.quantize   — cast(clip(rint(x/scale) + zp, qmin, qmax)), ties-to-even.
  * qnn.dequantize — (cast(x, i32) - zp) * scale, in float32.
  * qnn.requantize — ops/fixed_point.py.
  * qnn.conv2d / qnn.dense — (x - izp) . (w - kzp) with int32 accumulation;
                     the torch impls run K4 (ops/kernels), with kzp = 0.
  * qnn.add        — requantize both sides to the output qparams (int32),
                     add, subtract one zp, clip.
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
from .fixed_point import requantize, requantize_np, torch_dtype
from .kernels.conv import qconv2d_flat
from .kernels.matmul_int8 import qmatmul_int8


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

def _check_raw_operands(node: Node, data: torch.Tensor, weight: torch.Tensor) -> int:
    """The input zero point of an unfused qnn.conv2d / qnn.dense that K4 can
    run: int8 operands, kernel zero point 0 (the quantizer always emits 0)
    and an int32 accumulator."""
    kzp = np.asarray(node.attrs.get("kernel_zero_point", 0))
    if (kzp != 0).any():
        raise NotImplementedError(f"{node.name} ({node.op}): a nonzero kernel_zero_point "
                                  "is not ported (the quantizer always emits 0)")
    out_dtype = node.attrs.get("out_dtype", "int32")
    if out_dtype != "int32":
        raise NotImplementedError(f"{node.name} ({node.op}): out_dtype {out_dtype} is not "
                                  "ported yet (W8A16: ROADMAP Queue 1 item 2)")
    if data.dtype != torch.int8 or weight.dtype != torch.int8:
        raise NotImplementedError(f"{node.name} ({node.op}): operands {data.dtype} x "
                                  f"{weight.dtype}; the port's kernels take int8 x int8")
    return int(node.attrs.get("input_zero_point", 0))


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
    izp = _check_raw_operands(node, data, weight)
    if _nn._pair(node.attrs.get("dilation", (1, 1))) != (1, 1):
        raise NotImplementedError(f"{node.name} (qnn.conv2d): dilation is not ported yet")
    return qconv2d_flat(data, weight, strides=_nn._pair(node.attrs.get("strides", (1, 1))),
                        padding=_nn._pad4(node.attrs.get("padding", (0, 0, 0, 0))),
                        groups=int(node.attrs.get("groups", 1)), input_zero_point=izp)


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
    out = d @ w
    return out.astype(node.attrs.get("out_dtype", "int32"))


@torch_impl("qnn.dense")
def _qdense_torch(data: torch.Tensor, weight: torch.Tensor, *, node: Node) -> torch.Tensor:
    izp = _check_raw_operands(node, data, weight)
    lead = data.shape[:-1]
    out = qmatmul_int8(data.reshape(-1, data.shape[-1]), weight, input_zero_point=izp)
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


@np_impl("qnn.add")
def _qadd_np(lhs: np.ndarray, rhs: np.ndarray, *, node: Node) -> np.ndarray:
    out_dtype = node.attrs.get("out_dtype", "int8")
    ozp = int(node.attrs.get("output_zero_point", 0))
    ql = _requant_to_out(lhs, node.attrs["lhs_scale"], node.attrs.get("lhs_zero_point", 0), node)
    qr = _requant_to_out(rhs, node.attrs["rhs_scale"], node.attrs.get("rhs_zero_point", 0), node)
    out = np.add(ql.astype(np.int64), qr.astype(np.int64)).astype(np.int32)
    out = out - np.int32(ozp)
    lo, hi = dt.qmin(out_dtype), dt.qmax(out_dtype)
    return np.clip(out, lo, hi).astype(out_dtype)


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


@torch_impl("qnn.add")
def _qadd_torch(lhs: torch.Tensor, rhs: torch.Tensor, *, node: Node) -> torch.Tensor:
    out_dtype = node.attrs.get("out_dtype", "int8")
    ozp = int(node.attrs.get("output_zero_point", 0))
    ql = _requant_to_out_torch(lhs, node.attrs["lhs_scale"], node.attrs.get("lhs_zero_point", 0), node)
    qr = _requant_to_out_torch(rhs, node.attrs["rhs_scale"], node.attrs.get("rhs_zero_point", 0), node)
    out = (ql.to(torch.int64) + qr.to(torch.int64)).to(torch.int32)
    out = (out.to(torch.int64) - ozp).to(torch.int32)
    lo, hi = dt.qmin(out_dtype), dt.qmax(out_dtype)
    return out.clamp(lo, hi).to(torch_dtype(out_dtype))


register_op("qnn.add", infer=_qbinary_rel)
