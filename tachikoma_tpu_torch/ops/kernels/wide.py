"""The W8A16 product on the card: qnn.conv2d and qnn.dense with an int64
accumulator, int16 (or int8) data minus its zero point times int8 weights.

No Pallas kernel: the JAX package runs these products on XLA with an int64
accumulator (`tachikoma_tpu/ops/jax_ops.py` `_qconv2d_jax` and
`_qdense_jax`), and PyTorch has no int64 convolution or matmul on CUDA.  The
route here reuses K4 and K5's raw modes, hand-written int8 tensor-core
kernels, on two byte planes of the int16 operand:

    x = 256 * hi + lo,  izp = 256 * zh + zl,  lo, zl in [0, 255]
    sum (x - izp) * w = 256 * sum (hi - zh) * w + sum (lo - zl) * w

The hi plane is int8 as it stands, with zero point zh; the lo plane runs as
the int8 lo - 128 with zero point zl - 128.  Each kernel pads the border with
its zero point, so a padded cell adds 0 on both planes, as the oracle's
int64 pad does.  A 1x1 conv or a dense runs K4's GEMM mode (`qgemm_raw`),
another conv K4's conv mode (`qconv_raw`), a depthwise conv K5's raw mode
(`qdwconv_raw`); the two int32 accumulators are combined in int64.

Each plane's sum is exact in int32: |plane - zp| <= 255 and |w| <= 128, so
|sum| <= 32640 * K < 2^31 for K <= K_BOUND.  Above it the plane route
raises; it never falls back.  The work is two int8 products of the shape,
bound by the int16 read, the int8 weights and the int64 write where the
product is small, by the two products' operations where it is large.

`wide_conv` and `wide_dense` are the wrappers: on a CPU tensor they run the
plain versions (`wide_conv_plain`, `wide_dense_plain`: the float64 sum of
`conv_acc_plain` and `exact_int_matmul`, exact since every partial sum stays
below 2^53), on a CUDA tensor the plane route (`wide_conv_planes`,
`wide_dense_planes`, which on CPU tensors run K4 and K5's plain versions) or
raise.
"""

from __future__ import annotations

import torch

from ._lib import LAUNCHES
from .conv import conv_acc_exact, qconv2d_flat
from .depthwise import dw_acc_plain
from .matmul_int8 import qmatmul_int8

K_BOUND = (2 ** 31 - 1) // (255 * 128)   # 65,793: the deepest exact plane sum
EXACT_F64_K = 2 ** 53 // (2 ** 16 * 128)  # the deepest exact float64 plain sum


def split_planes(x: torch.Tensor, izp: int):
    """((hi, zh), (lo - 128, zl - 128)): the int8 planes of int16 x and the
    zero point of each, x - izp = 256 * (hi - zh) + ((lo - 128) - (zl - 128))."""
    if not -2 ** 15 <= int(izp) < 2 ** 15:
        raise ValueError(f"input zero point {izp} is not an int16 value")
    zh, zl = int(izp) >> 8, (int(izp) & 255) - 128
    hi = (x >> 8).to(torch.int8)
    lo = ((x & 255) - 128).to(torch.int8)
    return (hi, zh), (lo, zl)


def _combine(plane_fn, x: torch.Tensor, izp: int) -> torch.Tensor:
    """plane_fn(int8 plane, zero point) -> int32 accumulator, run once for
    int8 x and on both planes of int16 x, combined in int64."""
    if x.dtype == torch.int8:
        return plane_fn(x, int(izp)).to(torch.int64)
    if x.dtype != torch.int16:
        raise NotImplementedError(f"W8A16 product of {x.dtype} data: int8 or int16 only")
    (hi, zh), (lo, zl) = split_planes(x, izp)
    return plane_fn(hi, zh).to(torch.int64) * 256 + plane_fn(lo, zl).to(torch.int64)


def _check_depth(k: int, bound: int, what: str) -> None:
    if k > bound:
        raise ValueError(f"{what}: K {k} is above {bound}, where the sum stops being exact")


def _is_depthwise(x_shape, w_shape, groups: int) -> bool:
    cin = x_shape[-1]
    depthwise = groups > 1 and groups == cin and w_shape[2] == 1 and w_shape[3] == cin
    if groups != 1 and not depthwise:
        raise NotImplementedError(
            f"W8A16 conv: groups {groups} with weight {tuple(w_shape)}: only groups 1 and "
            "depthwise (groups == CIN == COUT) are ported (ROADMAP Queue 1 item 2)")
    return depthwise


def wide_conv_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
                    izp=0) -> torch.Tensor:
    """Plain PyTorch version: sum (x_pad - izp) * w in int64, the border
    padded by izp; x int8 or int16 NHWC, w int8 HWIO."""
    kh, kw, cin_g, _ = w.shape
    if _is_depthwise(x.shape, w.shape, groups):
        return dw_acc_plain(x, w, strides, padding, izp)
    _check_depth(kh * kw * cin_g, EXACT_F64_K, "wide_conv_plain")
    return conv_acc_exact(x, w, strides, padding, izp)


def wide_conv_planes(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
                     izp=0) -> torch.Tensor:
    """The plane route: each plane through `qconv2d_flat`'s raw modes (K4's
    GEMM or conv mode, K5's raw mode; their plain versions on CPU tensors)."""
    kh, kw, cin_g, cout = w.shape
    _is_depthwise(x.shape, w.shape, groups)
    _check_depth(kh * kw * cin_g, K_BOUND, "wide_conv_planes")
    strides, padding = tuple(strides), tuple(padding)

    def plane(xp, zp):
        return qconv2d_flat(xp, w, strides=strides, padding=padding, groups=groups,
                            input_zero_point=zp)

    return _combine(plane, x.contiguous(), izp)


def wide_conv(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
              izp=0) -> torch.Tensor:
    """qnn.conv2d with out_dtype int64: x int8 or int16 NHWC, w int8 HWIO
    (groups 1 or depthwise), padding (top, left, bottom, right) -> int64 NHWC."""
    kw = dict(strides=strides, padding=padding, groups=groups, izp=izp)
    if x.device.type == "cpu":
        return wide_conv_plain(x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"wide_conv: no kernel for device {x.device}")
    out = wide_conv_planes(x, w, **kw)
    LAUNCHES["wide_planes"] += 1
    return out


def wide_dense_plain(x, w, *, izp=0) -> torch.Tensor:
    """Plain PyTorch version: (x - izp) @ w in int64 through float64."""
    _check_depth(x.shape[-1], EXACT_F64_K, "wide_dense_plain")
    acc = (x.to(torch.float64) - float(izp)) @ w.to(torch.float64)
    return acc.to(torch.int64)


def wide_dense_planes(x, w, *, izp=0) -> torch.Tensor:
    """The plane route: each plane through K4's GEMM mode (`qmatmul_int8`
    without a multiplier; its plain version on CPU tensors)."""
    _check_depth(x.shape[-1], K_BOUND, "wide_dense_planes")

    def plane(xp, zp):
        return qmatmul_int8(xp, w, input_zero_point=zp)

    return _combine(plane, x.contiguous(), izp)


def wide_dense(x, w, *, izp=0) -> torch.Tensor:
    """qnn.dense with out_dtype int64: x int8 or int16 (M, K), w int8 (K, N)
    -> int64 (M, N)."""
    if x.device.type == "cpu":
        return wide_dense_plain(x, w, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"wide_dense: no kernel for device {x.device}")
    out = wide_dense_planes(x, w, izp=izp)
    LAUNCHES["wide_planes"] += 1
    return out
