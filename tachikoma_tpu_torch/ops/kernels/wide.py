"""The W8A16 products on the card: qnn.conv2d, qnn.dense and
qnn.batch_matmul with an int64 accumulator, int16 data minus its zero point
times int8 weights, or int16 times int16 (the attention's products).

No Pallas kernel: the JAX package runs these products on XLA with an int64
accumulator (`tachikoma_tpu/ops/jax_ops.py` `_qconv2d_jax`, `_qdense_jax`
and `_qbmm_jax`), and PyTorch has no int64 convolution or matmul on CUDA.
The port runs them on kernels of their own:

  * `qgemm_wide` wraps `csrc/qconv_wide_hopper.cu tk_qgemm_wide`: a dense
    layer, or a 1x1 stride-1 unpadded conv as the (N*H*W, CIN) matrix it is;
  * `qconv_wide` wraps `tk_qconv_wide`, the same kernel: any other conv, an
    implicit GEMM over the NHWC image at any stride, padding and dilation; a
    grouped conv runs a super-group of `group_span` groups as one dense conv
    on block-diagonal weights packed once (`conv.grouped_weights`), as K2
    and K4 do;
  * `qdwconv_wide` wraps `csrc/qdwconv.cu tk_qdwconv_wide`: the depthwise
    conv (groups == CIN == COUT), K5's body in its int16 mode, at any
    dilation;
  * `qbmm_wide` wraps `csrc/qbmm_wide_hopper.cu tk_qbmm_wide`: the batched
    product of two int16 operands, each read in place through its strides.

The first two compute sum x w = 256 sum hi w + sum lo w over the int16
operand's two byte planes (hi = x >> 8 signed, lo = x & 255 unsigned) in one
`wgmma` pass against one staged weight tile, two int32 sums a column; taps
outside the image read izp, and the epilogue combines the sums in int64 and
takes izp * colsum(w) off, the weight's int64 column sum made once per
weight tensor (`colsum_once`, beside K4's K-major packing `kmajor_weights`).
Each plane's sum is exact in int32 for K <= K_BOUND (|lo w| <= 255 * 128);
above it the wrappers raise.  `wide_plan` picks the tile and, where the
tiles leave the card idle, a split of K whose partial sums add into a zeroed
output with 64-bit integer atomics.  The depthwise conv needs no planes:
each term (x - izp) w is below 2^23, so up to DW_TAP_BOUND taps sum exactly
in int32.  `qbmm_wide` splits both operands: sum a b = 65536 sum ha hb +
256 sum (ha lb + la hb) + sum la lb, four `wgmma` products into three int32
sums, exact for K <= BMM_K_BOUND (the middle sum's two terms a k reach 2 *
128 * 255); a zero point other than 0 comes off in int64 through the
operands' row and column sums.

`wide_conv`, `wide_dense` and `qbmm_wide` are the entries of qnn.conv2d /
qnn.dense / qnn.batch_matmul into int64 (`ops/qnn.py`): on a CPU tensor they
run the plain versions (`wide_conv_plain`, `wide_dense_plain`,
`qbmm_wide_plain`: the float64 sums of `conv_acc_exact` and of float64
matmuls, exact since every partial sum stays below 2^53); on a CUDA tensor, int16 data launches the kernels above, and int8
conv and dense data (which `ops/qnn.py _check_raw_operands` admits into
int64 too) runs K4 / K5's raw modes (`qconv2d_flat`, `qmatmul_int8`) with
their int32 sums cast to int64.  There is no fallback: a build or launch
failure raises.

`wide_conv_model`, `wide_dense_model` and `qbmm_wide_model` are a CPU
model of the kernels' arithmetic (the izp fill, the s8 / u8 planes, the
int32 sums checked in range, the int64 combine, izp * colsum taken off; K5's
int16 sum checked in int32), which the tests hold against the JAX package's
oracle.  The main path never calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn import conv2d_out_hw
from ._lib import LAUNCHES, check_cuda_operands, launch, pack_once, refuse_uint8, sm_count
from .conv import conv_acc_exact, group_span, grouped_weights, qconv2d_flat
from .depthwise import dw_acc_plain, dw_launch
from .matmul_int8 import (KSTEP, _logical, _merge_batch, kmajor_weights, qmatmul_int8,
                          split_covers)

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
K_BOUND = I32_MAX // (255 * 128)         # 65,793: the deepest exact lo-plane sum
DW_TAP_BOUND = I32_MAX // (65535 * 128)  # 256: the most taps of an exact int16 depthwise sum
EXACT_F64_K = 2 ** 53 // (2 ** 16 * 128)  # the deepest exact float64 plain sum
# qbmm_wide: the deepest exact middle sum (ha lb + la hb: 2 * 128 * 255 a k),
# and the deepest exact float64 plain sum of int16 x int16 (each product of
# two values less their int16 zero points is below 2^32)
BMM_K_BOUND = I32_MAX // (2 * 128 * 255)  # 32,896
EXACT_F64_BMM_K = 2 ** 21

# csrc/qconv_wide_hopper.cu: the tiles (BM, BN) it is built at; a call of at
# most WIDE_UNSPLIT_STEPS K steps runs unsplit, a split walks at least
# WIDE_SPLIT_STEPS of them
WIDE_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
WIDE_UNSPLIT_STEPS = 4
WIDE_SPLIT_STEPS = 2
GROUPED_BN = 64  # the N tile of a grouped qconv_wide call: fewer zero products a super-group
# csrc/qbmm_wide_hopper.cu: how an operand's (row, 4 k) units are staged
# ("kmajor8": k contiguous, one 8-byte load a unit; "kmajor": k contiguous,
# element loads; "rows": rows contiguous, element loads, a warp on 32 rows)
BMM_WIDE_STAGES = {"kmajor8": 0, "kmajor": 1, "rows": 2}
_COLSUM: dict = {}


def _check_zero_point(kernel: str, izp: int) -> None:
    if not -2 ** 15 <= int(izp) < 2 ** 15:
        raise ValueError(f"{kernel}: input zero point {izp} is not an int16 value")


def _check_depth(k: int, bound: int, what: str) -> None:
    if k > bound:
        raise ValueError(f"{what}: K {k} is above {bound}, where the sum stops being exact")


def _is_depthwise(x_shape, w_shape, groups: int) -> bool:
    """Whether a conv is depthwise with one output channel an input channel
    (K5's int16 mode); any other grouped conv runs on `qconv_wide`."""
    cin = x_shape[-1]
    return groups > 1 and groups == cin and w_shape[2] == 1 and w_shape[3] == cin


def colsum_once(w: torch.Tensor) -> torch.Tensor:
    """The int64 column sums of w (..., COUT) over all its other dimensions,
    made once per weight tensor (`pack_once`)."""
    return pack_once(_COLSUM, w,
                     lambda w: w.to(torch.int64).reshape(-1, w.shape[-1]).sum(dim=0))


def wide_plan(m: int, k: int, cout: int, sms: int = 132, bn: int | None = None) -> dict:
    """{"bm", "bn", "ks", "kper"}: the tile and split of K of an (M, K) x (K,
    COUT) product on a card of `sms` SMs.  128 columns where COUT is wider
    than 64 and 128 rows where those tiles fill the card twice; where the
    tiles leave SMs idle, 64 columns and, above WIDE_UNSPLIT_STEPS steps, K
    split into at least WIDE_SPLIT_STEPS steps a split, up to two blocks an
    SM.  `bn`, where given, fixes the columns (a grouped conv's N tile).
    Split z walks steps [z kper, min((z + 1) kper, steps))."""
    steps = -(-k // KSTEP)

    def tiles(bm, bn):
        return -(-m // bm) * -(-cout // bn)

    fixed = bn is not None
    bn = bn if fixed else 128 if cout > 64 else 64
    bm = 128 if tiles(128, bn) >= 2 * sms else 64
    if tiles(bm, bn) < sms and not fixed:
        bn = 64
    t = tiles(bm, bn)
    if t >= sms or steps <= WIDE_UNSPLIT_STEPS:
        return dict(bm=bm, bn=bn, ks=1, kper=steps)
    ks = min(-(-steps // WIDE_SPLIT_STEPS), max(1, 2 * sms // t))
    kper = -(-steps // ks)
    return dict(bm=bm, bn=bn, ks=-(-steps // kper), kper=kper)


def wide_plans(k: int) -> list[dict]:
    """Every launch the kernel takes for a product of depth k: each tile, at
    the splits 1, 2, 4, 8 and 16 that cover K with every split non-empty."""
    steps = -(-k // KSTEP)
    out = []
    for bm, bn in WIDE_TILES:
        for want in (1, 2, 4, 8, 16):
            kper = -(-steps // want)
            ks = -(-steps // kper)
            plan = dict(bm=bm, bn=bn, ks=ks, kper=kper)
            if ks == want and plan not in out:
                out.append(plan)
    return out


def _launch_wide(kernel: str, x: torch.Tensor, wk: torch.Tensor, cs: torch.Tensor, out_shape,
                 geometry, izp: int, plan) -> torch.Tensor:
    """Launch tk_<kernel> (`csrc/qconv_wide_hopper.cu`) on int16 x, the
    weight `wk` packed K-major (K = KH * KW * the super-group's channels)
    and its column sums `cs`, into int64 `out_shape`; `geometry` as
    `_lib.PARAMS` names it (`cspan`: a super-group's input channels, 0 for
    a dense conv)."""
    k = geometry["kh"] * geometry["kw"] * (geometry.get("cspan") or geometry["cin"])
    cout = geometry["cout"]
    _check_zero_point(kernel, izp)
    _check_depth(k, K_BOUND, kernel)
    check_cuda_operands(kernel, x.device, x=(x, torch.int16, tuple(x.shape)),
                        wk=(wk, torch.int8, (-(-k // KSTEP), cout, KSTEP)),
                        colsum=(cs, torch.int64, (cout,)))
    m = out_shape[0] * geometry["oh"] * geometry["ow"]
    if plan is None:
        plan = wide_plan(m, k, cout, sm_count(x.device.index),
                         GROUPED_BN if geometry.get("cspan") else None)
    if (plan["bm"], plan["bn"]) not in WIDE_TILES:
        raise ValueError(f"{kernel}: tile {plan['bm']}x{plan['bn']} is not built: {WIDE_TILES}")
    nspan = cout * geometry["cspan"] // geometry["cin"] if geometry.get("cspan") else cout
    if nspan != cout and nspan % plan["bn"]:
        raise ValueError(f"{kernel}: a super-group's {nspan} columns are not whole "
                         f"{plan['bn']}-column tiles")
    if not split_covers(plan["ks"], plan["kper"], -(-k // KSTEP)):
        raise ValueError(f"{kernel}: split {plan['ks']} x {plan['kper']} does not cover K {k}")
    a_vec = (geometry.get("cspan") or geometry["cin"]) % 8 == 0 and geometry["cin"] % 8 == 0
    # a split adds its partial sums into zeros
    out = (torch.zeros if plan["ks"] > 1 else torch.empty)(out_shape, dtype=torch.int64,
                                                           device=x.device)
    launch(f"tk_{kernel}", [x, wk, out, cs],
           dict(geometry, izp=izp, a_vec=a_vec and x.data_ptr() % 16 == 0,
                bm=plan["bm"], bn=plan["bn"], ks=plan["ks"], kper=plan["kper"]))
    LAUNCHES[kernel] += 1
    return out


def qgemm_wide_plain(x, w, *, izp=0, plan=None, w_src=None) -> torch.Tensor:
    """Plain PyTorch version of `qgemm_wide` (`plan` and `w_src` are the
    kernel's launch and weight cache: no effect)."""
    return wide_dense_plain(x, w, izp=izp)


def qgemm_wide(x, w, *, izp=0, plan: dict | None = None,
               w_src: torch.Tensor | None = None) -> torch.Tensor:
    """(x - izp) @ w in int64: x int16 (M, K), w int8 (K, N) -> int64 (M, N).
    `plan` as `wide_plan` gives it; `w_src` the stable tensor whose packing
    and column sums stand for w (a 1x1 conv's 4-D weight)."""
    refuse_uint8("qgemm_wide", x, w)
    if x.device.type == "cpu":
        return qgemm_wide_plain(x, w, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"qgemm_wide: no kernel for device {x.device}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"qgemm_wide: bad geometry {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    src = w if w_src is None else w_src
    check_cuda_operands("qgemm_wide", x.device, w=(w, torch.int8, tuple(w.shape)))
    geometry = dict(n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=w.shape[1], oh=1, ow=1, sh=1, sw=1)
    return _launch_wide("qgemm_wide", x, kmajor_weights(src), colsum_once(src),
                        (m, w.shape[1]), geometry, izp, plan)


def qconv_wide_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0, dilation=(1, 1),
                     groups=1, plan=None) -> torch.Tensor:
    """Plain PyTorch version of `qconv_wide` (`plan`: no effect)."""
    return wide_conv_plain(x, w, strides=strides, padding=padding, izp=izp, dilation=dilation,
                           groups=groups)


def qconv_wide(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0, dilation=(1, 1),
               groups=1, plan: dict | None = None) -> torch.Tensor:
    """sum (x_pad - izp) * w in int64, the border padded by izp: x int16 NHWC,
    w int8 (KH, KW, CIN / groups, COUT), padding (top, left, bottom, right),
    dilation (dh, dw) -> int64 NHWC.  A grouped conv runs a super-group of
    `group_span` groups at the GROUPED_BN-column tile as one dense conv on
    block-diagonal weights."""
    refuse_uint8("qconv_wide", x, w)
    dilation = tuple(int(d) for d in dilation)
    if x.device.type == "cpu":
        return qconv_wide_plain(x, w, strides=strides, padding=padding, izp=izp,
                                dilation=dilation, groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_wide: no kernel for device {x.device}")
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    oh, ow = conv2d_out_hw(h, wd, kh, kw, strides, padding, dilation)
    if groups < 1 or cin_g * groups != cin or cout % groups or min(oh, ow) <= 0:
        raise ValueError(f"qconv_wide: bad geometry {tuple(x.shape)} * {tuple(w.shape)} "
                         f"groups {groups}")
    check_cuda_operands("qconv_wide", x.device, w=(w, torch.int8, tuple(w.shape)))
    geometry = dict(n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=oh, ow=ow,
                    sh=strides[0], sw=strides[1], pt=padding[0], pl=padding[1],
                    dh=dilation[0], dw=dilation[1])
    if groups == 1:
        wk = kmajor_weights(w)
    else:
        span = group_span(groups, cout // groups, GROUPED_BN)
        wk = grouped_weights(w, groups, span)
        geometry["cspan"] = span * cin_g
    return _launch_wide("qconv_wide", x, wk, colsum_once(w), (n, oh, ow, cout), geometry, izp,
                        plan)


def qdwconv_wide_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
                       dilation=(1, 1)) -> torch.Tensor:
    """Plain PyTorch version of `qdwconv_wide`."""
    return dw_acc_plain(x, w, strides, padding, izp, tuple(dilation))


def qdwconv_wide(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
                 dilation=(1, 1)) -> torch.Tensor:
    """The depthwise sum (x_pad - izp) * w in int64: x int16 NHWC, w int8
    (KH, KW, 1, C), at most DW_TAP_BOUND taps, at the dilation (dh, dw) ->
    int64 NHWC."""
    refuse_uint8("qdwconv_wide", x, w)
    if x.device.type == "cpu":
        return qdwconv_wide_plain(x, w, strides=strides, padding=padding, izp=izp,
                                  dilation=dilation)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_wide: no kernel for device {x.device}")
    _check_zero_point("qdwconv_wide", izp)
    _check_depth(w.shape[0] * w.shape[1], DW_TAP_BOUND, "qdwconv_wide taps")
    return dw_launch("qdwconv_wide", x, w, torch.int64, {}, strides, padding, izp,
                     tuple(dilation))


def wide_conv_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
                    izp=0, dilation=(1, 1)) -> torch.Tensor:
    """Plain PyTorch version: sum (x_pad - izp) * w in int64, the border
    padded by izp; x int8 or int16 NHWC, w int8 (KH, KW, CIN / groups,
    COUT), at any dilation and groups."""
    kh, kw, cin_g, _ = w.shape
    if _is_depthwise(x.shape, w.shape, groups):
        return dw_acc_plain(x, w, strides, padding, izp, tuple(dilation))
    _check_depth(kh * kw * cin_g, EXACT_F64_K, "wide_conv_plain")
    return conv_acc_exact(x, w, strides, padding, izp, tuple(dilation), groups)


def wide_conv(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
              izp=0, dilation=(1, 1)) -> torch.Tensor:
    """qnn.conv2d with out_dtype int64: x int8 or int16 NHWC, w int8 (KH,
    KW, CIN / groups, COUT), padding (top, left, bottom, right), dilation
    (dh, dw) -> int64 NHWC.  int16 on the card: a depthwise conv on
    `qdwconv_wide`, a dense 1x1 stride-1 unpadded conv on `qgemm_wide`, any
    other (dilated, grouped) on `qconv_wide`."""
    strides, padding = tuple(strides), tuple(padding)
    # a 1x1 conv's dilation is a no-op
    dilation = (1, 1) if w.shape[0] * w.shape[1] == 1 else tuple(int(d) for d in dilation)
    if x.device.type == "cpu":
        return wide_conv_plain(x, w, strides=strides, padding=padding, groups=groups, izp=izp,
                               dilation=dilation)
    if x.device.type != "cuda":
        raise ValueError(f"wide_conv: no kernel for device {x.device}")
    x = x.contiguous()
    if x.dtype == torch.int8:
        return qconv2d_flat(x, w, strides=strides, padding=padding, groups=groups,
                            dilation=dilation, input_zero_point=izp).to(torch.int64)
    if x.dtype != torch.int16:
        raise NotImplementedError(f"W8A16 product of {x.dtype} data: int8 or int16 only")
    if _is_depthwise(x.shape, w.shape, groups):
        return qdwconv_wide(x, w, strides=strides, padding=padding, izp=izp, dilation=dilation)
    n, h, wd, cin = x.shape
    if w.shape[:2] == (1, 1) and strides == (1, 1) and not any(padding) and groups == 1:
        out = qgemm_wide(x.reshape(n * h * wd, cin), w.reshape(cin, w.shape[3]), izp=izp,
                         w_src=w)
        return out.reshape(n, h, wd, w.shape[3])
    return qconv_wide(x, w, strides=strides, padding=padding, izp=izp, dilation=dilation,
                      groups=groups)


def wide_dense_plain(x, w, *, izp=0) -> torch.Tensor:
    """Plain PyTorch version: (x - izp) @ w in int64 through float64."""
    _check_depth(x.shape[-1], EXACT_F64_K, "wide_dense_plain")
    acc = (x.to(torch.float64) - float(izp)) @ w.to(torch.float64)
    return acc.to(torch.int64)


def wide_dense(x, w, *, izp=0) -> torch.Tensor:
    """qnn.dense with out_dtype int64: x int8 or int16 (M, K), w int8 (K, N)
    -> int64 (M, N); int16 on the card on `qgemm_wide`."""
    if x.device.type == "cpu":
        return wide_dense_plain(x, w, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"wide_dense: no kernel for device {x.device}")
    x = x.contiguous()
    if x.dtype == torch.int8:
        return qmatmul_int8(x, w, input_zero_point=izp).to(torch.int64)
    if x.dtype != torch.int16:
        raise NotImplementedError(f"W8A16 product of {x.dtype} data: int8 or int16 only")
    return qgemm_wide(x, w, izp=izp)


# ---------------------------------------------------------------------------
# the batched product (qnn.batch_matmul into int64)
# ---------------------------------------------------------------------------

_BMM_DTYPES = (torch.int8, torch.uint8, torch.int16)


def _check_bmm_operands(name: str, a: torch.Tensor, b: torch.Tensor, za: int, zb: int) -> None:
    for key, t in (("a", a), ("b", b)):
        if t.dtype not in _BMM_DTYPES:
            raise NotImplementedError(f"{name}: {key} is {t.dtype}; int8, uint8 or int16 only")
    _check_zero_point(name, za)
    _check_zero_point(name, zb)


def qbmm_wide_plain(a, b, *, lhs_zero_point=0, rhs_zero_point=0, transpose_a=False,
                    transpose_b=False) -> torch.Tensor:
    """Plain PyTorch version of `qbmm_wide`: (a - za) @ (b - zb) in int64
    over int8, uint8 or int16 operands and int16 zero points, the last two
    axes transposed as asked and the leading axes broadcast, through
    float64: each product is below 2^32, so every partial sum is an exact
    integer below 2^53 for K < EXACT_F64_BMM_K."""
    _check_bmm_operands("qbmm_wide_plain", a, b, lhs_zero_point, rhs_zero_point)
    _check_depth(a.shape[-2] if transpose_a else a.shape[-1], EXACT_F64_BMM_K - 1,
                 "qbmm_wide_plain")
    x, y = _logical(a.to(torch.float64) - int(lhs_zero_point),
                    b.to(torch.float64) - int(rhs_zero_point), transpose_a, transpose_b)
    return torch.matmul(x, y).to(torch.int64)


def _wide_stage(t: torch.Tensor, sr: int, sk: int, sbs) -> str:
    """How the kernel stages an operand whose element (r, k) sits at r sr + k
    sk (`BMM_WIDE_STAGES`): one 8-byte load a unit of 4 k where k is
    contiguous and every unit starts 8-byte aligned, element loads along k
    where k is contiguous otherwise (ViT's 197-element rows), element loads
    across rows otherwise (v, its rows contiguous; any other strides too)."""
    if sk == 1:
        aligned = t.data_ptr() % 8 == 0 and all(s % 4 == 0 for s in (sr, *sbs))
        return "kmajor8" if aligned else "kmajor"
    return "rows"


def _bmm_wide_launch(a: torch.Tensor, b: torch.Tensor, za: int, zb: int, transpose_a: bool,
                     transpose_b: bool):
    """The operands (int16, widened where int8 or uint8) and parameters of a
    `qbmm_wide` launch: the batch axes broadcast and merged into at most two
    (the operands copied as they are laid out where more remain), each
    operand's strides and staging mode.  Returns (output shape, A, B,
    parameters)."""
    a = a if a.dtype == torch.int16 else a.to(torch.int16)
    b = b if b.dtype == torch.int16 else b.to(torch.int16)
    A, B = _logical(a, b, transpose_a, transpose_b)
    m, k = A.shape[-2:]
    if B.shape[-2] != k:
        raise ValueError(f"qbmm_wide: K mismatch {tuple(A.shape)} x {tuple(B.shape)}")
    _check_depth(k, BMM_K_BOUND, "qbmm_wide")
    n = B.shape[-1]
    batch = tuple(np.broadcast_shapes(tuple(A.shape[:-2]), tuple(B.shape[:-2])))
    A, B = A.expand(batch + (m, k)), B.expand(batch + (k, n))
    nb = int(np.prod(batch)) if batch else 1
    if nb > 65535:
        raise ValueError(f"qbmm_wide: {nb} products, the kernel takes at most 65535")
    dims = _merge_batch(batch, A.stride()[:-2], B.stride()[:-2])
    if dims is None:  # the operands copied as they are laid out, broadcast
        A, B = _logical(a.expand(batch + tuple(a.shape[-2:])).contiguous(),
                        b.expand(batch + tuple(b.shape[-2:])).contiguous(),
                        transpose_a, transpose_b)
        dims = _merge_batch(batch, A.stride()[:-2], B.stride()[:-2])
    (n0, a0, b0), (n1, a1, b1) = dims
    a_sm, a_sk = A.stride()[-2:]
    b_sk, b_sn = B.stride()[-2:]
    strides = dict(a_sb0=a0, a_sb1=a1, a_sm=a_sm, a_sk=a_sk, b_sb0=b0, b_sb1=b1, b_sn=b_sn,
                   b_sk=b_sk)
    if any(abs(v) >= 1 << 31 for v in strides.values()):
        raise ValueError(f"qbmm_wide: strides {strides} do not fit the kernel's int32 "
                         "parameters")
    modes = dict(a_mode=BMM_WIDE_STAGES[_wide_stage(A, a_sm, a_sk, (a0, a1))],
                 b_mode=BMM_WIDE_STAGES[_wide_stage(B, b_sn, b_sk, (b0, b1))])
    params = dict(n=m, cin=k, cout=n, bmm_nb=n0 * n1, bmm_nb1=n1, bmm_za=za, bmm_zb=zb,
                  **modes, **strides)
    return batch + (m, n), A, B, params


def bmm_wide_summary(a: torch.Tensor, b: torch.Tensor, *, lhs_zero_point: int = 0,
                     rhs_zero_point: int = 0, transpose_a: bool = False,
                     transpose_b: bool = False) -> str:
    """The launch of one `qbmm_wide` call: its products and each operand's
    staging mode."""
    _, _, _, p = _bmm_wide_launch(a, b, int(lhs_zero_point), int(rhs_zero_point), transpose_a,
                                  transpose_b)
    stages = {v: key for key, v in BMM_WIDE_STAGES.items()}
    return f"{p['bmm_nb']} products, A {stages[p['a_mode']]}, B {stages[p['b_mode']]}"


def qbmm_wide(a: torch.Tensor, b: torch.Tensor, *, lhs_zero_point: int = 0,
              rhs_zero_point: int = 0, transpose_a: bool = False,
              transpose_b: bool = False) -> torch.Tensor:
    """qnn.batch_matmul into int64: (a - za) @ (b - zb) -> int64 (batch...,
    M, N), the products batched over the broadcast leading axes, int16
    operands read in place through their strides (a head-split view, `v`
    N-major), K at most BMM_K_BOUND, int16 zero points.  An int8 or uint8
    operand is widened to int16 by this wrapper first (one copy)."""
    za, zb = int(lhs_zero_point), int(rhs_zero_point)
    _check_bmm_operands("qbmm_wide", a, b, za, zb)
    if a.device.type == "cpu":
        return qbmm_wide_plain(a, b, lhs_zero_point=za, rhs_zero_point=zb,
                               transpose_a=transpose_a, transpose_b=transpose_b)
    if a.device.type != "cuda":
        raise ValueError(f"qbmm_wide: no kernel for device {a.device}")
    if b.device != a.device:
        raise ValueError(f"qbmm_wide: b is on {b.device}, expected {a.device}")
    shape, A, B, params = _bmm_wide_launch(a, b, za, zb, transpose_a, transpose_b)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    launch("tk_qbmm_wide", [A, B, out], params)
    LAUNCHES["qbmm_wide"] += 1
    return out


# ---------------------------------------------------------------------------
# the CPU model of the kernels' arithmetic (tests only)
# ---------------------------------------------------------------------------

def byte_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of int16 x as int64: hi = x >> 8 in [-128, 127] (read .s8),
    lo = x & 255 in [0, 255] (read .u8); x = 256 hi + lo."""
    xi = x.to(torch.int64)
    return xi >> 8, xi & 255


def _in_int32(acc: torch.Tensor, what: str) -> torch.Tensor:
    if acc.numel() and (int(acc.min()) < I32_MIN or int(acc.max()) > I32_MAX):
        raise OverflowError(f"{what}: a sum leaves int32")
    return acc


def plane_product(cols: torch.Tensor, w: torch.Tensor, izp: int) -> torch.Tensor:
    """The kernel's product of the rows `cols` (M, K) (int16 values, taps
    outside the image already izp) and w (K, N): the hi and lo planes'
    int32 sums, each checked in range, combined as 256 hi + lo - izp
    colsum(w) in int64."""
    hi, lo = byte_planes(cols)
    wi = w.to(torch.int64)
    acc_hi = _in_int32(hi @ wi, "the hi plane")
    acc_lo = _in_int32(lo @ wi, "the lo plane")
    return 256 * acc_hi + acc_lo - int(izp) * wi.sum(dim=0)


def wide_dense_model(x, w, *, izp=0) -> torch.Tensor:
    """`qgemm_wide`'s arithmetic on the CPU: int16 x (M, K), w int8 (K, N)."""
    _check_zero_point("wide_dense_model", izp)
    _check_depth(x.shape[-1], K_BOUND, "wide_dense_model")
    return plane_product(x, w, izp)


def wide_conv_model(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
                    izp=0, dilation=(1, 1)) -> torch.Tensor:
    """The kernels' arithmetic of `wide_conv` on int16 x: the border filled
    with izp, then `qconv_wide`'s planes a group at a time (a 1x1 conv's
    too; a dilated tap at its offset) or, for a depthwise conv, K5's int16
    mode (sum x w - izp sum w, exact in int32 up to DW_TAP_BOUND taps)."""
    _check_zero_point("wide_conv_model", izp)
    kh, kw, cin_g, cout = w.shape
    sh, sw = strides
    dh, dw = dilation
    pt, pl, pb, pr = padding
    oh, ow = conv2d_out_hw(x.shape[1], x.shape[2], kh, kw, strides, padding, dilation)
    xp = torch.nn.functional.pad(x.to(torch.int64), (0, 0, pl, pr, pt, pb), value=int(izp))
    taps = [xp[:, i * dh:i * dh + sh * (oh - 1) + 1:sh, j * dw:j * dw + sw * (ow - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    if _is_depthwise(x.shape, w.shape, groups):
        _check_depth(kh * kw, DW_TAP_BOUND, "wide_conv_model taps")
        wi = w.to(torch.int64).reshape(kh * kw, cout)
        acc = sum(t * wi[i] for i, t in enumerate(taps))
        return _in_int32(acc - int(izp) * wi.sum(dim=0), "the depthwise sum")
    _check_depth(kh * kw * cin_g, K_BOUND, "wide_conv_model")
    n, cout_g = x.shape[0], cout // groups
    cols = torch.stack(taps, dim=3)                          # (n, oh, ow, taps, cin)
    out = []
    for g in range(groups):
        c = cols[..., g * cin_g:(g + 1) * cin_g].reshape(n * oh * ow, kh * kw * cin_g)
        wg = w[..., g * cout_g:(g + 1) * cout_g].reshape(kh * kw * cin_g, cout_g)
        out.append(plane_product(c, wg, izp))
    return torch.cat(out, dim=1).reshape(n, oh, ow, cout)


def qbmm_wide_model(a, b, *, lhs_zero_point=0, rhs_zero_point=0, transpose_a=False,
                    transpose_b=False) -> torch.Tensor:
    """`qbmm_wide`'s arithmetic on the CPU: both int16 operands split into
    byte planes, the three int32 sums (hi hi, hi lo + lo hi, lo lo) checked
    in range, combined as 65536 hh + 256 mid + ll in int64, then the zero
    points folded: - za colsum(B) - zb rowsum(A) + K za zb (the row and
    column sums checked in int32, as the kernel keeps them)."""
    za, zb = int(lhs_zero_point), int(rhs_zero_point)
    _check_bmm_operands("qbmm_wide_model", a, b, za, zb)
    A, B = _logical(a.to(torch.int64), b.to(torch.int64), transpose_a, transpose_b)
    k = A.shape[-1]
    _check_depth(k, BMM_K_BOUND, "qbmm_wide_model")
    (ha, la), (hb, lb) = byte_planes(A), byte_planes(B)
    hh = _in_int32(ha @ hb, "the hi x hi sum")
    mid = _in_int32(ha @ lb + la @ hb, "the middle sum")
    ll = _in_int32(la @ lb, "the lo x lo sum")
    acc = 65536 * hh + 256 * mid + ll
    rows = _in_int32(A.sum(dim=-1, keepdim=True), "a row sum")
    cols = _in_int32(B.sum(dim=-2, keepdim=True), "a column sum")
    return acc - za * cols - zb * rows + k * za * zb
