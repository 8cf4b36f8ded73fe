"""The W8A16 products on the card: qnn.conv2d and qnn.dense with an int64
accumulator, int16 data minus its zero point times int8 weights.

No Pallas kernel: the JAX package runs these products on XLA with an int64
accumulator (`tachikoma_tpu/ops/jax_ops.py` `_qconv2d_jax` and
`_qdense_jax`), and PyTorch has no int64 convolution or matmul on CUDA.  The
port runs them on kernels of their own:

  * `qgemm_wide` wraps `csrc/qconv_wide_hopper.cu tk_qgemm_wide`: a dense
    layer, or a 1x1 stride-1 unpadded conv as the (N*H*W, CIN) matrix it is;
  * `qconv_wide` wraps `tk_qconv_wide`, the same kernel: any other conv of
    groups 1, an implicit GEMM over the NHWC image at any stride and padding;
  * `qdwconv_wide` wraps `csrc/qdwconv.cu tk_qdwconv_wide`: the depthwise
    conv (groups == CIN == COUT), K5's body in its int16 mode.

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
in int32.

`wide_conv` and `wide_dense` are the entries of qnn.conv2d / qnn.dense into
int64 (`ops/qnn.py`): on a CPU tensor they run the plain versions
(`wide_conv_plain`, `wide_dense_plain`: the float64 sum of `conv_acc_exact`
and of a float64 matmul, exact since every partial sum stays below 2^53); on
a CUDA tensor, int16 data launches the kernels above, and int8 data (which
`ops/qnn.py _check_raw_operands` admits into int64 too) runs K4 / K5's raw
modes (`qconv2d_flat`, `qmatmul_int8`) with their int32 sums cast to int64.
There is no fallback: a build or launch failure raises.

`wide_conv_model` / `wide_dense_model` are a CPU model of the kernels'
arithmetic (the izp fill, the s8 / u8 planes, the two int32 sums checked in
range, the int64 combine, izp * colsum taken off; K5's int16 sum checked in
int32), which the tests hold against the JAX package's oracle.  The main
path never calls them.
"""

from __future__ import annotations

import torch

from ..nn import conv2d_out_hw
from ._lib import LAUNCHES, check_cuda_operands, launch, pack_once, refuse_uint8, sm_count
from .conv import conv_acc_exact, qconv2d_flat
from .depthwise import dw_acc_plain, dw_launch
from .matmul_int8 import KSTEP, kmajor_weights, qmatmul_int8, split_covers

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
K_BOUND = I32_MAX // (255 * 128)         # 65,793: the deepest exact lo-plane sum
DW_TAP_BOUND = I32_MAX // (65535 * 128)  # 256: the most taps of an exact int16 depthwise sum
EXACT_F64_K = 2 ** 53 // (2 ** 16 * 128)  # the deepest exact float64 plain sum

# csrc/qconv_wide_hopper.cu: the tiles (BM, BN) it is built at; a call of at
# most WIDE_UNSPLIT_STEPS K steps runs unsplit, a split walks at least
# WIDE_SPLIT_STEPS of them
WIDE_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
WIDE_UNSPLIT_STEPS = 4
WIDE_SPLIT_STEPS = 2
_COLSUM: dict = {}


def _check_zero_point(kernel: str, izp: int) -> None:
    if not -2 ** 15 <= int(izp) < 2 ** 15:
        raise ValueError(f"{kernel}: input zero point {izp} is not an int16 value")


def _check_depth(k: int, bound: int, what: str) -> None:
    if k > bound:
        raise ValueError(f"{what}: K {k} is above {bound}, where the sum stops being exact")


def _is_depthwise(x_shape, w_shape, groups: int) -> bool:
    cin = x_shape[-1]
    depthwise = groups > 1 and groups == cin and w_shape[2] == 1 and w_shape[3] == cin
    if groups != 1 and not depthwise:
        raise NotImplementedError(
            f"W8A16 conv: groups {groups} with weight {tuple(w_shape)}: only groups 1 and "
            f"depthwise (groups == CIN == COUT) are ported ({WIDE_ITEM})")
    return depthwise


WIDE_ITEM = "ROADMAP Queue 1 item 2: qconv_wide / qdwconv_wide with dilation and groups"


def _check_undilated(dilation) -> None:
    if tuple(dilation) != (1, 1):
        raise NotImplementedError(f"W8A16 conv: dilation {tuple(dilation)} is not ported "
                                  f"({WIDE_ITEM})")


def colsum_once(w: torch.Tensor) -> torch.Tensor:
    """The int64 column sums of w (..., COUT) over all its other dimensions,
    made once per weight tensor (`pack_once`)."""
    return pack_once(_COLSUM, w,
                     lambda w: w.to(torch.int64).reshape(-1, w.shape[-1]).sum(dim=0))


def wide_plan(m: int, k: int, cout: int, sms: int = 132) -> dict:
    """{"bm", "bn", "ks", "kper"}: the tile and split of K of an (M, K) x (K,
    COUT) product on a card of `sms` SMs.  128 columns where COUT is wider
    than 64 and 128 rows where those tiles fill the card twice; where the
    tiles leave SMs idle, 64 columns and, above WIDE_UNSPLIT_STEPS steps, K
    split into at least WIDE_SPLIT_STEPS steps a split, up to two blocks an
    SM.  Split z walks steps [z kper, min((z + 1) kper, steps))."""
    steps = -(-k // KSTEP)

    def tiles(bm, bn):
        return -(-m // bm) * -(-cout // bn)

    bn = 128 if cout > 64 else 64
    bm = 128 if tiles(128, bn) >= 2 * sms else 64
    if tiles(bm, bn) < sms:
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


def _launch_wide(kernel: str, x: torch.Tensor, w: torch.Tensor, w_src, out_shape, geometry,
                 izp: int, plan) -> torch.Tensor:
    """Launch tk_<kernel> (`csrc/qconv_wide_hopper.cu`) on int16 x, the
    weight packed K-major and its column sums (w_src's where given), into
    int64 `out_shape`; `geometry` as `_lib.PARAMS` names it."""
    k = geometry["kh"] * geometry["kw"] * geometry["cin"]
    cout = geometry["cout"]
    _check_zero_point(kernel, izp)
    _check_depth(k, K_BOUND, kernel)
    src = w if w_src is None else w_src
    wk, cs = kmajor_weights(src), colsum_once(src)
    check_cuda_operands(kernel, x.device, x=(x, torch.int16, tuple(x.shape)),
                        w=(w, torch.int8, tuple(w.shape)),
                        wk=(wk, torch.int8, (-(-k // KSTEP), cout, KSTEP)),
                        colsum=(cs, torch.int64, (cout,)))
    m = out_shape[0] * geometry["oh"] * geometry["ow"]
    if plan is None:
        plan = wide_plan(m, k, cout, sm_count(x.device.index))
    if (plan["bm"], plan["bn"]) not in WIDE_TILES:
        raise ValueError(f"{kernel}: tile {plan['bm']}x{plan['bn']} is not built: {WIDE_TILES}")
    if not split_covers(plan["ks"], plan["kper"], -(-k // KSTEP)):
        raise ValueError(f"{kernel}: split {plan['ks']} x {plan['kper']} does not cover K {k}")
    # a split adds its partial sums into zeros
    out = (torch.zeros if plan["ks"] > 1 else torch.empty)(out_shape, dtype=torch.int64,
                                                           device=x.device)
    launch(f"tk_{kernel}", [x, wk, out, cs],
           dict(geometry, izp=izp, a_vec=geometry["cin"] % 8 == 0 and x.data_ptr() % 16 == 0,
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
    geometry = dict(n=m, h=1, w=1, cin=k, kh=1, kw=1, cout=w.shape[1], oh=1, ow=1, sh=1, sw=1)
    return _launch_wide("qgemm_wide", x, w, w_src, (m, w.shape[1]), geometry, izp, plan)


def qconv_wide_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
                     plan=None) -> torch.Tensor:
    """Plain PyTorch version of `qconv_wide` (`plan`: no effect)."""
    return wide_conv_plain(x, w, strides=strides, padding=padding, izp=izp)


def qconv_wide(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
               plan: dict | None = None) -> torch.Tensor:
    """sum (x_pad - izp) * w in int64, the border padded by izp: x int16 NHWC,
    w int8 HWIO (groups 1), padding (top, left, bottom, right) -> int64 NHWC."""
    refuse_uint8("qconv_wide", x, w)
    if x.device.type == "cpu":
        return qconv_wide_plain(x, w, strides=strides, padding=padding, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_wide: no kernel for device {x.device}")
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = conv2d_out_hw(h, wd, kh, kw, strides, padding, (1, 1))
    if w.shape[2] != cin or min(oh, ow) <= 0:
        raise ValueError(f"qconv_wide: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    geometry = dict(n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=oh, ow=ow,
                    sh=strides[0], sw=strides[1], pt=padding[0], pl=padding[1])
    return _launch_wide("qconv_wide", x, w, None, (n, oh, ow, cout), geometry, izp, plan)


def qdwconv_wide_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0) -> torch.Tensor:
    """Plain PyTorch version of `qdwconv_wide`."""
    return dw_acc_plain(x, w, strides, padding, izp)


def qdwconv_wide(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0) -> torch.Tensor:
    """The depthwise sum (x_pad - izp) * w in int64: x int16 NHWC, w int8
    (KH, KW, 1, C), at most DW_TAP_BOUND taps -> int64 NHWC."""
    refuse_uint8("qdwconv_wide", x, w)
    if x.device.type == "cpu":
        return qdwconv_wide_plain(x, w, strides=strides, padding=padding, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_wide: no kernel for device {x.device}")
    _check_zero_point("qdwconv_wide", izp)
    _check_depth(w.shape[0] * w.shape[1], DW_TAP_BOUND, "qdwconv_wide taps")
    return dw_launch("qdwconv_wide", x, w, torch.int64, {}, strides, padding, izp)


def wide_conv_plain(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
                    izp=0) -> torch.Tensor:
    """Plain PyTorch version: sum (x_pad - izp) * w in int64, the border
    padded by izp; x int8 or int16 NHWC, w int8 HWIO."""
    kh, kw, cin_g, _ = w.shape
    if _is_depthwise(x.shape, w.shape, groups):
        return dw_acc_plain(x, w, strides, padding, izp)
    _check_depth(kh * kw * cin_g, EXACT_F64_K, "wide_conv_plain")
    return conv_acc_exact(x, w, strides, padding, izp)


def wide_conv(x, w, *, strides=(1, 1), padding=(0, 0, 0, 0), groups=1,
              izp=0, dilation=(1, 1)) -> torch.Tensor:
    """qnn.conv2d with out_dtype int64: x int8 or int16 NHWC, w int8 HWIO
    (groups 1 or depthwise, undilated), padding (top, left, bottom, right) ->
    int64 NHWC.  int16 on the card: a depthwise conv on `qdwconv_wide`, a 1x1
    stride-1 unpadded conv on `qgemm_wide`, any other on `qconv_wide`."""
    strides, padding = tuple(strides), tuple(padding)
    if w.shape[0] * w.shape[1] > 1:  # a 1x1 conv's dilation is a no-op
        _check_undilated(dilation)
    if x.device.type == "cpu":
        return wide_conv_plain(x, w, strides=strides, padding=padding, groups=groups, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"wide_conv: no kernel for device {x.device}")
    depthwise = _is_depthwise(x.shape, w.shape, groups)
    x = x.contiguous()
    if x.dtype == torch.int8:
        return qconv2d_flat(x, w, strides=strides, padding=padding, groups=groups,
                            input_zero_point=izp).to(torch.int64)
    if x.dtype != torch.int16:
        raise NotImplementedError(f"W8A16 product of {x.dtype} data: int8 or int16 only")
    if depthwise:
        return qdwconv_wide(x, w, strides=strides, padding=padding, izp=izp)
    n, h, wd, cin = x.shape
    if w.shape[:2] == (1, 1) and strides == (1, 1) and not any(padding):
        out = qgemm_wide(x.reshape(n * h * wd, cin), w.reshape(cin, w.shape[3]), izp=izp,
                         w_src=w)
        return out.reshape(n, h, wd, w.shape[3])
    return qconv_wide(x, w, strides=strides, padding=padding, izp=izp)


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
                    izp=0) -> torch.Tensor:
    """The kernels' arithmetic of `wide_conv` on int16 x: the border filled
    with izp, then `qconv_wide`'s planes (a 1x1 conv's too) or, for a
    depthwise conv, K5's int16 mode (sum x w - izp sum w, exact in int32 up
    to DW_TAP_BOUND taps)."""
    _check_zero_point("wide_conv_model", izp)
    kh, kw, cin_g, cout = w.shape
    sh, sw = strides
    pt, pl, pb, pr = padding
    xp = torch.nn.functional.pad(x.to(torch.int64), (0, 0, pl, pr, pt, pb), value=int(izp))
    if _is_depthwise(x.shape, w.shape, groups):
        _check_depth(kh * kw, DW_TAP_BOUND, "wide_conv_model taps")
        oh, ow = conv2d_out_hw(x.shape[1], x.shape[2], kh, kw, strides, padding, (1, 1))
        wi = w.to(torch.int64).reshape(kh, kw, cout)
        acc = torch.zeros((x.shape[0], oh, ow, cout), dtype=torch.int64)
        for i in range(kh):
            for j in range(kw):
                acc += xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :] * wi[i, j]
        return _in_int32(acc - int(izp) * wi.sum(dim=(0, 1)), "the depthwise sum")
    _check_depth(kh * kw * cin_g, K_BOUND, "wide_conv_model")
    cols = xp.unfold(1, kh, sh).unfold(2, kw, sw)          # (n, oh, ow, cin, kh, kw)
    n, oh, ow = cols.shape[:3]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, kh * kw * cin_g)
    return plane_product(cols, w.reshape(kh * kw * cin_g, cout), izp).reshape(n, oh, ow, cout)
