"""K11 and K12: the round-1 direct int8 conv with the exact requantize
epilogue (port of `tachikoma_tpu/ops/pallas/conv_int8.py`).

  * `qconv_direct` (K11) wraps `csrc/qconv_direct.cu tk_qconv_direct`
    (replaces `_conv_kernel`): groups 1, any kernel size, stride and padding,
    on the tensor cores; a persistent block stages each of its 16 x 8
    output tiles' input window once per chunk of 64 input channels,
    deinterleaved into its stride's phases, and runs every tap as a `wgmma`
    on the staged window at a shifted descriptor ("im2col in VMEM";
    `direct_geometry`, `direct_taps`), on weights packed once per tensor
    (`direct_weights`) and kept resident in shared memory where they fit.
    The 7x7 CIN-3 stem and geometries whose window does not fit run the
    first port's `mma.sync` kernel (the narrow path, `narrow_chunk`);
    `direct_plan` picks the path, BN, the taps a step and the copies' depth
    from the shape.
  * `qdwconv_direct` (K12) wraps `csrc/qdwconv.cu tk_qdwconv_direct`
    (replaces `_dw_kernel`): depthwise (groups == C), any kernel size and
    stride, on K5's body (`depthwise.dw_launch`, at `dw_plan`'s tile): K5's
    requantize mode with rq_izp = 0, the caller's bias (the kernel takes
    izp * sum(w) off itself), the low byte stored as `out_dtype`.
  * `qconv2d_int8` is the JAX package's entry with its signature: a
    multiplier (scalar or per channel) is required, there is no raw mode;
    `out_dtype` "int8" or "uint8" with `qmin` / `qmax`; groups 1 or
    depthwise, else NotImplementedError.  A nonzero `input_zero_point` pads
    the border with izp; K11's wrapper folds - izp * colsum(w) into the bias
    (int32 wraparound), K12's kernel takes izp * sum(w) off.
    `qconv2d_int8_plain` is the same call through the plain versions.

The TPU kernel's VMEM budget (`_vmem_cost`, `_pick_bn`, `_pick_dw_bc`), its
128-lane channel padding, the strided-patch over-padding and `_x32_tracing`
have no counterpart.  `qconv2d_supported` is the port's own: it admits every
groups-1 geometry whose staged tiles fit the H100's 227 KB of shared memory
on either K11 path and every depthwise one for which K5's `dw_plan` finds a
tile (all but kernels of hundreds of taps), and so says True where the JAX
predicate says False for VMEM, e.g. (1, 224, 224, 64) 3x3.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel or raises.  Nothing dispatches a forward to these
kernels: the tuner (`tune/tuner.py tune_conv`) is their one caller, as in the
JAX package.
"""

from __future__ import annotations

import torch

from ..nn import conv2d_out_hw
from ._lib import LAUNCHES, check_cuda_operands, launch, refuse_uint8
from .conv import conv_acc_plain, sm_count
from .conv_layouts import SMEM_LIMIT, _round_up, pack_once
from .depthwise import dw_acc_plain, dw_launch, dw_plan
from .matmul_int8 import _TONEAREST, as_int8, as_int32_vector, fold_input_zero_point
from .requantize import channel_vector, epilogue_plain

TILE_ROWS, TILE_COLS = 16, 8  # K11's output tile (csrc H_TR, H_TC): two warpgroups of 8 rows
KC = 64                      # K11's input channels per staged chunk (csrc H_KC)
BNS = (128, 64)              # K11's output channels per block, the wider first
RPAD = 16                    # bytes of padding per row of the staged output tile
AHEAD = 2                    # the steps K11's copies run ahead, where shared memory allows
NARROW_CIN, NARROW_TAPS = 16, 9  # below this CIN and above these taps, the narrow path
NARROW_TILE = 8              # the narrow path's output tile: 8 x 8 pixels (csrc D_TH, D_TW)
NARROW_BN = 64               # its output channels per block (csrc D_BN)
NARROW_CHUNKS = (32, 16, 8, 4)  # its input channels per staged chunk
OUT_DTYPES = {"int8": torch.int8, "uint8": torch.uint8}
_DIRECT: dict = {}


def direct_geometry(cin: int, kh: int, kw: int, strides) -> dict:
    """The staged window of K11's Hopper path (csrc wgeo_layout): its live
    phases (lph, lpw) = (min(SH, KH), min(SW, KW)), each `ph_rows` pixel rows
    of `ph_cols` pixels (`real_cols` staged, padded to a multiple of 8),
    `npix` pixels in all; `segs` 16-byte channel segments a pixel (4, or 2
    where CIN <= 32: one k32 step); `nch` chunks of KC channels."""
    sh, sw = strides
    khp, kwp = -(-kh // sh), -(-kw // sw)
    real_cols = TILE_COLS - 1 + kwp
    g = dict(lph=min(sh, kh), lpw=min(sw, kw), khp=khp, kwp=kwp, ph_rows=TILE_ROWS - 1 + khp,
             real_cols=real_cols, ph_cols=_round_up(real_cols, 8), segs=4 if cin > 32 else 2,
             nch=-(-cin // KC), taps=kh * kw)
    g["ph_pix"] = g["ph_rows"] * g["ph_cols"]
    g["npix"] = g["lph"] * g["lpw"] * g["ph_pix"]
    return g


def direct_taps(kh: int, kw: int, strides) -> list[tuple[int, int, int, int]]:
    """Tap (ky, kx) of K11's Hopper path, in the order its steps walk them:
    (phase, a, b, offset), tap (ky, kx) = (a*SH + p, b*SW + q) of phase
    p*lpw + q, read by output pixel (r, c) of the tile at phase pixel
    (r + a, c + b), which lies `offset` + r * ph_cols + c pixels into the
    window's segment (the kernel's toff, in pixels)."""
    g = direct_geometry(1, kh, kw, strides)
    sh, sw = strides
    taps = []
    for ky in range(kh):
        for kx in range(kw):
            a, p = divmod(ky, sh)
            b, q = divmod(kx, sw)
            ph = p * g["lpw"] + q
            taps.append((ph, a, b, ph * g["ph_pix"] + a * g["ph_cols"] + b))
    return taps


def direct_smem(bn: int, group: int, cin: int, kh: int, kw: int, strides,
                wres: bool = False, ahead: int = 1) -> int:
    """K11's dynamic shared memory on the Hopper path (csrc wgeo_layout):
    ahead + 1 windows; every (chunk, tap) slab of BN x 64 weights of the N
    tile (`wres`), else ahead + 1 steps of `group` taps of them; the staged
    output tile, the column constants and the taps' window offsets."""
    g = direct_geometry(cin, kh, kw, strides)
    win = g["npix"] * 16 * g["segs"]
    weights = g["nch"] * kh * kw * bn * 64 if wres else (ahead + 1) * group * bn * 64
    return ((ahead + 1) * win + weights + TILE_ROWS * TILE_COLS * (bn + RPAD) + 16 * bn
            + _round_up(4 * kh * kw, 16))


def narrow_smem(cc: int, kh: int, kw: int, strides) -> int:
    """The narrow path's dynamic shared memory at chunk `cc`: the
    reduction-offset table, two windows and two weight tiles (csrc
    launch_qconv_direct_narrow)."""
    kd = _round_up(kh * kw * cc, 32)
    win = _round_up(((NARROW_TILE - 1) * strides[0] + kh)
                    * ((NARROW_TILE - 1) * strides[1] + kw) * cc, 16)
    return 4 * kd + 2 * win + 2 * NARROW_BN * (kd + 16)


def narrow_chunk(cin: int, kh: int, kw: int, strides) -> int | None:
    """The narrow path's chunk: the fewest of NARROW_CHUNKS that hold CIN (at
    most 32), halved until shared memory fits; None when even 4 does not."""
    cc = next(c for c in reversed(NARROW_CHUNKS) if c >= min(cin, NARROW_CHUNKS[0]))
    for c in NARROW_CHUNKS[NARROW_CHUNKS.index(cc):]:
        if narrow_smem(c, kh, kw, strides) <= SMEM_LIMIT:
            return c
    return None


def direct_chunk(cin: int, kh: int, kw: int, strides) -> int | None:
    """K11's input channels per staged chunk: KC on the Hopper path, where
    its window and one tap of weights fit 227 KB at BN 64; else the narrow
    path's chunk (`narrow_chunk`); None when neither fits."""
    if direct_smem(BNS[-1], 1, cin, kh, kw, strides) <= SMEM_LIMIT:
        return KC
    return narrow_chunk(cin, kh, kw, strides)


def direct_plan(x_shape, w_shape, strides, padding, sms: int = 132) -> dict | None:
    """K11's launch on a card of `sms` SMs: the Hopper path's
    (`hopper_plan`) where its window fits, but the narrow path's {"cc":
    chunk} for a CIN below NARROW_CIN with more than NARROW_TAPS taps (the
    7x7 CIN-3 stem: the Hopper path spends a 32-byte K step on each of its
    49 taps of 3 channels, the narrow one packs them four channels a tap,
    and ran the stem of ResNet-50 b8 in half the time on the H100,
    tools/conv_probe.py); None when neither fits."""
    cin = x_shape[3]
    kh, kw = w_shape[:2]
    cc = direct_chunk(cin, kh, kw, strides)
    if cc is None:
        return None
    if cc != KC or (cin < NARROW_CIN and kh * kw > NARROW_TAPS and
                    narrow_chunk(cin, kh, kw, strides) is not None):
        return {"cc": narrow_chunk(cin, kh, kw, strides)}
    return hopper_plan(x_shape, w_shape, strides, padding, sms)


def hopper_plan(x_shape, w_shape, strides, padding, sms: int = 132) -> dict:
    """K11's Hopper path on a card of `sms` SMs: {"cc": KC, "bn", "group",
    "wres", "ahead"}.  BN 128 where COUT > 64 and its tiles fill the SMs,
    else 64.  The N tile's weights stay resident in shared memory where they
    fit (`wres`: staged once per block, every chunk a step of all the taps);
    else they stream, the most taps a step that fit 227 KB (all nine of a
    3x3).  The copies run AHEAD steps ahead where that fits, else one."""
    n, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    oh, ow = conv2d_out_hw(h, wd, kh, kw, tuple(strides), tuple(padding), (1, 1))
    m_tiles = n * -(-oh // TILE_ROWS) * -(-ow // TILE_COLS)
    bns = [bn for bn in BNS
           if bn == BNS[-1] or (cout > BNS[-1] and m_tiles * -(-cout // bn) >= sms)]
    taps = kh * kw
    for bn in bns:
        for ahead in (AHEAD, 1):
            if direct_smem(bn, taps, cin, kh, kw, strides, True, ahead) <= SMEM_LIMIT:
                return {"cc": KC, "bn": bn, "group": taps, "wres": 1, "ahead": ahead}
    for bn in bns:
        for grp in range(taps, 0, -1):
            for ahead in (AHEAD, 1):
                if direct_smem(bn, grp, cin, kh, kw, strides, False, ahead) <= SMEM_LIMIT:
                    return {"cc": KC, "bn": bn, "group": grp, "wres": 0, "ahead": ahead}
    raise ValueError(f"K11's Hopper path does not fit {tuple(x_shape)} * {tuple(w_shape)}")


def direct_weights(w: torch.Tensor) -> torch.Tensor:
    """w (KH, KW, CIN, COUT) packed K-major by chunk and tap as (CINP / KC,
    KH*KW, COUT, KC), CINP = CIN rounded up to KC with zeros: row (c, t, n)
    holds tap t's weights of output channel n at input channels KC c .. KC c
    + 63.  A (chunk, tap) slab of BN consecutive output channels is then BN
    * 64 contiguous bytes, which K11's Hopper path stages with 16-byte
    copies, a warp 512 contiguous bytes, and no mask; made once per weight
    tensor (`pack_once`)."""
    def make(w):
        kh, kw, cin, cout = w.shape
        cinp = _round_up(cin, KC)
        wk = torch.zeros((kh * kw, cout, cinp), dtype=torch.int8, device=w.device)
        wk[:, :, :cin] = w.reshape(kh * kw, cin, cout).transpose(1, 2)
        return wk.reshape(kh * kw, cout, cinp // KC, KC).permute(2, 0, 1, 3).contiguous()

    return pack_once(_DIRECT, w, make)


def _depthwise(x_shape, w_shape, groups) -> bool:
    cin = x_shape[3]
    return groups == cin and w_shape[2] == 1 and w_shape[3] == cin


def qconv2d_supported(x_shape, w_shape, strides, padding, groups: int) -> bool:
    """Whether `qconv2d_int8` runs this geometry on the card: groups 1 or
    depthwise (groups == CIN == COUT, one input channel per filter), a
    non-empty output, and K11's staged tiles within 227 KB or a tile of
    K12's (K5's `dw_plan`, which raises where none fits)."""
    kh, kw = w_shape[:2]
    oh, ow = conv2d_out_hw(x_shape[1], x_shape[2], kh, kw, tuple(strides), tuple(padding),
                           (1, 1))
    if min(oh, ow) <= 0:
        return False
    if groups == 1:
        return direct_chunk(x_shape[3], kh, kw, strides) is not None
    if _depthwise(x_shape, w_shape, groups):
        try:
            dw_plan(x_shape[0], oh, ow, x_shape[3], kh, kw, *strides)
        except ValueError:
            return False
        return True
    return False


def _out_dtype(out_dtype) -> torch.dtype:
    if out_dtype not in OUT_DTYPES.values():
        raise ValueError(f"out_dtype {out_dtype}: int8 or uint8")
    return out_dtype


def qconv_direct_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                       izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                       out_dtype=torch.int8, plan=None) -> torch.Tensor:
    """Plain PyTorch version of K11: the accumulator of sum (x_pad - izp) * w
    (float64, exact), then the epilogue; the clipped value's low byte as
    `out_dtype` (`plan` is the kernel's launch: no effect)."""
    acc = conv_acc_plain(x, w, strides, padding, izp)
    out = epilogue_plain(acc, bias, mult, shift, 0, out_zp, rounding, qmin, qmax)
    return out.view(_out_dtype(out_dtype))


def qdwconv_direct_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                         izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                         out_dtype=torch.int8) -> torch.Tensor:
    """Plain PyTorch version of K12."""
    acc = dw_acc_plain(x, w, strides, padding, izp).to(torch.int32)
    out = epilogue_plain(acc, bias, mult, shift, 0, out_zp, rounding, qmin, qmax)
    return out.view(_out_dtype(out_dtype))


def _launch_k11(x, w, bias, mult, shift, strides, padding, izp, out_zp, rounding, qmin, qmax,
                out_dtype, plan, wk):
    """Check K11's operands, fold izp into the bias, launch tk_qconv_direct at
    `plan` on `wk` (the weights as the plan's path takes them), count it;
    returns the output."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = conv2d_out_hw(h, wd, kh, kw, strides, padding, (1, 1))
    i32 = torch.int32
    check_cuda_operands("qconv_direct", x.device, x=(x, torch.int8, (n, h, wd, cin)),
                        w=(w, torch.int8, (kh, kw, cin, cout)), bias=(bias, i32, (cout,)),
                        mult=(mult, i32, (cout,)), shift=(shift, i32, (cout,)))
    out = torch.empty((n, oh, ow, cout), dtype=_out_dtype(out_dtype), device=x.device)
    bias = fold_input_zero_point(bias, w, izp)
    launch("tk_qconv_direct", [x, wk, out, bias, mult, shift], dict(
        n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=oh, ow=ow, sh=strides[0],
        sw=strides[1], pt=padding[0], pl=padding[1], izp=izp, out_zp=out_zp, qmin=qmin,
        qmax=qmax, tonearest=_TONEAREST[rounding],
        a_vec=cin % 16 == 0 and x.data_ptr() % 16 == 0,
        b_vec=cout % 4 == 0 and w.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0,
        **plan))
    LAUNCHES["qconv_direct"] += 1
    return out


def _geometry(kernel, x, w, strides, padding):
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    kh, kw = w.shape[:2]
    oh, ow = conv2d_out_hw(x.shape[1], x.shape[2], kh, kw, strides, padding, (1, 1))
    if min(oh, ow) <= 0:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    return kh, kw, oh, ow


def qconv_direct(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
                 out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                 out_dtype=torch.int8, plan=None) -> torch.Tensor:
    """K11: x int8 NHWC, w int8 HWIO (groups 1), bias / mult / shift int32
    (COUT,); padding (top, left, bottom, right) -> clip(q_multiply_shift(acc
    + bias, m, s) + out_zp, qmin, qmax) as `out_dtype` (int8 or uint8) NHWC.
    `plan`: the launch as `direct_plan` gives it; None picks it from the
    shape."""
    kw_ = dict(strides=strides, padding=padding, izp=izp, out_zp=out_zp, rounding=rounding,
               qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    refuse_uint8("qconv_direct", x, w)
    if x.device.type == "cpu":
        return qconv_direct_plain(x, w, bias, mult, shift, **kw_)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_direct: no kernel for device {x.device}")
    kh, kw, _, _ = _geometry("qconv_direct", x, w, strides, padding)
    if plan is None:
        plan = direct_plan(tuple(x.shape), tuple(w.shape), strides, padding,
                           sm_count(x.device.index))
    if plan is None:
        raise ValueError(f"qconv_direct: a {kh}x{kw} window exceeds shared memory")
    wk = direct_weights(w) if plan["cc"] == KC else w
    return _launch_k11(x, w, bias, mult, shift, strides, padding, izp, out_zp, rounding, qmin,
                       qmax, out_dtype, plan, wk)


def qdwconv_direct(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
                   out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                   out_dtype=torch.int8) -> torch.Tensor:
    """K12: the depthwise conv, x int8 NHWC (N, H, W, C), w int8 (KH, KW, 1,
    C), bias / mult / shift int32 (C,) -> `out_dtype` (int8 or uint8) NHWC."""
    kw_ = dict(strides=strides, padding=padding, izp=izp, out_zp=out_zp, rounding=rounding,
               qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    refuse_uint8("qdwconv_direct", x, w)
    if x.device.type == "cpu":
        return qdwconv_direct_plain(x, w, bias, mult, shift, **kw_)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_direct: no kernel for device {x.device}")
    _geometry("qdwconv_direct", x, w, strides, padding)
    return dw_launch("qdwconv_direct", x, w, _out_dtype(out_dtype),
                     dict(bias=bias, mult=mult, shift=shift), tuple(strides), tuple(padding), izp,
                     out_zp=out_zp, qmin=qmin, qmax=qmax, tonearest=_TONEAREST[rounding])


def _call(x, w, bias, multiplier, shift, strides, padding, groups, input_zero_point, out_zp,
          rounding, out_dtype, qmin, qmax):
    """(kernel name, args, kwargs) of one qconv2d_int8 call."""
    if multiplier is None or shift is None:
        raise ValueError("qconv2d_int8: a multiplier and a shift are required (no raw mode)")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"qconv2d_int8: out_dtype {out_dtype!r}: one of {sorted(OUT_DTYPES)}")
    x = torch.as_tensor(x)
    dev = x.device
    w = as_int8(w, dev)
    if groups != 1 and not _depthwise(tuple(x.shape), tuple(w.shape), groups):
        raise NotImplementedError("qconv2d_int8 supports groups==1 or depthwise "
                                  f"(groups {groups}, weight {tuple(w.shape)})")
    cout = w.shape[3]
    name = "qconv_direct" if groups == 1 else "qdwconv_direct"
    args = (x.contiguous(), w, as_int32_vector(bias, cout, dev),
            channel_vector(multiplier, cout, dev), channel_vector(shift, cout, dev))
    return name, args, dict(strides=tuple(strides), padding=tuple(padding),
                            izp=int(input_zero_point), out_zp=int(out_zp), rounding=rounding,
                            qmin=int(qmin), qmax=int(qmax), out_dtype=OUT_DTYPES[out_dtype])


def qconv2d_int8(x, w, bias=None, multiplier=None, shift=None, *, strides=(1, 1),
                 padding=(0, 0, 0, 0), groups: int = 1, input_zero_point: int = 0,
                 out_zp: int = 0, rounding: str = "UPWARD", out_dtype: str = "int8",
                 qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """NHWC int8 conv with the fused exact requantize (the JAX package's
    entry): x (N,H,W,CIN) int8; w (KH,KW,CIN/groups,COUT) int8; groups 1
    (K11) or depthwise (K12).  multiplier / shift: scalars or per-channel."""
    name, args, kw = _call(x, w, bias, multiplier, shift, strides, padding, groups,
                           input_zero_point, out_zp, rounding, out_dtype, qmin, qmax)
    return globals()[name](*args, **kw)


def qconv2d_int8_plain(x, w, bias=None, multiplier=None, shift=None, *, strides=(1, 1),
                       padding=(0, 0, 0, 0), groups: int = 1, input_zero_point: int = 0,
                       out_zp: int = 0, rounding: str = "UPWARD", out_dtype: str = "int8",
                       qmin: int = -128, qmax: int = 127) -> torch.Tensor:
    """`qconv2d_int8` through K11's or K12's plain version, on x's device."""
    name, args, kw = _call(x, w, bias, multiplier, shift, strides, padding, groups,
                           input_zero_point, out_zp, rounding, out_dtype, qmin, qmax)
    return globals()[f"{name}_plain"](*args, **kw)
