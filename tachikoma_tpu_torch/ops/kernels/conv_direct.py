"""K11 and K12: the round-1 direct int8 conv with the exact requantize
epilogue (port of `tachikoma_tpu/ops/pallas/conv_int8.py`).

  * `qconv_direct` (K11) wraps `csrc/qconv_direct.cu tk_qconv_direct`
    (replaces `_conv_kernel`): groups 1, any kernel size, stride and padding,
    on the tensor cores; each block stages its output tile's input window
    once per chunk of input channels and runs the KH * KW taps as one deep
    product ("im2col in VMEM").
  * `qdwconv_direct` (K12) wraps `tk_qdwconv_direct` (replaces `_dw_kernel`):
    depthwise (groups == C), any kernel size and stride, on CUDA cores, one
    staged window per (image, output tile, 64 channels).
  * `qconv2d_int8` is the JAX package's entry with its signature: a
    multiplier (scalar or per channel) is required, there is no raw mode;
    `out_dtype` "int8" or "uint8" with `qmin` / `qmax`; groups 1 or
    depthwise, else NotImplementedError.  A nonzero `input_zero_point` pads
    the border with izp and folds - izp * colsum(w) into the bias (int32
    wraparound).  `qconv2d_int8_plain` is the same call through the plain
    versions.

The TPU kernel's VMEM budget (`_vmem_cost`, `_pick_bn`, `_pick_dw_bc`), its
128-lane channel padding, the strided-patch over-padding and `_x32_tracing`
have no counterpart.  `qconv2d_supported` is the port's own: it admits every
groups-1 and depthwise geometry whose staged tiles fit the H100's 227 KB of
shared memory (all but kernels of thousands of taps), and so says True where
the JAX predicate says False for VMEM, e.g. (1, 224, 224, 64) 3x3.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its kernel or raises.  Nothing dispatches a forward to these
kernels: the tuner (`tune/tuner.py tune_conv`) is their one caller, as in the
JAX package.
"""

from __future__ import annotations

import torch

from ..nn import conv2d_out_hw
from ._lib import LAUNCHES, check_cuda_operands, launch
from .conv import conv_acc_plain
from .conv_layouts import SMEM_LIMIT, _round_up
from .depthwise import dw_acc_plain
from .matmul_int8 import _TONEAREST, as_int8, as_int32_vector, fold_input_zero_point
from .requantize import channel_vector, epilogue_plain

TILE = 8                     # K11's output tile: TILE x TILE pixels (csrc D_TH, D_TW)
BN = 64                      # K11's output channels per block (csrc D_BN)
CHUNKS = (32, 16, 8, 4)      # K11's input channels per staged chunk
DW_CB = 64                   # K12's channels per block (csrc DWD_CB)
DW_BUDGET = 64 * 1024        # K12's target shared memory per block
OUT_DTYPES = {"int8": torch.int8, "uint8": torch.uint8}


def direct_smem(cc: int, kh: int, kw: int, strides) -> int:
    """K11's dynamic shared memory at chunk `cc`: the reduction-offset table,
    two windows and two weight tiles (csrc launch_qconv_direct)."""
    kd = _round_up(kh * kw * cc, 32)
    win = _round_up(((TILE - 1) * strides[0] + kh) * ((TILE - 1) * strides[1] + kw) * cc, 16)
    return 4 * kd + 2 * win + 2 * BN * (kd + 16)


def direct_chunk(cin: int, kh: int, kw: int, strides) -> int | None:
    """K11's chunk: the fewest of CHUNKS that hold CIN (at most 32), halved
    until shared memory fits; None when even 4 does not."""
    cc = next(c for c in reversed(CHUNKS) if c >= min(cin, CHUNKS[0]))
    for c in CHUNKS[CHUNKS.index(cc):]:
        if direct_smem(c, kh, kw, strides) <= SMEM_LIMIT:
            return c
    return None


def dw_smem(tile, kh: int, kw: int, strides) -> int:
    """K12's dynamic shared memory at output tile (TH, TW): the window and
    the block's weights, 64 channels each (csrc launch_qdwconv_direct)."""
    th, tw = tile
    return (((th - 1) * strides[0] + kh) * ((tw - 1) * strides[1] + kw) + kh * kw) * DW_CB


def dw_tile(oh: int, ow: int, kh: int, kw: int, strides) -> tuple[int, int] | None:
    """K12's output tile (TH, TW): 8 rows by the whole output row, the
    columns halved down to 8, then the rows, until the block fits DW_BUDGET;
    None when a 1 x 1 tile exceeds the card's shared memory."""
    th, tw = min(8, oh), ow
    while dw_smem((th, tw), kh, kw, strides) > DW_BUDGET and (th, tw) != (1, 1):
        if tw > 8 or th == 1:
            tw = -(-tw // 2)
        else:
            th = -(-th // 2)
    return (th, tw) if dw_smem((th, tw), kh, kw, strides) <= SMEM_LIMIT else None


def _depthwise(x_shape, w_shape, groups) -> bool:
    cin = x_shape[3]
    return groups == cin and w_shape[2] == 1 and w_shape[3] == cin


def qconv2d_supported(x_shape, w_shape, strides, padding, groups: int) -> bool:
    """Whether `qconv2d_int8` runs this geometry on the card: groups 1 or
    depthwise (groups == CIN == COUT, one input channel per filter), a
    non-empty output, and K11's or K12's staged tiles within 227 KB."""
    kh, kw = w_shape[:2]
    oh, ow = conv2d_out_hw(x_shape[1], x_shape[2], kh, kw, tuple(strides), tuple(padding),
                           (1, 1))
    if min(oh, ow) <= 0:
        return False
    if groups == 1:
        return direct_chunk(x_shape[3], kh, kw, strides) is not None
    if _depthwise(x_shape, w_shape, groups):
        return dw_tile(oh, ow, kh, kw, strides) is not None
    return False


def _out_dtype(out_dtype) -> torch.dtype:
    if out_dtype not in OUT_DTYPES.values():
        raise ValueError(f"out_dtype {out_dtype}: int8 or uint8")
    return out_dtype


def qconv_direct_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                       izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                       out_dtype=torch.int8) -> torch.Tensor:
    """Plain PyTorch version of K11: the accumulator of sum (x_pad - izp) * w
    (float64, exact), then the epilogue; the clipped value's low byte as
    `out_dtype`."""
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


def _launch(kernel, x, w, bias, mult, shift, strides, padding, izp, out_zp, rounding, qmin,
            qmax, out_dtype, tile_params):
    """Check the operands, fold izp into the bias, launch tk_<kernel>, count
    it; returns the output."""
    n, h, wd, cin = x.shape
    kh, kw = w.shape[:2]
    cout = cin if kernel == "qdwconv_direct" else w.shape[3]
    wshape = (kh, kw, 1 if kernel == "qdwconv_direct" else cin, cout)
    oh, ow = conv2d_out_hw(h, wd, kh, kw, strides, padding, (1, 1))
    i32 = torch.int32
    check_cuda_operands(kernel, x.device, x=(x, torch.int8, (n, h, wd, cin)),
                        w=(w, torch.int8, wshape), bias=(bias, i32, (cout,)),
                        mult=(mult, i32, (cout,)), shift=(shift, i32, (cout,)))
    out = torch.empty((n, oh, ow, cout), dtype=_out_dtype(out_dtype), device=x.device)
    bias = fold_input_zero_point(bias, w, izp)
    launch(f"tk_{kernel}", [x, w, out, bias, mult, shift], dict(
        n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=oh, ow=ow, sh=strides[0],
        sw=strides[1], pt=padding[0], pl=padding[1], izp=izp, out_zp=out_zp, qmin=qmin,
        qmax=qmax, tonearest=_TONEAREST[rounding],
        a_vec=cin % 16 == 0 and x.data_ptr() % 16 == 0,
        b_vec=cout % 4 == 0 and w.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0,
        **tile_params))
    LAUNCHES[kernel] += 1
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
                 out_dtype=torch.int8) -> torch.Tensor:
    """K11: x int8 NHWC, w int8 HWIO (groups 1), bias / mult / shift int32
    (COUT,); padding (top, left, bottom, right) -> clip(q_multiply_shift(acc
    + bias, m, s) + out_zp, qmin, qmax) as `out_dtype` (int8 or uint8) NHWC."""
    kw_ = dict(strides=strides, padding=padding, izp=izp, out_zp=out_zp, rounding=rounding,
               qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return qconv_direct_plain(x, w, bias, mult, shift, **kw_)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_direct: no kernel for device {x.device}")
    kh, kw, _, _ = _geometry("qconv_direct", x, w, strides, padding)
    cc = direct_chunk(x.shape[3], kh, kw, strides)
    if cc is None:
        raise ValueError(f"qconv_direct: a {kh}x{kw} window exceeds shared memory")
    return _launch("qconv_direct", x, w, bias, mult, shift, strides, padding, izp, out_zp,
                   rounding, qmin, qmax, out_dtype, {"cc": cc})


def qdwconv_direct(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
                   out_zp=0, rounding="UPWARD", qmin=-128, qmax=127,
                   out_dtype=torch.int8) -> torch.Tensor:
    """K12: the depthwise conv, x int8 NHWC (N, H, W, C), w int8 (KH, KW, 1,
    C), bias / mult / shift int32 (C,) -> `out_dtype` (int8 or uint8) NHWC."""
    kw_ = dict(strides=strides, padding=padding, izp=izp, out_zp=out_zp, rounding=rounding,
               qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return qdwconv_direct_plain(x, w, bias, mult, shift, **kw_)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_direct: no kernel for device {x.device}")
    kh, kw, oh, ow = _geometry("qdwconv_direct", x, w, strides, padding)
    tile = dw_tile(oh, ow, kh, kw, strides)
    if tile is None:
        raise ValueError(f"qdwconv_direct: a {kh}x{kw} window exceeds shared memory")
    return _launch("qdwconv_direct", x, w, bias, mult, shift, strides, padding, izp, out_zp,
                   rounding, qmin, qmax, out_dtype, {"th": tile[0], "tw": tile[1]})


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
