"""K5: depthwise int8 convolution, with the exact requantize epilogue or the
raw int32 accumulator (port of `tachikoma_tpu/ops/pallas/conv_flat.py`
`_conv_dw_vpu` + `_flat_dw_kernel`).

  * `qdwconv_rq` wraps `csrc/qdwconv.cu tk_qdwconv_rq`: the fused
    `tk.conv2d_rq` with groups == C, per-channel multiplier and shift.
  * `qdwconv_raw` wraps `tk_qdwconv_raw`: the same conv storing the int32
    accumulator plus bias, for the unfused grouped `qnn.conv2d` (the JAX
    package runs that through `lax.conv`, with no Pallas kernel).

x is int8 NHWC (N, H, W, C), w int8 HWIO (KH, KW, 1, C); any kernel size,
stride and padding (top, left, bottom, right); taps outside the image read
the input zero point, so they add 0 to sum (x_pad - izp) * w.  On a CPU
tensor each wrapper runs its plain PyTorch version; on a CUDA tensor it
launches K5 or raises.  The TPU kernel's polyphase stacking, 128-lane
padding and VMEM budget have no counterpart: K5 reads NHWC directly.
"""

from __future__ import annotations

import torch

from ..nn import conv2d_out_hw
from ._lib import LAUNCHES, check_cuda_operands, launch
from .matmul_int8 import _TONEAREST
from .requantize import epilogue_plain

# csrc/qdwconv.cu keeps a block's weights (KH * KW taps x up to 128 channels)
# in 48 KiB of shared memory
_MAX_TAPS = 48 * 1024 // 128


def dw_acc_plain(x, w, strides, padding, izp) -> torch.Tensor:
    """int64 accumulator sum (x_pad - izp) * w of a depthwise conv: the image
    minus izp, padded with 0, one strided window per tap, exact on any
    device (no float conv, whose cuDNN algorithms may round)."""
    kh, kw, _, c = w.shape
    sh, sw = strides
    pt, pl, pb, pr = padding
    oh, ow = conv2d_out_hw(x.shape[1], x.shape[2], kh, kw, strides, padding, (1, 1))
    xp = torch.nn.functional.pad(x.to(torch.int64) - int(izp), (0, 0, pl, pr, pt, pb))
    wk = w.to(torch.int64).reshape(kh, kw, c)
    acc = torch.zeros((x.shape[0], oh, ow, c), dtype=torch.int64, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc += xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :] * wk[i, j]
    return acc


def qdwconv_rq_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                     izp=0, rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128,
                     qmax=127) -> torch.Tensor:
    """Plain PyTorch version of K5's requantize mode."""
    acc = dw_acc_plain(x, w, strides, padding, izp).to(torch.int32)
    return epilogue_plain(acc, bias, mult, shift, rq_izp, out_zp, rounding, qmin, qmax)


def qdwconv_raw_plain(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0),
                      izp=0) -> torch.Tensor:
    """Plain PyTorch version of K5's raw mode."""
    return (dw_acc_plain(x, w, strides, padding, izp) + bias.to(torch.int64)).to(torch.int32)


def _launch(kernel, x, w, out_dtype, ptrs, strides, padding, izp, **epilogue):
    """Check the operands, launch C entry tk_<kernel>, count it; returns out."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    oh, ow = conv2d_out_hw(h, wd, kh, kw, strides, padding, (1, 1))
    if min(oh, ow) <= 0:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    if kh * kw > _MAX_TAPS:
        raise ValueError(f"{kernel}: {kh}x{kw} taps exceed K5's shared-memory tile")
    ops = dict(x=(x, torch.int8, (n, h, wd, c)), w=(w, torch.int8, (kh, kw, 1, c)))
    ops.update((k, (t, torch.int32, (c,))) for k, t in ptrs.items())
    check_cuda_operands(kernel, x.device, **ops)
    out = torch.empty((n, oh, ow, c), dtype=out_dtype, device=x.device)
    vec = c % 4 == 0 and x.data_ptr() % 4 == 0
    launch(f"tk_{kernel}", [x, w, out, *ptrs.values()], dict(
        n=n, h=h, w=wd, cin=c, kh=kh, kw=kw, cout=c, oh=oh, ow=ow, sh=strides[0],
        sw=strides[1], pt=padding[0], pl=padding[1], izp=izp, a_vec=vec, **epilogue))
    LAUNCHES[kernel] += 1
    return out


def qdwconv_rq(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
               rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127) -> torch.Tensor:
    """K5, requantize mode: clip(q_multiply_shift(acc + bias[c] - rq_izp,
    m[c], s[c]) + out_zp, qmin, qmax) -> int8 NHWC.  bias / mult / shift
    int32 (C,)."""
    if x.device.type == "cpu":
        return qdwconv_rq_plain(x, w, bias, mult, shift, strides=strides, padding=padding,
                                izp=izp, rq_izp=rq_izp, out_zp=out_zp, rounding=rounding,
                                qmin=qmin, qmax=qmax)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_rq: no kernel for device {x.device}")
    return _launch("qdwconv_rq", x, w, torch.int8, dict(bias=bias, mult=mult, shift=shift),
                   strides, padding, izp, rq_izp=rq_izp, out_zp=out_zp, qmin=qmin,
                   qmax=qmax, tonearest=_TONEAREST[rounding])


def qdwconv_raw(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0) -> torch.Tensor:
    """K5, raw mode: the int32 accumulator sum (x_pad - izp) * w plus bias[c]
    in int32 wraparound -> int32 NHWC.  bias int32 (C,)."""
    if x.device.type == "cpu":
        return qdwconv_raw_plain(x, w, bias, strides=strides, padding=padding, izp=izp)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_raw: no kernel for device {x.device}")
    return _launch("qdwconv_raw", x, w, torch.int32, dict(bias=bias), strides, padding, izp)
