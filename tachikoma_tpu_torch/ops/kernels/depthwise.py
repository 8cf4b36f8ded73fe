"""K5: depthwise int8 convolution, with the exact requantize epilogue or the
raw int32 accumulator (port of `tachikoma_tpu/ops/pallas/conv_flat.py`
`_conv_dw_vpu` + `_flat_dw_kernel`).

  * `qdwconv_rq` wraps `csrc/qdwconv.cu tk_qdwconv_rq`: the fused
    `tk.conv2d_rq` with groups == C, per-channel multiplier and shift.
  * `qdwconv_raw` wraps `tk_qdwconv_raw`: the same conv storing the int32
    accumulator plus bias, for the unfused grouped `qnn.conv2d` (the JAX
    package runs that through `lax.conv`, with no Pallas kernel).
  * `dw_launch` also launches the body's int16 mode, `tk_qdwconv_wide`
    (W8A16's depthwise conv into int64, at any dilation; its wrapper is
    `wide.qdwconv_wide`).

x is int8 or uint8 NHWC (N, H, W, C), w int8 HWIO (KH, KW, 1, C) with an
optional zero point kzp (int32 (C,): legacy uint8 TFLite models, whose
uint8 weights arrive as int8 w - 128 with kzp - 128); any kernel size,
stride, dilation and padding (top, left, bottom, right); taps outside the
image read the input zero point, so they add 0 to sum (x_pad - izp) * (w -
kzp).  The requantize mode stores int8 or uint8 (`out_dtype`).  On a CPU
tensor each wrapper runs its plain PyTorch version; on a CUDA tensor it
launches K5 or raises.  The TPU kernel's polyphase stacking, 128-lane
padding and VMEM budget have no counterpart: K5 stages each block's window
of the NHWC image in shared memory, at the tile `dw_plan` picks;
`dw_thread_outputs` says which outputs each thread of that launch writes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn import conv2d_out_hw
from ._lib import LAUNCHES, check_cuda_operands, check_fill, launch
from .matmul_int8 import _TONEAREST, less_kzp
from .requantize import epilogue_plain, out_torch_dtype

# csrc/qdwconv.cu: R output pixels a thread along x, the channel tiles it is
# built for (in the order a tie prefers them), at most 256 threads and
# 227 KB of shared memory a block
R = 4
CHANNEL_TILES = (32, 64, 16, 48)
MAX_THREADS = 256
MAX_SMEM = 227 * 1024


def _window(th, tw, kh, kw, sh, sw, dh=1, dw=1):
    return (th - 1) * sh + (kh - 1) * dh + 1, (tw - 1) * sw + (kw - 1) * dw + 1


def _row_pitch(ct, th, nx, iw, sh, sw, eb=1) -> int:
    """The window's row pitch in 4-byte words: its width, rounded up to 16
    bytes, plus the pad that puts the first warp's first read on the fewest
    words of one bank (csrc/qdwconv.cu maps thread -> (channel group, row,
    strip)); `eb` bytes an element (2: the int16 mode, a thread's 4 channels
    two words)."""
    groups = ct // 4
    cw = groups * eb
    base = -(-iw * cw // 4) * 4
    threads = min(32, groups * th * nx)
    best = None
    for pad in range(0, 32, 4):
        rp = base + pad
        banks = {}
        for lane in range(threads):
            q, rest = lane % groups, lane // groups
            ty, sx = rest % th, rest // th
            addr = ty * sh * rp + sx * R * sw * cw + q * eb
            banks.setdefault(addr % 32, set()).add(addr)
        worst = max(len(a) for a in banks.values())
        if best is None or worst < best[0]:
            best = (worst, rp)
    return best[1]


def dw_plan(n, oh, ow, c, kh, kw, sh, sw, eb=1, dh=1, dw=1) -> dict:
    """K5's tile for one call: {"ct": channels, "th": output rows, "tw":
    output columns (R a thread), "rp": window row pitch in words, "threads",
    "blocks", "smem" bytes}.  The channel tile pads C the least (ties: 32,
    64, 16, 48); a block of about 128 threads covers two strips of a row
    (8 columns) and as many rows as that leaves, up to 8 (tools/dw_probe.py
    --plans: blocks of 64 to 128 threads and 1 to 2 K outputs ran fastest at
    MobileNetV2's b8 and b1 calls, the b1 calls too, where such blocks
    leave most SMs idle: smaller ones, a grid that fills the card, ran up to
    1.3x slower); the window is cut until it fits in shared memory.  `eb`:
    bytes an input element (2 for the int16 mode); (dh, dw) the dilation,
    which widens the window and runs the generic body (weights in shared
    memory)."""
    ct = min(CHANNEL_TILES, key=lambda t: (-(-c // t) * t, CHANNEL_TILES.index(t)))
    nx = max(1, min(2, -(-ow // R)))
    th = max(1, min(oh, 8, 128 // (ct // 4 * nx)))

    def blocks(ct, th, nx):
        return n * -(-oh // th) * -(-ow // (R * nx)) * -(-c // ct)

    def smem(ct, th, nx):
        ih, iw = _window(th, R * nx, kh, kw, sh, sw, dh, dw)
        generic = not (kh == kw == 3 and sw in (1, 2) and dh == dw == 1)
        return 4 * (ih * _row_pitch(ct, th, nx, iw, sh, sw, eb)
                    + (kh * kw * ct // 4 if generic else 0))

    while smem(ct, th, nx) > MAX_SMEM and (th > 1 or nx > 1 or ct > 16):
        if th > 1:
            th = -(-th // 2)
        elif nx > 1:
            nx = -(-nx // 2)
        else:
            ct = 16
    if smem(ct, th, nx) > MAX_SMEM:
        raise ValueError(f"qdwconv: a {kh}x{kw} window does not fit in K5's shared memory")
    ih, iw = _window(th, R * nx, kh, kw, sh, sw, dh, dw)
    return dict(ct=ct, th=th, tw=R * nx, rp=_row_pitch(ct, th, nx, iw, sh, sw, eb),
                threads=ct // 4 * th * nx, blocks=blocks(ct, th, nx), smem=smem(ct, th, nx))


def dw_thread_outputs(plan: dict, n, oh, ow, c) -> np.ndarray:
    """The (image, oy, ox, channel) of every output each thread of K5's
    launch at `plan` writes, as csrc/qdwconv.cu maps block and thread to
    them (R pixels along x, 4 channels a thread; those past the image or C
    are not written): an (M, 4) int64 array, one row an output."""
    ct, th, tw = plan["ct"], plan["th"], plan["tw"]
    tiles_x, tiles_y = -(-ow // tw), -(-oh // th)
    cw = ct // 4
    tid = np.arange(cw * th * (tw // R))
    q, rest = tid % cw, tid // cw
    ty, sx = rest % th, rest // th
    bx, by = np.meshgrid(np.arange(n * tiles_y * tiles_x), np.arange(-(-c // ct)), indexing="ij")
    bx, by = bx.reshape(-1, 1), by.reshape(-1, 1)
    tx, rest_b = bx % tiles_x, bx // tiles_x
    tyb, img = rest_b % tiles_y, rest_b // tiles_y
    ch0 = by * ct + 4 * q
    oy = tyb * th + ty
    ox0 = tx * tw + sx * R
    parts = []
    for j in range(R):
        for e in range(4):
            ox, ch = ox0 + j, ch0 + e
            keep = (ch < c) & (oy < oh) & (ox < ow) & (ch0 < c)
            parts.append(np.stack([np.broadcast_to(a, keep.shape)[keep]
                                   for a in (img, oy, ox, ch)], axis=1))
    return np.concatenate(parts)


def dw_acc_plain(x, w, strides, padding, izp, dilation=(1, 1), kzp=None) -> torch.Tensor:
    """int64 accumulator sum (x_pad - izp) * (w - kzp) of a depthwise conv:
    the image minus izp, padded with 0, one strided window per tap (tap (i,
    j) at offset (i dh, j dw)), exact on any device (no float conv, whose
    cuDNN algorithms may round)."""
    kh, kw, _, c = w.shape
    sh, sw = strides
    dh, dw = dilation
    pt, pl, pb, pr = padding
    oh, ow = conv2d_out_hw(x.shape[1], x.shape[2], kh, kw, strides, padding, dilation)
    xp = torch.nn.functional.pad(x.to(torch.int64) - int(izp), (0, 0, pl, pr, pt, pb))
    wk = less_kzp(w, kzp).to(torch.int64).reshape(kh, kw, c)
    acc = torch.zeros((x.shape[0], oh, ow, c), dtype=torch.int64, device=x.device)
    for i in range(kh):
        for j in range(kw):
            acc += xp[:, i * dh:i * dh + sh * (oh - 1) + 1:sh,
                      j * dw:j * dw + sw * (ow - 1) + 1:sw, :] * wk[i, j]
    return acc


def qdwconv_rq_plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0),
                     izp=0, rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128,
                     qmax=127, dilation=(1, 1), kzp=None, out_dtype="int8") -> torch.Tensor:
    """Plain PyTorch version of K5's requantize mode."""
    acc = dw_acc_plain(x, w, strides, padding, izp, dilation, kzp).to(torch.int32)
    return epilogue_plain(acc, bias, mult, shift, rq_izp, out_zp, rounding, qmin, qmax,
                          out_dtype)


def qdwconv_raw_plain(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0),
                      izp=0, dilation=(1, 1), kzp=None) -> torch.Tensor:
    """Plain PyTorch version of K5's raw mode."""
    return (dw_acc_plain(x, w, strides, padding, izp, dilation, kzp)
            + bias.to(torch.int64)).to(torch.int32)


def dw_launch(kernel, x, w, out_dtype, ptrs, strides, padding, izp, dilation=(1, 1), kzp=None,
              **epilogue):
    """Check the operands, launch C entry tk_<kernel> (K5's body: tk_qdwconv_rq,
    tk_qdwconv_raw, K12's tk_qdwconv_direct, or the int16 mode
    tk_qdwconv_wide on int16 x) at `dw_plan`'s tile, count it; returns out.
    K5's modes also take uint8 x, a dilation and kzp (int32 (C,) or None),
    which follows `ptrs` as the entry's last pointer."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    dilation = tuple(int(d) for d in dilation)
    oh, ow = conv2d_out_hw(h, wd, kh, kw, strides, padding, dilation)
    if min(oh, ow) <= 0:
        raise ValueError(f"{kernel}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    legacy = kernel in ("qdwconv_rq", "qdwconv_raw")
    x_dtype, eb = (torch.int16, 2) if kernel == "qdwconv_wide" else (torch.int8, 1)
    if legacy and x.dtype == torch.uint8:
        x_dtype = torch.uint8
    if kernel == "qdwconv_direct" and dilation != (1, 1):
        raise NotImplementedError(f"{kernel}: a dilation runs on K5's modes alone")
    if not legacy and kzp is not None:
        raise NotImplementedError(f"{kernel}: a weight zero point runs on K5's qdwconv_rq / "
                                  "qdwconv_raw alone")
    lo, hi = (0, 256) if x_dtype == torch.uint8 else (-2 ** (8 * eb - 1), 2 ** (8 * eb - 1))
    if not lo <= int(izp) < hi:
        raise ValueError(f"{kernel}: input zero point {izp} is not a value of {x_dtype}")
    ops = dict(x=(x, x_dtype, (n, h, wd, c)), w=(w, torch.int8, (kh, kw, 1, c)))
    ops.update((k, (t, torch.int32, (c,))) for k, t in ptrs.items())
    if kzp is not None:
        ops["kzp"] = (kzp, torch.int32, (c,))
    check_cuda_operands(kernel, x.device, **ops)
    out = torch.empty((n, oh, ow, c), dtype=out_dtype, device=x.device)
    plan = dw_plan(n, oh, ow, c, kh, kw, strides[0], strides[1], eb, *dilation)
    vec4 = c % 4 == 0 and x.data_ptr() % 4 == 0 and w.data_ptr() % 4 == 0
    vec16 = c * eb % 16 == 0 and x.data_ptr() % 16 == 0
    launch(f"tk_{kernel}", [x, w, out, *ptrs.values(), *([kzp] if legacy else [])], dict(
        n=n, h=h, w=wd, cin=c, kh=kh, kw=kw, cout=c, oh=oh, ow=ow, sh=strides[0],
        sw=strides[1], pt=padding[0], pl=padding[1], izp=izp, a_vec=vec4, b_vec=vec16,
        cc=plan["ct"], th=plan["th"], tw=plan["tw"], dw_rp=plan["rp"], dh=dilation[0],
        dw=dilation[1], a_u8=x_dtype == torch.uint8, **epilogue))
    LAUNCHES[kernel] += 1
    return out


def qdwconv_rq(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
               rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127, dilation=(1, 1),
               kzp=None, out_dtype="int8") -> torch.Tensor:
    """K5, requantize mode: clip(q_multiply_shift(acc + bias[c] - rq_izp,
    m[c], s[c]) + out_zp, qmin, qmax) -> int8 (or uint8, `out_dtype`) NHWC,
    acc = sum (x_pad - izp) * (w - kzp) at the dilation.  x int8 or uint8;
    bias / mult / shift int32 (C,); kzp None or int32 (C,)."""
    kw = dict(strides=strides, padding=padding, izp=izp, dilation=tuple(dilation), kzp=kzp)
    check_fill("qdwconv_rq", x, izp, padding, always=True)
    if x.device.type == "cpu":
        return qdwconv_rq_plain(x, w, bias, mult, shift, rq_izp=rq_izp, out_zp=out_zp,
                                rounding=rounding, qmin=qmin, qmax=qmax, out_dtype=out_dtype,
                                **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_rq: no kernel for device {x.device}")
    return dw_launch("qdwconv_rq", x, w, out_torch_dtype(out_dtype),
                     dict(bias=bias, mult=mult, shift=shift), rq_izp=rq_izp, out_zp=out_zp,
                     qmin=qmin, qmax=qmax, tonearest=_TONEAREST[rounding], **kw)


def qdwconv_raw(x, w, bias, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0, dilation=(1, 1),
                kzp=None) -> torch.Tensor:
    """K5, raw mode: the int32 accumulator sum (x_pad - izp) * (w - kzp) at
    the dilation, plus bias[c] in int32 wraparound -> int32 NHWC.  x int8 or
    uint8; bias int32 (C,); kzp None or int32 (C,)."""
    kw = dict(strides=strides, padding=padding, izp=izp, dilation=tuple(dilation), kzp=kzp)
    check_fill("qdwconv_raw", x, izp, padding, always=True)
    if x.device.type == "cpu":
        return qdwconv_raw_plain(x, w, bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"qdwconv_raw: no kernel for device {x.device}")
    return dw_launch("qdwconv_raw", x, w, torch.int32, dict(bias=bias), **kw)
