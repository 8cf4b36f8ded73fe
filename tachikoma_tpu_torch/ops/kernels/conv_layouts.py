"""K7-K10: the four layouts of the flat conv (port of the layout variants of
`tachikoma_tpu/ops/pallas/conv_flat.py`: `_flat_conv_kernel_t`, `_s`, `_w`,
`_r`, which `_build_flat_conv` selects by `layout`).

All four compute exactly K2's function (`conv.qconv_rq`): the NHWC int8 conv,
int32 accumulator plus bias, the exact requantize epilogue.  They differ in
how the kernel moves data (`csrc/qconv_layouts.cu`):

  * `qconv_rq_t` (K7, layout "t"): the image channel-major, (C, MX);
  * `qconv_rq_s` (K8, layout "s"): the block's input window staged once per
    channel chunk, every tap read from shared memory;
  * `qconv_rq_w` (K9, layout "w"): one wide product against the taps' weights
    side by side, then shifted int32 sums;
  * `qconv_rq_r` (K10, layout "r"): K in (kx, ky, ci) order, each column
    tap's row taps one deep-K run.

The wrappers build the kernels' operands as `_conv_mxu` does: a stride-s conv
becomes a stride-1 conv over the polyphase-stacked image (`phase_image`,
`phase_weights`: exact relabelings), padded with the input zero point and
flattened to the over-wide frame (output row m = n*FH + oh*WP + ow reads input
row m + a*WP + b for tap (a, b)); the garbage columns are sliced off after.
The input zero point folds into the bias.  Unlike the TPU wrapper, channels
pad to a multiple of 16 (not 128) and no width or VMEM padding is added.

Each layout's plain version follows its kernel's decomposition on the same
flat operands, so the CPU tests check the decomposition and not only the
dispatch: "s" an explicit im2col and one product, "w" one wide product and
shifted int32 sums, "r" one deep-K product per column tap, "t" per-tap
products that contract the channel-major image over its first axis.  On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._lib import BK, LAUNCHES, check_cuda_operands, launch, tile_params
from .matmul_int8 import _TONEAREST, exact_int_matmul, fold_input_zero_point
from .requantize import epilogue_plain

LAYOUTS = ("t", "s", "w", "r")
SROW = BK + 16                # shared-memory row stride of the kernels, bytes
SMEM_LIMIT = 232448           # 227 KB: the H100's shared memory per block
W_PPAD = 4                    # int32 padding per row of K9's partials


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclass(frozen=True)
class FlatGeometry:
    """The flat frame of a conv: output (N, OH, OW); the phase image (N, HPH,
    WPH, C) with C = round_up(SH*SW*CIN, 16); KHP x KWP taps at row offsets
    `offs`; MO over-wide output rows; MX input rows (MO + maxoff, to 16)."""
    n: int
    oh: int
    ow: int
    khp: int
    kwp: int
    hph: int
    wph: int
    cin_s: int
    c: int
    mo: int
    mx: int
    maxoff: int

    @property
    def offs(self) -> list[int]:
        return [a * self.wph + b for a in range(self.khp) for b in range(self.kwp)]


def flat_geometry(x_shape, w_shape, strides, padding) -> FlatGeometry:
    """`_phase_geometry` + `_flat_lengths` of conv_flat.py, without the TPU's
    padding of the width to 4 and of the rows to the M block."""
    n, h, wd, cin = x_shape
    kh, kw = w_shape[0], w_shape[1]
    sh, sw = strides
    pt, pl, pb, pr = padding
    oh = (h + pt + pb - kh) // sh + 1
    ow = (wd + pl + pr - kw) // sw + 1
    khp, kwp = _cdiv(kh, sh), _cdiv(kw, sw)
    hph, wph = oh + khp - 1, ow + kwp - 1
    cin_s = sh * sw * cin
    maxoff = (khp - 1) * wph + kwp - 1
    mo = n * hph * wph
    return FlatGeometry(n, oh, ow, khp, kwp, hph, wph, cin_s, _round_up(cin_s, 16), mo,
                        _round_up(mo + maxoff, 16), maxoff)


def phase_image(x, g: FlatGeometry, strides, padding, izp) -> torch.Tensor:
    """(N,H,W,CIN) -> (N, HPH, WPH, SH*SW*CIN) phase-stacked stride-1 image,
    every pad byte the input zero point (conv_flat.py `_phase_stack`; rows or
    columns that no output reads are cropped)."""
    n, h, wd, c = x.shape
    sh, sw = strides
    pt, pl = padding[0], padding[1]
    hs, ws = g.hph * sh, g.wph * sw
    xp = torch.nn.functional.pad(x, (0, 0, pl, ws - wd - pl, pt, hs - h - pt), value=int(izp))
    if (sh, sw) == (1, 1):
        return xp
    xr = xp.reshape(n, g.hph, sh, g.wph, sw, c).permute(0, 1, 3, 2, 4, 5)
    return xr.reshape(n, g.hph, g.wph, sh * sw * c)


def phase_weights(w, strides) -> torch.Tensor:
    """(KH,KW,CIN,COUT) -> (KHP,KWP,SH*SW*CIN,COUT): tap (a, b) of phase
    (p, q) is w[a*SH + p, b*SW + q], zero where out of range
    (conv_flat.py `_phase_weights`)."""
    kh, kw, cin, cout = w.shape
    sh, sw = strides
    if (sh, sw) == (1, 1):
        return w
    khp, kwp = _cdiv(kh, sh), _cdiv(kw, sw)
    wp = torch.zeros((khp, kwp, sh, sw, cin, cout), dtype=w.dtype, device=w.device)
    for p in range(sh):
        for q in range(sw):
            na, nb = _cdiv(kh - p, sh), _cdiv(kw - q, sw)
            if na > 0 and nb > 0:
                wp[:na, :nb, p, q] = w[p::sh, q::sw]
    return wp.reshape(khp, kwp, sh * sw * cin, cout)


def flat_operands(x, w, layout: str, strides, padding, izp):
    """The kernel operands of `layout`: the flat image (MX, C), or (C, MX)
    for "t", and the weights as a matrix: (T*C, COUT) in (ky, kx, ci) order
    for "s" and "t", (KWP*KHP*C, COUT) in (kx, ky, ci) order for "r",
    (C, T*COUT) for "w".  Returns (xf, wl, geometry)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    g = flat_geometry(x.shape, w.shape, strides, padding)
    cout = w.shape[3]
    xs = phase_image(x, g, strides, padding, izp)
    xf = torch.nn.functional.pad(xs, (0, g.c - g.cin_s)).reshape(g.mo, g.c)
    xf = torch.nn.functional.pad(xf, (0, 0, 0, g.mx - g.mo))
    xf = xf.t().contiguous() if layout == "t" else xf.contiguous()
    wp = torch.nn.functional.pad(phase_weights(w, strides), (0, 0, 0, g.c - g.cin_s))
    taps = g.khp * g.kwp
    if layout == "w":
        wl = wp.permute(2, 0, 1, 3).reshape(g.c, taps * cout)
    elif layout == "r":
        wl = wp.permute(1, 0, 2, 3).reshape(taps * g.c, cout)
    else:
        wl = wp.reshape(taps * g.c, cout)
    return xf, wl.contiguous(), g


# ---------------------------------------------------------------------------
# shared memory (the sums of csrc/qconv_layouts.cu smem_bytes)
# ---------------------------------------------------------------------------

def smem_bytes(layout: str, tile, g: FlatGeometry, group: int = 1) -> int:
    bm, bn = tile
    if layout == "s":
        return (bm + g.maxoff + bn) * SROW
    if layout == "t":
        return BK * (_round_up(bm + g.maxoff, 16) + 16) + (bm + bn) * SROW
    if layout == "r":
        return (bm + (g.khp - 1) * g.wph + g.khp * bn) * SROW
    rows = _round_up(bm + g.maxoff, 16)
    return (rows + group * bn) * SROW + rows * (group * bn + W_PPAD) * 4


def w_group(tile, g: FlatGeometry) -> int:
    """K9's taps per pass: the most whose partials fit in shared memory, 0
    when not even one tap's do (the tile is then refused)."""
    best = 0
    for group in range(1, g.khp * g.kwp + 1):
        if smem_bytes("w", tile, g, group) <= SMEM_LIMIT:
            best = group
    return best


def layout_fits(layout: str, blocks, x_shape, w_shape, strides, padding) -> bool:
    """Whether `layout` at `blocks` fits the H100's shared memory for this
    conv (K9 needs at least one tap's partials; K7, K8 and K10 a window)."""
    g = flat_geometry(x_shape, w_shape, strides, padding)
    tile = (int(blocks[0]), int(blocks[1]))
    if layout == "w":
        return w_group(tile, g) > 0
    return smem_bytes(layout, tile, g) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# plain versions: each layout's decomposition of the accumulator
# ---------------------------------------------------------------------------

def _wrap32(acc64: torch.Tensor) -> torch.Tensor:
    return acc64.to(torch.int32)


def acc_s(xf, wl, g: FlatGeometry) -> torch.Tensor:
    """Explicit im2col of the flat frame, then one product."""
    cols = torch.cat([xf[o:o + g.mo] for o in g.offs], dim=1)       # (MO, T*C)
    return exact_int_matmul(cols, wl)


def acc_w(xf, wl, g: FlatGeometry) -> torch.Tensor:
    """One wide product (MX, C) x (C, T*COUT), then each output sums its
    taps' int32 partials at their row shifts."""
    cout = wl.shape[1] // (g.khp * g.kwp)
    wide = exact_int_matmul(xf, wl).to(torch.int64)                  # (MX, T*COUT)
    acc = torch.zeros((g.mo, cout), dtype=torch.int64, device=xf.device)
    for t, o in enumerate(g.offs):
        acc += wide[o:o + g.mo, t * cout:(t + 1) * cout]
    return _wrap32(acc)


def acc_r(xf, wl, g: FlatGeometry) -> torch.Tensor:
    """Per column tap b, the KHP row windows side by side (MO, KHP*C) times
    that tap's (KHP*C, COUT) run of the (kx, ky, ci) weights."""
    run = g.khp * g.c
    acc = torch.zeros((g.mo, wl.shape[1]), dtype=torch.int64, device=xf.device)
    for b in range(g.kwp):
        patch = torch.cat([xf[a * g.wph + b:a * g.wph + b + g.mo] for a in range(g.khp)], dim=1)
        acc += exact_int_matmul(patch, wl[b * run:(b + 1) * run]).to(torch.int64)
    return _wrap32(acc)


def acc_t(xt, wl, g: FlatGeometry) -> torch.Tensor:
    """Channel-major image (C, MX): per tap, the (C, MO) window at the tap's
    shift along M, contracted over its first axis with the tap's weights."""
    acc = torch.zeros((g.mo, wl.shape[1]), dtype=torch.int64, device=xt.device)
    for t, o in enumerate(g.offs):
        acc += exact_int_matmul(xt[:, o:o + g.mo].t(), wl[t * g.c:(t + 1) * g.c]).to(torch.int64)
    return _wrap32(acc)


_ACC = {"s": acc_s, "w": acc_w, "r": acc_r, "t": acc_t}


def _unflat(out, g: FlatGeometry) -> torch.Tensor:
    """Over-wide (MO, COUT) -> (N, OH, OW, COUT)."""
    return out.reshape(g.n, g.hph, g.wph, -1)[:, :g.oh, :g.ow].contiguous()


def _layout_plain(layout, x, w, bias, mult, shift, strides, padding, izp, rq_izp, out_zp,
                  rounding, qmin, qmax):
    xf, wl, g = flat_operands(x, w, layout, strides, padding, izp)
    acc = _ACC[layout](xf, wl, g)
    out = epilogue_plain(acc, fold_input_zero_point(bias, w, izp), mult, shift, rq_izp, out_zp,
                         rounding, qmin, qmax)
    return _unflat(out, g)


def _layout_kernel(layout, x, w, bias, mult, shift, strides, padding, izp, rq_izp, out_zp,
                   rounding, qmin, qmax, blocks):
    name = f"qconv_rq_{layout}"
    strides, padding = tuple(strides), tuple(padding)
    kw = dict(strides=strides, padding=padding, izp=izp, rq_izp=rq_izp, out_zp=out_zp,
              rounding=rounding, qmin=qmin, qmax=qmax)
    tile = tile_params(blocks)
    if x.device.type == "cpu":
        return _layout_plain(layout, x, w, bias, mult, shift, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    kh, kw_, cin, cout = w.shape
    i32 = torch.int32
    check_cuda_operands(name, x.device, x=(x, torch.int8, (*x.shape[:3], cin)),
                        w=(w, torch.int8, (kh, kw_, cin, cout)), bias=(bias, i32, (cout,)),
                        mult=(mult, i32, (cout,)), shift=(shift, i32, (cout,)))
    g = flat_geometry(x.shape, w.shape, strides, padding)
    if x.ndim != 4 or min(g.oh, g.ow) <= 0:
        raise ValueError(f"{name}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    group = 1
    if layout == "w":
        group = w_group((tile["bm"], tile["bn"]), g)
        if group == 0:
            raise ValueError(f"{name}: tile {tuple(blocks or ())} does not fit shared memory "
                             f"(window {g.maxoff} rows past the block)")
    elif smem_bytes(layout, (tile["bm"], tile["bn"]), g) > SMEM_LIMIT:
        raise ValueError(f"{name}: the window of {tuple(x.shape)} * {tuple(w.shape)} does not "
                         "fit shared memory")
    xf, wl, g = flat_operands(x, w, layout, strides, padding, izp)
    out = torch.empty((g.mo, cout), dtype=torch.int8, device=x.device)
    launch(f"tk_{name}", [xf, wl, out, fold_input_zero_point(bias, w, izp), mult, shift], dict(
        mo=g.mo, mx=g.mx, cin=g.c, wp=g.wph, kh=g.khp, kw=g.kwp, cout=cout, group=group,
        b_vec=cout % 4 == 0, rq_izp=rq_izp, out_zp=out_zp, qmin=qmin, qmax=qmax,
        tonearest=_TONEAREST[rounding], **tile))
    LAUNCHES[name] += 1
    return _unflat(out, g)


def _make(layout: str):
    def plain(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
              rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127, blocks=None):
        return _layout_plain(layout, x, w, bias, mult, shift, tuple(strides), tuple(padding),
                             izp, rq_izp, out_zp, rounding, qmin, qmax)

    def kernel(x, w, bias, mult, shift, *, strides=(1, 1), padding=(0, 0, 0, 0), izp=0,
               rq_izp=0, out_zp=0, rounding="UPWARD", qmin=-128, qmax=127, blocks=None):
        return _layout_kernel(layout, x, w, bias, mult, shift, strides, padding, izp, rq_izp,
                              out_zp, rounding, qmin, qmax, blocks)

    plain.__name__, kernel.__name__ = f"qconv_rq_{layout}_plain", f"qconv_rq_{layout}"
    plain.__doc__ = f"Plain PyTorch version of layout {layout!r} (its kernel's decomposition)."
    kernel.__doc__ = (f"Layout {layout!r} of K2's function: x int8 NHWC, w int8 HWIO, bias / "
                      "mult / shift int32 (COUT,); padding (top, left, bottom, right); blocks "
                      "(BM, BN, 64) a compiled tile (default 64 x 64) -> int8 NHWC.")
    return plain, kernel


qconv_rq_t_plain, qconv_rq_t = _make("t")   # K7
qconv_rq_s_plain, qconv_rq_s = _make("s")   # K8
qconv_rq_w_plain, qconv_rq_w = _make("w")   # K9
qconv_rq_r_plain, qconv_rq_r = _make("r")   # K10
