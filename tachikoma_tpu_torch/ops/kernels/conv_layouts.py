"""K7-K10: the four layouts of the flat conv (port of the layout variants of
`tachikoma_tpu/ops/pallas/conv_flat.py`: `_flat_conv_kernel_t`, `_s`, `_w`,
`_r`, which `_build_flat_conv` selects by `layout`).

All four compute exactly K2's function (`conv.qconv_rq`): the NHWC int8 conv,
int32 accumulator plus bias, the exact requantize epilogue.  They differ in
how the kernel moves data:

  * `qconv_rq_t` (K7, layout "t", `csrc/qconv_layouts_hopper.cu`): the window
    channel-major in shared memory;
  * `qconv_rq_s` (K8, layout "s", `csrc/qconv_layouts.cu`): the block's window
    staged once per channel chunk, each live tap a wgmma on it at the tap's
    row shift;
  * `qconv_rq_w` (K9, layout "w", `csrc/qconv_layouts_hopper.cu`): one wide
    product (wgmma) against the live taps' weights side by side, then shifted
    int32 sums;
  * `qconv_rq_r` (K10, layout "r", `csrc/qconv_layouts.cu`): per live column
    tap, a window staged for that column and its row taps as one deep-K run
    of wgmmas.

All four are defined on the polyphase frame of `_conv_mxu`: a stride-s conv
is a stride-1 conv over the polyphase-stacked image (`phase_image`,
`phase_weights`: exact relabelings), padded with the input zero point and
flattened to the over-wide frame (output row m = n*FH + oh*WP + ow reads input
row m + a*WP + b for tap (a, b)); the garbage columns are dropped after.  The
input zero point folds into the bias.  Unlike the TPU wrapper, channels pad
to a multiple of 16 (not 128) and no width or VMEM padding is added.  No
kernel is handed that frame: each reads the caller's NHWC image and the
weights packed once as (KH, KW, COUT, CIN) (`packed_weights`, cached per
weight tensor), computes the frame's addresses itself
(`csrc/layouts_hopper.cuh`), skips the (chunk, tap) pairs whose phases have no
weight (`live_taps`) and stores straight into (N, OH, OW, COUT).
`flat_operands`, `phase_image`, `phase_weights` and `_unflat` serve the plain
versions only.

Each layout's plain version follows its kernel's decomposition on the flat
operands, so the CPU tests check the decomposition and not only the
dispatch: "s" per 64-channel chunk each live tap's shifted window times that
tap's weights, "w" per chunk one wide product against the chunk's live taps
and shifted int32 sums, "r" per chunk and live column tap the live row taps'
windows side by side times their stacked weights, "t" per-tap products that
contract the channel-major image over its first axis.  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._lib import LAUNCHES, check_cuda_operands, launch, pack_once, refuse_uint8, tile_params
from .matmul_int8 import _TONEAREST, exact_int_matmul, fold_input_zero_point
from .requantize import epilogue_plain

LAYOUTS = ("t", "s", "w", "r")
SMEM_LIMIT = 232448           # 227 KB: the H100's shared memory per block
KC = 64                       # phase channels per chunk
GMAX = 4                      # live taps per step
W_NW = 32                     # K9: window rows per wgmma
W_PPAD = 4                    # K9: int32 padding per row of the partials
T_SROW = 80                   # K7: bytes per staged weight row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


@dataclass(frozen=True)
class FlatGeometry:
    """The flat frame of a conv: output (N, OH, OW); the phase image (N, HPH,
    WPH, C) with C = round_up(SH*SW*CIN, 16); KHP x KWP taps at row offsets
    `offs`; MO over-wide output rows; MX input rows (MO + maxoff, to 16); the
    conv's own KH, KW, SH, SW and CIN."""
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
    kh: int
    kw: int
    sh: int
    sw: int
    cin: int

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
                        _round_up(mo + maxoff, 16), maxoff, kh, kw, sh, sw, cin)


def live_taps(g: FlatGeometry, k0: int) -> list[int]:
    """The taps t = a*KWP + b with a weight in some phase of the 64 phase
    channels from k0 (csrc/qconv_layouts_hopper.cu tap_live): phase (p, q)
    has tap (a, b) when a*SH + p < KH and b*SW + q < KW."""
    phases = range(k0 // g.cin, (min(k0 + KC, g.cin_s) - 1) // g.cin + 1)
    return [a * g.kwp + b for a in range(g.khp) for b in range(g.kwp)
            if any(a * g.sh + ph // g.sw < g.kh and b * g.sw + ph % g.sw < g.kw
                   for ph in phases)]


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
# shared memory (the sums of csrc/qconv_layouts.cu sr_smem and
# csrc/qconv_layouts_hopper.cu smem_bytes)
# ---------------------------------------------------------------------------

def window_rows(layout: str, bm: int, g: FlatGeometry) -> int:
    """The frame rows of K8's or K10's K-slice-major window, rounded to a
    core matrix's 8: K8 every tap's shift (maxoff) past the block's BM rows,
    K10 its row taps' shifts ((KHP-1)*WPH) from the column tap's row."""
    reach = (g.khp - 1) * g.wph if layout == "r" else g.maxoff
    return _round_up(bm + reach, 8)


def smem_bytes(layout: str, tile, g: FlatGeometry, group: int = 1) -> int:
    """Dynamic shared memory of `layout` at `tile` with `group` live taps per
    step: K8 and K10 two windows and two weight tiles; K9 two windows of BM +
    maxoff rows rounded to its wgmma's 32, two weight tiles and the int32
    partials; K7 two NHWC windows, the channel-major window and two weight
    tiles."""
    bm, bn = tile
    if layout in ("s", "r"):
        return 2 * window_rows(layout, bm, g) * KC + 2 * group * bn * KC
    if layout == "w":
        rows = _round_up(bm + g.maxoff, W_NW)
        return 2 * rows * KC + 2 * group * bn * KC + rows * (group * bn + W_PPAD) * 4
    rows4 = _round_up(bm + g.maxoff, 4)
    xs = _round_up(rows4 + 4, 32) + 8
    return 2 * rows4 * KC + KC * xs + 2 * group * bn * T_SROW


def layout_group(layout: str, tile, g: FlatGeometry) -> int:
    """The most live taps per step the layout's kernel may take within shared
    memory (up to 4; for K9 up to 256 / BN, wgmma's widest N; for K10 up to
    KHP, a step's taps lying in one column); 0 when not even one fits (the
    tile is then refused).  The launcher runs this many or fewer, from a cost
    model of its occupancy (csrc/layouts_hopper.cuh plan_launch)."""
    cap = min(GMAX, g.khp * g.kwp)
    if layout == "w":
        cap = min(cap, 256 // tile[1])
    elif layout == "r":
        cap = min(cap, g.khp)
    if g.khp * g.kwp > 255:
        return 0
    fits = [grp for grp in range(1, cap + 1) if smem_bytes(layout, tile, g, grp) <= SMEM_LIMIT]
    return max(fits, default=0)


def layout_fits(layout: str, blocks, x_shape, w_shape, strides, padding) -> bool:
    """Whether `layout` at `blocks` fits the H100's shared memory for this
    conv (at least one live tap per step)."""
    g = flat_geometry(x_shape, w_shape, strides, padding)
    return layout_group(layout, (int(blocks[0]), int(blocks[1])), g) > 0


# ---------------------------------------------------------------------------
# plain versions: each layout's decomposition of the accumulator
# ---------------------------------------------------------------------------

def _wrap32(acc64: torch.Tensor) -> torch.Tensor:
    return acc64.to(torch.int32)


def acc_s(xf, wl, g: FlatGeometry) -> torch.Tensor:
    """Per chunk of 64 phase channels, each live tap's window at its row
    shift times that tap's weights, summed (the zero taps skipped)."""
    offs = g.offs
    acc = torch.zeros((g.mo, wl.shape[1]), dtype=torch.int64, device=xf.device)
    for lo in range(0, g.cin_s, KC):
        hi = min(lo + KC, g.c)
        for t in live_taps(g, lo):
            acc += exact_int_matmul(xf[offs[t]:offs[t] + g.mo, lo:hi],
                                    wl[t * g.c + lo:t * g.c + hi]).to(torch.int64)
    return _wrap32(acc)


def acc_w(xf, wl, g: FlatGeometry) -> torch.Tensor:
    """Per chunk of 64 phase channels, one wide product (MX, 64) x (64,
    L*COUT) against the chunk's L live taps side by side, then each output
    sums those taps' int32 partials at their row shifts (the other taps'
    weights in the chunk are zero)."""
    cout = wl.shape[1] // (g.khp * g.kwp)
    offs = g.offs
    acc = torch.zeros((g.mo, cout), dtype=torch.int64, device=xf.device)
    for k0 in range(0, g.cin_s, KC):
        taps = live_taps(g, k0)
        cols = torch.cat([wl[k0:k0 + KC, t * cout:(t + 1) * cout] for t in taps], dim=1)
        wide = exact_int_matmul(xf[:, k0:k0 + KC], cols).to(torch.int64)  # (MX, L*COUT)
        for j, t in enumerate(taps):
            acc += wide[offs[t]:offs[t] + g.mo, j * cout:(j + 1) * cout]
    return _wrap32(acc)


def acc_r(xf, wl, g: FlatGeometry) -> torch.Tensor:
    """Per chunk and live column tap b, the live row taps' windows (from frame
    row a*WPH + b) side by side times their stacked weights from the (kx, ky,
    ci) weight matrix: one deep-K product per (chunk, b)."""
    acc = torch.zeros((g.mo, wl.shape[1]), dtype=torch.int64, device=xf.device)
    for lo in range(0, g.cin_s, KC):
        hi = min(lo + KC, g.c)
        live = live_taps(g, lo)
        for b in range(g.kwp):
            rows = [a for a in range(g.khp) if a * g.kwp + b in live]
            if not rows:
                continue
            patch = torch.cat([xf[a * g.wph + b:a * g.wph + b + g.mo, lo:hi] for a in rows], 1)
            base = [(b * g.khp + a) * g.c for a in rows]
            w = torch.cat([wl[r + lo:r + hi] for r in base], 0)
            acc += exact_int_matmul(patch, w).to(torch.int64)
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
    tile = tile_params(blocks)
    refuse_uint8(name, x)
    if x.device.type == "cpu":
        return _layout_plain(layout, x, w, bias, mult, shift, strides, padding, izp, rq_izp,
                             out_zp, rounding, qmin, qmax)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    kh, kw, cin, cout = w.shape
    i32 = torch.int32
    check_cuda_operands(name, x.device, x=(x, torch.int8, (*x.shape[:3], cin)),
                        w=(w, torch.int8, (kh, kw, cin, cout)), bias=(bias, i32, (cout,)),
                        mult=(mult, i32, (cout,)), shift=(shift, i32, (cout,)))
    g = flat_geometry(x.shape, w.shape, strides, padding)
    if x.ndim != 4 or min(g.oh, g.ow) <= 0:
        raise ValueError(f"{name}: bad geometry {tuple(x.shape)} * {tuple(w.shape)}")
    group = layout_group(layout, (tile["bm"], tile["bn"]), g)
    if group == 0:
        raise ValueError(f"{name}: tile {tuple(blocks or ())} does not fit shared memory "
                         f"(window {g.maxoff} rows past the block)")
    wk, b, out = layout_operands(x, w, bias, izp, g)
    n, h, wd, _ = x.shape
    launch(f"tk_{name}", [x, wk, out, b, mult, shift], dict(
        n=n, h=h, w=wd, cin=cin, kh=kh, kw=kw, cout=cout, oh=g.oh, ow=g.ow, sh=strides[0],
        sw=strides[1], pt=padding[0], pl=padding[1], izp=izp, group=group,
        a_vec=cin % 16 == 0 and x.data_ptr() % 16 == 0, rq_izp=rq_izp, out_zp=out_zp,
        qmin=qmin, qmax=qmax, tonearest=_TONEAREST[rounding], **tile))
    LAUNCHES[name] += 1
    return out


# id(weight tensor) -> (a weak reference to it, its _version when packed, the
# packed tensor); keyed by id because a tensor's == is elementwise
_PACKED: dict = {}


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """w (KH, KW, CIN, COUT) packed K-major as (KH, KW, COUT, CIN), the layout
    K7-K10 stage their [n][k] weight tiles from with 16-byte copies; made
    once per weight tensor (`pack_once`)."""
    return pack_once(_PACKED, w, lambda w: w.permute(0, 1, 3, 2).contiguous())


def layout_operands(x, w, bias, izp, g: FlatGeometry):
    """All K7's to K10's wrappers do on the card besides the launch: the
    packed weights (a cache lookup after the first call), the bias with the
    input zero point folded in (a few small kernels when izp != 0, else the
    bias itself) and the empty (N, OH, OW, COUT) output."""
    out = torch.empty((g.n, g.oh, g.ow, w.shape[3]), dtype=torch.int8, device=x.device)
    return packed_weights(w), fold_input_zero_point(bias, w, izp), out


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
