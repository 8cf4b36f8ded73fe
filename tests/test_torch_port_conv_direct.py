"""K11 and K12's plain versions (the port's `qconv2d_int8` on CPU tensors)
against the JAX package's `qconv2d_int8` (ops/pallas/conv_int8.py), which runs
`_conv_kernel` / `_dw_kernel` in interpret mode on the CPU, as
tests/test_pallas_conv.py runs it; and `tune_conv` against the JAX package's.

Outputs are compared with ==: the direct conv is exact integer arithmetic.

The port's `qconv2d_supported` is its own: it admits every groups-1 and
depthwise geometry whose staged tiles fit the H100's 227 KB of shared memory,
so it says True for (1, 224, 224, 64) 3x3, which the JAX predicate refuses
because the whole padded image would not fit the TPU's VMEM budget."""

import json

import numpy as np
import pytest
import torch

from tachikoma_tpu.ops.pallas import conv_int8 as j_conv
from tachikoma_tpu.ops.pallas.qms32 import plan_requantize as j_plan_requantize
from tachikoma_tpu.tune import database as j_db
from tachikoma_tpu.tune import tuner as j_tuner
from tachikoma_tpu_torch.ops.kernels import conv_direct, depthwise
from tachikoma_tpu_torch.ops.kernels.requantize import plan_requantize
from tachikoma_tpu_torch.tune import database as p_db
from tachikoma_tpu_torch.tune import tuner as p_tuner


def _both(rng, shape, wshape, strides, padding, groups, *, izp=0, out_zp=4, rounding="UPWARD",
          out_dtype="int8", qmin=-128, qmax=127, scale_decades=0.0, bias=True):
    """(port, JAX) outputs of qconv2d_int8 on the same numpy inputs."""
    cout = wshape[3]
    x = rng.integers(-128, 128, shape).astype(np.int8)
    w = rng.integers(-127, 127, wshape).astype(np.int8)
    b = rng.integers(-2000, 2000, cout).astype(np.int32) if bias else None
    scales = (0.0002 + np.abs(rng.standard_normal(cout)) * 0.0005) * 10 ** rng.uniform(
        0, scale_decades, cout)
    m, s = j_plan_requantize(scales, 0.07)
    pm, ps = plan_requantize(scales, 0.07)
    assert np.array_equal(m, pm) and np.array_equal(s, ps)
    kw = dict(strides=strides, padding=padding, groups=groups, input_zero_point=izp,
              out_zp=out_zp, rounding=rounding, out_dtype=out_dtype, qmin=qmin, qmax=qmax)
    got = conv_direct.qconv2d_int8(torch.from_numpy(x), w, bias=b, multiplier=m, shift=s, **kw)
    want = np.asarray(j_conv.qconv2d_int8(x, w, bias=b, multiplier=m, shift=s, **kw))
    assert got.dtype == getattr(torch, out_dtype) and want.dtype == np.dtype(out_dtype)
    return got.numpy(), want, s


@pytest.mark.parametrize(
    "shape,strides,padding,groups",
    [
        ((1, 14, 14, 64), (1, 1), (1, 1, 1, 1), 1),
        ((2, 9, 9, 32), (2, 2), (1, 1, 1, 1), 1),
        ((1, 8, 8, 40), (1, 1), (0, 0, 0, 0), 1),    # unaligned cin/cout
        ((1, 12, 12, 128), (1, 1), (1, 1, 1, 1), 128),  # depthwise
        ((1, 11, 11, 96), (2, 2), (1, 1, 1, 1), 96),    # depthwise stride 2
    ],
)
def test_qconv_equals_the_jax_kernel(rng, shape, strides, padding, groups):
    """tests/test_pallas_conv.py's five shapes."""
    cin = shape[3]
    cout = cin if groups > 1 else 48
    got, want, _ = _both(rng, shape, (3, 3, cin // groups, cout), strides, padding, groups)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,wshape,groups", [((1, 8, 8, 32), (3, 3, 32, 32), 1),
                                                 ((1, 9, 9, 48), (3, 3, 1, 48), 48)])
def test_input_zero_point_pads_the_border_and_folds_into_the_bias(rng, shape, wshape, groups):
    got, want, _ = _both(rng, shape, wshape, (1, 1), (1, 1, 1, 1), groups, izp=-9, bias=False)
    np.testing.assert_array_equal(got, want)
    got, want, _ = _both(rng, shape, wshape, (2, 2), (1, 2, 0, 1), groups, izp=77)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("shape,wshape,strides,groups", [
    ((2, 10, 10, 24), (3, 3, 24, 72), (1, 1), 1),
    ((2, 10, 10, 72), (3, 3, 1, 72), (2, 2), 72)])
def test_per_channel_shifts_and_rounding(rng, rounding, shape, wshape, strides, groups):
    got, want, shift = _both(rng, shape, wshape, strides, (1, 1, 1, 1), groups,
                             rounding=rounding, scale_decades=3.0)
    assert len(set(np.asarray(shift).tolist())) >= 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 32])
def test_uint8_output(rng, groups):
    shape = (1, 9, 9, 32)
    wshape = (3, 3, 32 // groups, 32)
    got, want, _ = _both(rng, shape, wshape, (1, 1), (1, 1, 1, 1), groups, out_dtype="uint8",
                         out_zp=128, qmin=0, qmax=255)
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 255 and (got > 127).any()


@pytest.mark.parametrize("shape,wshape,strides,padding", [
    ((1, 9, 9, 24), (1, 1, 24, 40), (1, 1), (0, 0, 0, 0)),       # 1x1
    ((1, 9, 9, 24), (1, 1, 24, 40), (2, 2), (0, 0, 0, 0)),       # 1x1 s2 (ResNet's down)
    ((2, 20, 20, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3)),       # the ResNet stem, CIN 3
    ((1, 12, 12, 3), (3, 3, 3, 64), (1, 1), (1, 1, 1, 1)),       # VGG's first conv, CIN 3
])
def test_kernel_sizes_and_the_cin3_stem(rng, shape, wshape, strides, padding):
    got, want, _ = _both(rng, shape, wshape, strides, padding, 1, izp=3)
    np.testing.assert_array_equal(got, want)


def test_grouped_but_not_depthwise_raises(rng):
    x = rng.integers(-128, 128, (1, 8, 8, 32)).astype(np.int8)
    w = rng.integers(-127, 127, (3, 3, 16, 32)).astype(np.int8)
    m, s = plan_requantize(0.0004, 0.05)
    for fn in (j_conv.qconv2d_int8, conv_direct.qconv2d_int8, conv_direct.qconv2d_int8_plain):
        with pytest.raises(NotImplementedError, match="groups==1 or depthwise"):
            fn(torch.from_numpy(x) if fn is not j_conv.qconv2d_int8 else x, w, multiplier=m,
               shift=s, padding=(1, 1, 1, 1), groups=2)
    assert not conv_direct.qconv2d_supported((1, 8, 8, 32), (3, 3, 16, 32), (1, 1),
                                             (1, 1, 1, 1), 2)
    with pytest.raises(ValueError, match="multiplier"):
        conv_direct.qconv2d_int8(torch.from_numpy(x), w[:, :, :1], groups=32)


def test_supported_predicate():
    port, jax_ = conv_direct.qconv2d_supported, j_conv.qconv2d_supported
    for args in [((1, 56, 56, 128), (3, 3, 128, 128), (1, 1), (1, 1, 1, 1), 1),
                 ((1, 56, 56, 96), (3, 3, 1, 96), (1, 1), (1, 1, 1, 1), 96)]:
        assert port(*args) and jax_(*args)
    # a whole padded 226^2 x 128-lane image exceeds the TPU's VMEM budget;
    # K11 stages one 10 x 10 window per 8 x 8 output tile
    big = ((1, 224, 224, 64), (3, 3, 64, 64), (1, 1), (1, 1, 1, 1), 1)
    assert port(*big) and not jax_(*big)
    # the JAX predicate refuses a stride-2 depthwise conv that its function computes
    dw2 = ((1, 112, 112, 96), (3, 3, 1, 96), (2, 2), (0, 1, 0, 1), 96)
    assert port(*dw2) and not jax_(*dw2)
    assert not port((1, 4, 4, 8), (7, 7, 8, 8), (1, 1), (0, 0, 0, 0), 1)  # empty output


@pytest.mark.parametrize("cin,k,s,cc", [(3, 3, 1, 64), (3, 7, 2, 64), (8, 3, 1, 64), (16, 3, 1, 64),
                                         (64, 3, 1, 64), (512, 3, 1, 64), (64, 7, 1, 64),
                                         (64, 11, 1, 64), (40, 3, 1, 64), (4, 20, 4, 4)])
def test_k11_chunk_fits_shared_memory(cin, k, s, cc):
    """The Hopper path's 64-channel chunks wherever its window and one tap
    of weights fit at BN 64; the narrow path's chunk where they do not (a
    20x20 kernel at stride 4: 16 phases of 20 x 16 pixels)."""
    assert conv_direct.direct_chunk(cin, k, k, (s, s)) == cc
    if cc == conv_direct.KC:
        assert conv_direct.direct_smem(64, 1, cin, k, k, (s, s)) <= conv_direct.SMEM_LIMIT
    else:
        assert conv_direct.direct_smem(64, 1, cin, k, k, (s, s)) > conv_direct.SMEM_LIMIT
        assert conv_direct.narrow_smem(cc, k, k, (s, s)) <= conv_direct.SMEM_LIMIT


def _window_conv(x, w, strides, padding, izp):
    """K11's Hopper data path in numpy: for every 16 x 8 output tile and
    chunk of 64 input channels, the window staged deinterleaved into its
    phases (`direct_geometry`; the padding pixels of each phase row hold
    garbage, never read), then every tap read at its window offset
    (`direct_taps`) for all 128 output pixels and multiplied with its
    weights.  Returns the int64 sum of x_pad * w (izp outside the image)."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    sh, sw = strides
    pt, pl, pb, pr = padding
    oh, ow = (h + pt + pb - kh) // sh + 1, (wd + pl + pr - kw) // sw + 1
    g = conv_direct.direct_geometry(cin, kh, kw, strides)
    taps = conv_direct.direct_taps(kh, kw, strides)
    tr, tc = conv_direct.TILE_ROWS, conv_direct.TILE_COLS
    rng = np.random.default_rng(1)
    acc = np.zeros((n, -(-oh // tr) * tr, -(-ow // tc) * tc, cout), np.int64)
    rr, cc = np.meshgrid(np.arange(tr), np.arange(tc), indexing="ij")
    for img in range(n):
        for oy0 in range(0, oh, tr):
            for ox0 in range(0, ow, tc):
                iy0, ix0 = oy0 * sh - pt, ox0 * sw - pl
                for ch in range(g["nch"]):
                    c0, c1 = ch * conv_direct.KC, min(cin, (ch + 1) * conv_direct.KC)
                    win = rng.integers(-128, 128, (g["npix"], c1 - c0))
                    for ph in range(g["lph"] * g["lpw"]):
                        p, q = divmod(ph, g["lpw"])
                        for i in range(g["ph_rows"]):
                            for j in range(g["real_cols"]):
                                iy, ix = iy0 + i * sh + p, ix0 + j * sw + q
                                inside = 0 <= iy < h and 0 <= ix < wd
                                win[ph * g["ph_pix"] + i * g["ph_cols"] + j] = (
                                    x[img, iy, ix, c0:c1] if inside else izp)
                    for t, (ph, a, b, off) in enumerate(taps):
                        ky, kx = divmod(t, kw)
                        assert (ky, kx) == (a * sh + ph // g["lpw"], b * sw + ph % g["lpw"])
                        rows = win[off + rr * g["ph_cols"] + cc]          # (16, 8, chunk)
                        acc[img, oy0:oy0 + tr, ox0:ox0 + tc] += rows @ w[ky, kx, c0:c1]
    return acc[:, :oh, :ow]


@pytest.mark.parametrize("shape,wshape,strides,padding,izp", [
    ((1, 14, 14, 40), (3, 3, 40, 8), (1, 1), (1, 1, 1, 1), 5),      # stride 1, 3x3
    ((2, 11, 9, 72), (3, 3, 72, 8), (2, 2), (1, 1, 1, 1), -3),      # stride 2: 4 phases, 2 chunks
    ((1, 20, 20, 3), (7, 7, 3, 8), (2, 2), (3, 3, 3, 3), 7),        # the CIN-3 stem
    ((1, 9, 9, 16), (1, 1, 16, 8), (2, 2), (0, 0, 0, 0), 0),        # 1x1 s2: one live phase
    ((1, 13, 17, 8), (5, 4, 8, 8), (3, 2), (2, 1, 2, 3), -9),       # strides 3 x 2, 5x4
])
def test_k11_tap_plan_reproduces_the_conv(rng, shape, wshape, strides, padding, izp):
    x = rng.integers(-128, 128, shape).astype(np.int64)
    w = rng.integers(-127, 128, wshape).astype(np.int64)
    got = _window_conv(x, w, strides, padding, izp)
    want = conv_direct.conv_acc_plain(torch.from_numpy(x.astype(np.int8)),
                                      torch.from_numpy(w.astype(np.int8)), strides, padding,
                                      izp).numpy().astype(np.int64)
    np.testing.assert_array_equal(got - izp * w.sum((0, 1, 2)), want)


@pytest.mark.parametrize("wshape", [(3, 3, 64, 48), (3, 3, 3, 64), (7, 7, 40, 24), (1, 1, 130, 16)])
def test_k11_direct_weights(wshape):
    """The packed weights: slab (chunk, tap) holds the tap's weights of
    every output channel at the chunk's 64 input channels, zero past CIN."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.integers(-128, 128, wshape).astype(np.int8))
    kh, kw, cin, cout = wshape
    wk = conv_direct.direct_weights(w)
    nch = -(-cin // 64)
    assert wk.shape == (nch, kh * kw, cout, 64) and wk.is_contiguous()
    flat = wk.permute(1, 2, 0, 3).reshape(kh * kw, cout, nch * 64)
    assert torch.equal(flat[..., :cin], w.reshape(kh * kw, cin, cout).transpose(1, 2))
    assert not flat[..., cin:].any()
    assert conv_direct.direct_weights(w) is wk


@pytest.mark.parametrize("shape,wshape,strides,plan", [
    ((8, 224, 224, 64), (3, 3, 64, 64), (1, 1), {"bn": 64, "wres": 1}),
    ((8, 112, 112, 128), (3, 3, 128, 128), (1, 1), {"bn": 128, "wres": 1}),
    ((8, 56, 56, 256), (3, 3, 256, 256), (1, 1), {"bn": 64, "wres": 1}),
    ((8, 28, 28, 512), (3, 3, 512, 512), (1, 1), {"bn": 128, "wres": 0, "group": 9}),
    ((8, 14, 14, 512), (3, 3, 512, 512), (1, 1), {"bn": 64, "wres": 0, "group": 9}),
    ((8, 224, 224, 3), (3, 3, 3, 64), (1, 1), {"bn": 64, "wres": 1}),
    ((8, 224, 224, 3), (7, 7, 3, 64), (2, 2), {"cc": 4}),
])
def test_k11_plan_at_vgg16_and_resnet50_shapes(shape, wshape, strides, plan):
    """The weights stay resident where every slab of the N tile fits beside
    the windows (CIN <= 128 at BN 128, <= 256 at BN 64); VGG-16's
    512-channel convs stream them; the 7x7 CIN-3 stem takes the narrow
    path, VGG-16's 3x3 CIN-3 conv the Hopper one."""
    got = conv_direct.direct_plan(shape, wshape, strides, (1, 1, 1, 1))
    assert got["cc"] == plan.get("cc", conv_direct.KC) and {k: got[k] for k in plan} == plan
    hopper = conv_direct.hopper_plan(shape, wshape, strides, (1, 1, 1, 1))
    assert hopper["cc"] == conv_direct.KC
    assert conv_direct.direct_smem(hopper["bn"], hopper["group"], shape[3], *wshape[:2], strides,
                                   hopper["wres"], hopper["ahead"]) <= conv_direct.SMEM_LIMIT


def test_direct_plan_fits_shared_memory_wherever_supported():
    """Every groups-1 geometry qconv2d_supported admits has a plan within
    227 KB on its path, and every geometry the narrow path alone fits (the
    first port's predicate) is still admitted."""
    n_hopper = n_narrow = 0
    for cin in (3, 16, 40, 64, 512):
        for k in (1, 2, 3, 5, 7, 11, 15, 20):
            for s in (1, 2, 3, 4, 8):
                shape, wshape = (2, 64, 64, cin), (k, k, cin, 96)
                supported = conv_direct.qconv2d_supported(shape, wshape, (s, s), (0, 0, 0, 0), 1)
                if conv_direct.narrow_chunk(cin, k, k, (s, s)) is not None:
                    assert supported, (cin, k, s)
                if not supported:
                    continue
                plan = conv_direct.direct_plan(shape, wshape, (s, s), (0, 0, 0, 0))
                if plan["cc"] == conv_direct.KC:
                    n_hopper += 1
                    assert plan["bn"] in conv_direct.BNS and 1 <= plan["group"] <= k * k
                    assert conv_direct.direct_smem(plan["bn"], plan["group"], cin, k, k, (s, s),
                                                   plan["wres"], plan["ahead"]) \
                        <= conv_direct.SMEM_LIMIT
                else:
                    n_narrow += 1
                    assert conv_direct.narrow_smem(plan["cc"], k, k, (s, s)) \
                        <= conv_direct.SMEM_LIMIT
    assert n_hopper > 100 and n_narrow > 0


@pytest.mark.parametrize("out,k,s,c,tile", [(112, 3, 1, 32, (32, 8, 8)), (56, 3, 2, 144, (16, 8, 8)),
                                             (7, 3, 1, 960, (32, 7, 8)), (14, 3, 2, 576, (32, 8, 8)),
                                             (300, 5, 1, 16, (16, 8, 8))])
def test_k12_plan_fits_shared_memory(out, k, s, c, tile):
    """K12 runs K5's body at `dw_plan`'s tile (channels, rows, columns): at
    most 256 threads and 227 KB a block, every output written once, and
    `qconv2d_supported` says yes."""
    plan = depthwise.dw_plan(2, out, out, c, k, k, s, s)
    assert (plan["ct"], plan["th"], plan["tw"]) == tile
    assert plan["threads"] <= depthwise.MAX_THREADS and plan["smem"] <= depthwise.MAX_SMEM
    if out <= 112:
        outs = depthwise.dw_thread_outputs(plan, 2, out, out, c)
        flat = ((outs[:, 0] * out + outs[:, 1]) * out + outs[:, 2]) * c + outs[:, 3]
        assert np.array_equal(np.sort(flat), np.arange(2 * out * out * c))
    side = (out - 1) * s + 1
    assert conv_direct.qconv2d_supported((2, side, side, c), (k, k, 1, c), (s, s),
                                         (k // 2,) * 4, c)


def test_k12_unsupported_where_k5_has_no_tile():
    """A depthwise window that no tile of K5's fits (101 x 101 taps) is
    unsupported, as `dw_plan` raises for it."""
    with pytest.raises(ValueError, match="does not fit"):
        depthwise.dw_plan(1, 100, 100, 16, 101, 101, 1, 1)
    assert not conv_direct.qconv2d_supported((1, 200, 200, 16), (101, 101, 1, 16), (1, 1),
                                             (0, 0, 0, 0), 16)


@pytest.mark.parametrize("out_dtype,qmin,qmax", [("int8", -128, 127), ("uint8", 0, 255)])
@pytest.mark.parametrize("shape,k,strides,padding,izp", [
    ((2, 9, 9, 32), 3, (1, 1), (1, 1, 1, 1), 7),
    ((1, 11, 11, 48), 3, (2, 2), (0, 1, 0, 1), -5),
    ((1, 8, 8, 20), 5, (1, 1), (2, 2, 2, 2), 100),
])
def test_k12_izp_convention_on_k5s_body(rng, out_dtype, qmin, qmax, shape, k, strides, padding,
                                        izp):
    """K12 on the card launches K5's requantize mode with the caller's bias
    (not folded: K5's body takes izp * sum(w) off itself), rq_izp 0, and
    the clipped value's low byte as `out_dtype` (conv_direct.qdwconv_direct).
    That function, through K5's plain version, == the JAX package's
    qconv2d_int8 in interpret mode."""
    c = shape[3]
    x = rng.integers(-128, 128, shape).astype(np.int8)
    w = rng.integers(-127, 127, (k, k, 1, c)).astype(np.int8)
    b = rng.integers(-2000, 2000, c).astype(np.int32)
    m, s = j_plan_requantize(0.0004 + np.abs(rng.standard_normal(c)) * 0.0005, 0.07)
    kw = dict(strides=strides, padding=padding, out_zp=4, rounding="TONEAREST", qmin=qmin,
              qmax=qmax)
    got = depthwise.qdwconv_rq_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(m.astype(np.int32)), torch.from_numpy(s.astype(np.int32)), izp=izp,
        rq_izp=0, **kw).view(getattr(torch, out_dtype))
    want = np.asarray(j_conv.qconv2d_int8(x, w, bias=b, multiplier=m, shift=s, groups=c,
                                          input_zero_point=izp, out_dtype=out_dtype, **kw))
    assert want.dtype == np.dtype(out_dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _record(rec):
    d = json.loads(rec.to_json())
    d["time_ms"] = 1.0
    if d["error_no"] == 0:
        d["meta"]["tops"] = 1.0
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("shape,wshape,strides,padding,groups", [
    ((1, 8, 8, 16), (3, 3, 16, 16), (1, 1), (1, 1, 1, 1), 1),
    ((1, 9, 9, 32), (3, 3, 1, 32), (1, 1), (1, 1, 1, 1), 32),
    ((1, 8, 8, 32), (3, 3, 16, 32), (1, 1), (1, 1, 1, 1), 2),     # unsupported in both
])
def test_tune_conv_record_equals_the_jax_package(shape, wshape, strides, padding, groups):
    pdb, jdb = p_db.TuneDatabase(), j_db.TuneDatabase()
    best = p_tuner.tune_conv(shape, wshape, strides, padding, groups, pdb, verbose=False,
                             device="cpu")
    jbest = j_tuner.tune_conv(shape, wshape, strides, padding, groups, jdb, verbose=False)
    assert len(pdb) == len(jdb) == 1
    assert [_record(r) for r in pdb.records] == [_record(r) for r in jdb.records]
    assert (best is None) == (jbest is None) == (groups == 2)
    if groups != 2:
        assert best.config == {"kernel": "pallas_direct"} and best.time_ms > 0
        assert best.meta["tops"] == round(best.meta["tops"], 2) >= 0
        assert best.workload == p_tuner.conv_workload(*shape, wshape[3], 3, 3, strides, groups)


def test_tune_conv_records_a_wrong_answer(monkeypatch):
    real = conv_direct.qconv_direct
    monkeypatch.setattr(conv_direct, "qconv_direct", lambda *a, **k: real(*a, **k) ^ 1)
    db = p_db.TuneDatabase()
    best = p_tuner.tune_conv((1, 8, 8, 16), (3, 3, 16, 16), (1, 1), (1, 1, 1, 1), 1, db,
                             verbose=False, device="cpu")
    assert best is None and db.records[0].error_no == p_db.WRONG_ANSWER
    assert db.records[0].meta == {"tops": 0}
