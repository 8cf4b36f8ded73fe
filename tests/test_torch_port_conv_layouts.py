"""The four layouts of the flat conv (K7 "t", K8 "s", K9 "w", K10 "r") on the
CPU, against the JAX package's `qconv2d_flat(..., layout=L, blocks=...)` in
interpret mode on the same numpy inputs, compared with ==.

Each layout's plain version follows its kernel's decomposition ("s": per
64-channel chunk, each live tap's shifted window times its weights; "w": one
wide product and shifted int32 sums; "r": per chunk and live column tap, one
deep-K product of its live row taps; "t": the channel-major image), so these
tests check the decomposition and not only the dispatch.  The dispatch tests
hold the port's `qconv2d_flat` to the JAX package's database rules: a record
selects its layout, bad explicit blocks raise, a foreign record is ignored.
"""

import numpy as np
import pytest
import torch

from tachikoma_tpu.ops.pallas import conv_flat as j_conv_flat
from tachikoma_tpu.ops.pallas.qms32 import plan_requantize
from tachikoma_tpu_torch.ops.kernels import conv, conv_layouts
from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector
from tachikoma_tpu_torch.tune import database as tdb

LAYOUTS = ("t", "s", "w", "r")
# (x shape, weight shape, stride, padding, input zero point)
CASES = [
    ((2, 10, 10, 32), (3, 3, 32, 48), (1, 1), (1, 1, 1, 1), 0),
    ((2, 9, 9, 32), (3, 3, 32, 48), (2, 2), (1, 1, 1, 1), 0),     # stride 2 (polyphase)
    ((1, 9, 9, 32), (3, 3, 32, 32), (2, 2), (1, 1, 1, 1), 7),     # izp != 0 at the borders
    ((2, 8, 8, 40), (3, 3, 40, 13), (1, 1), (0, 1, 2, 1), -5),    # ragged CIN, COUT, padding
    ((1, 9, 9, 64), (3, 3, 64, 32), (2, 2), (1, 1, 1, 1), 0),     # phase-aligned chunks, taps skipped
    ((2, 32, 32, 3), (7, 7, 3, 16), (2, 2), (3, 3, 3, 3), 5),     # a stem: CIN 3, izp != 0
]
CASE_IDS = ["s1", "s2", "izp", "ragged", "cin64_s2", "stem"]
JAX_BLOCKS = (128, 128, 128)   # a tileable TPU geometry for every case


def _inputs(case, seed=0):
    shape, wshape, strides, padding, izp = case
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 127, shape).astype(np.int8)
    w = rng.integers(-127, 127, wshape).astype(np.int8)
    cout = wshape[3]
    bias = rng.integers(-2000, 2000, cout).astype(np.int32)
    m, s = plan_requantize(0.0002 + np.abs(rng.standard_normal(cout)) * 0.0005, 0.07)
    return x, w, bias, m, s


def _jax(case, layout):
    shape, wshape, strides, padding, izp = case
    x, w, bias, m, s = _inputs(case)
    return np.asarray(j_conv_flat.qconv2d_flat(
        x, w, bias=bias, multiplier=m, shift=s, strides=strides, padding=padding,
        input_zero_point=izp, out_zp=4, layout=layout, blocks=JAX_BLOCKS))


def _port_args(case):
    x, w, bias, m, s = _inputs(case)
    cout = w.shape[3]
    return (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            channel_vector(m, cout, "cpu"), channel_vector(s, cout, "cpu"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_layout_plain_equals_jax_interpret(case, layout):
    _, _, strides, padding, izp = case
    want = _jax(case, layout)
    plain = getattr(conv_layouts, f"qconv_rq_{layout}_plain")
    got = plain(*_port_args(case), strides=strides, padding=padding, izp=izp, out_zp=4)
    np.testing.assert_array_equal(got.numpy(), want)
    # ... and K2's plain version (the same function along K2's im2col)
    k2 = conv.qconv_rq_plain(*_port_args(case), strides=strides, padding=padding, izp=izp,
                             out_zp=4)
    np.testing.assert_array_equal(k2.numpy(), want)


@pytest.mark.parametrize("case", CASES[:2], ids=["s1", "s2"])
def test_flat_frame_equals_jax(case):
    """The polyphase image and weights are the JAX package's, byte for byte."""
    shape, wshape, strides, padding, _ = case
    x, w, *_ = _inputs(case)
    jx, (oh, ow, khp, kwp, hph, wph) = j_conv_flat._phase_stack(x, *wshape[:2], *strides,
                                                                padding, 3)
    g = conv_layouts.flat_geometry(shape, wshape, strides, padding)
    assert (g.oh, g.ow, g.khp, g.kwp, g.hph, g.wph) == (oh, ow, khp, kwp, hph, wph)
    px = conv_layouts.phase_image(torch.from_numpy(x), g, strides, padding, 3)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    pw = conv_layouts.phase_weights(torch.from_numpy(w), strides)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(j_conv_flat._phase_weights(w, *strides)))


def test_decompositions_differ_in_operands_not_in_integers():
    """The four accumulators of one conv agree, on operands of four layouts."""
    case = CASES[3]
    _, _, strides, padding, izp = case
    x, w, *_ = _port_args(case)
    accs = []
    for layout in LAYOUTS:
        xf, wl, g = conv_layouts.flat_operands(x, w, layout, strides, padding, izp)
        if layout == "t":
            assert xf.shape == (g.c, g.mx)
        elif layout == "w":
            assert wl.shape == (g.c, g.khp * g.kwp * w.shape[3])
        accs.append(conv_layouts._ACC[layout](xf, wl, g))
    for a in accs[1:]:
        assert torch.equal(a, accs[0])


@pytest.fixture
def no_default_db(monkeypatch):
    monkeypatch.delenv("TK_TUNE_DB", raising=False)
    tdb.reset_default_database()
    yield
    tdb.reset_default_database()


def _record_calls(monkeypatch):
    calls = []
    for name in ("qconv_rq", "qconv_rq_t", "qconv_rq_s", "qconv_rq_w", "qconv_rq_r"):
        fn = getattr(conv, name)
        monkeypatch.setattr(conv, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append((_n, k)) or _fn(*a, **k))
    return calls


def _flat(case, **kw):
    _, _, strides, padding, izp = case
    x, w, bias, m, s = _inputs(case)
    return conv.qconv2d_flat(torch.from_numpy(x), w, bias, m, s, strides=strides,
                             padding=padding, input_zero_point=izp, out_zp=4, **kw).numpy()


@pytest.mark.parametrize("layout", LAYOUTS + (None,))
def test_record_selects_the_layout(layout, monkeypatch, no_default_db):
    case = CASES[1]
    shape, wshape, strides, _, _ = case
    wl = conv.flat_conv_workload(*shape, wshape[3], *wshape[:2], strides, True)
    assert wl == j_conv_flat.flat_conv_workload(*shape, wshape[3], *wshape[:2], strides, True)
    cfg = {"blocks": [128, 64, 64]} | ({"layout": layout} if layout else {})
    db = tdb.TuneDatabase()
    db.add(tdb.TuneRecord(wl, cfg, 0.01))
    calls = _record_calls(monkeypatch)
    with tdb.apply_history_best(db):
        got = _flat(case)
    name = f"qconv_rq_{layout}" if layout else "qconv_rq"
    assert [(n, k["blocks"]) for n, k in calls] == [(name, (128, 64, 64))]
    np.testing.assert_array_equal(got, _jax(case, layout))


def test_invalid_blocks_raise_and_foreign_records_are_ignored(monkeypatch, no_default_db):
    case = CASES[0]
    shape, wshape, strides, _, _ = case
    for bad in ((512, 256, 128), (64, 64, 128), (96, 64, 64), (64, 64, 0)):
        with pytest.raises(ValueError):
            _flat(case, blocks=bad)
    with pytest.raises(ValueError):
        _flat(case, blocks=(64, 64, 64), layout="x")
    want = _flat(case, blocks=(64, 64, 64))
    wl = conv.flat_conv_workload(*shape, wshape[3], *wshape[:2], strides, True)
    db = tdb.TuneDatabase()
    db.add(tdb.TuneRecord(wl, {"blocks": [512, 256, 128], "layout": "s"}, 0.01))
    calls = _record_calls(monkeypatch)
    with tdb.apply_history_best(db):
        got = _flat(case)
    assert [(n, k["blocks"]) for n, k in calls] == [("qconv_rq", None)]
    np.testing.assert_array_equal(got, want)


def test_wide_layout_refuses_a_tile_whose_partials_do_not_fit(no_default_db):
    """K9 keeps (BM + maxoff, rounded to 32) x BN int32 partials per tap in
    shared memory: the 224^2 stem (maxoff 348 rows) fits at BN 64, not at
    BN 128."""
    stem = ((8, 224, 224, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3))
    assert conv_layouts.layout_fits("w", (64, 64, 64), *stem)
    assert not conv_layouts.layout_fits("w", (64, 128, 64), *stem)
    x = torch.zeros((1, 224, 224, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        conv.qconv2d_flat(x, np.zeros((7, 7, 3, 64), np.int8), None, 1 << 30, 0, strides=(2, 2),
                          padding=(3, 3, 3, 3), blocks=(64, 128, 64), layout="w")


def test_live_taps_and_the_shared_memory_sums():
    """A 3x3 s2 conv with CIN % 64 == 0: each 64-channel chunk lies in one
    phase, whose live taps are 4, 2, 2 and 1 (9 products, not 16).  The four
    layouts' shared memory at the forward's 28^2 stage, and tiles they
    refuse."""
    g = conv_layouts.flat_geometry((8, 56, 56, 128), (3, 3, 128, 128), (2, 2), (1, 1, 1, 1))
    chunks = [conv_layouts.live_taps(g, k0) for k0 in range(0, g.cin_s, 64)]
    assert chunks == [[0, 1, 2, 3]] * 2 + [[0, 2]] * 2 + [[0, 1]] * 2 + [[0]] * 2
    # K9 at 64 x 64: 64 + 30 window rows rounded to wgmma's 32, 4 taps per step:
    # two windows, two weight tiles, the int32 partials (rows padded by 4 words)
    assert conv_layouts.layout_group("w", (64, 64), g) == 4
    assert conv_layouts.smem_bytes("w", (64, 64), g, 4) == 2 * 96 * 64 + 2 * 4 * 64 * 64 + 96 * 260 * 4
    assert conv_layouts.layout_group("w", (128, 128), g) == 2       # 2 * BN = 256
    # K7 at 64 x 64: two NHWC windows of 96 rows, the channel-major window
    # (64 rows of stride 136), two weight tiles of 4 taps
    assert conv_layouts.layout_group("t", (64, 64), g) == 4
    assert conv_layouts.smem_bytes("t", (64, 64), g, 4) == 2 * 96 * 64 + 64 * 136 + 2 * 4 * 64 * 80
    # K8 and K10 at 64 x 64: two K-slice-major windows (K8 64 + maxoff 30
    # rows, K10 64 + (KHP-1)*WPH = 64 + 29, both rounded to 8) and two weight
    # tiles; K10's step holds one column's row taps, at most KHP = 2
    assert conv_layouts.window_rows("s", 64, g) == 96
    assert conv_layouts.window_rows("r", 64, g) == 96
    assert conv_layouts.window_rows("r", 128, g) == 160             # 157 rounded
    assert conv_layouts.layout_group("s", (64, 64), g) == 4
    assert conv_layouts.smem_bytes("s", (64, 64), g, 4) == 2 * 96 * 64 + 2 * 4 * 64 * 64
    assert conv_layouts.layout_group("r", (128, 128), g) == 2
    assert conv_layouts.smem_bytes("r", (128, 128), g, 2) == 2 * 160 * 64 + 2 * 2 * 128 * 64
    # refused: K9's partials of the 224^2 stem at BN 128; K7's, K8's and
    # K10's windows of a 900-pixel-wide row (two rows past the block); at
    # 800 pixels K8 takes two taps a step, not three
    stem = ((8, 224, 224, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3))
    assert conv_layouts.layout_fits("w", (64, 64, 64), *stem)
    assert not conv_layouts.layout_fits("w", (128, 128, 64), *stem)
    gs = conv_layouts.flat_geometry(*stem)
    for layout in ("s", "r"):      # the stem's 412- and 409-row windows fit every tile
        assert [conv_layouts.layout_group(layout, t, gs) for t in ((64, 64), (128, 128))] == [4, 4]
    wide = ((1, 8, 900, 64), (3, 3, 64, 64), (1, 1), (1, 1, 1, 1))
    gw = conv_layouts.flat_geometry(*wide)
    assert conv_layouts.window_rows("s", 64, gw) == 1872            # 64 + 1806
    assert conv_layouts.smem_bytes("s", (64, 64), gw) == 2 * 1872 * 64 + 2 * 64 * 64 > 232448
    for layout in ("t", "s", "r"):
        assert conv_layouts.layout_fits(layout, (64, 64, 64), *((1, 8, 300, 64),) + wide[1:])
        assert not conv_layouts.layout_fits(layout, (64, 64, 64), *wide)
        with pytest.raises(ValueError, match="shared memory"):
            conv.qconv2d_flat(torch.zeros(wide[0], dtype=torch.int8), np.zeros(wide[1], np.int8),
                              None, 1 << 30, 0, padding=wide[3], blocks=(64, 64, 64),
                              layout=layout)
    g800 = conv_layouts.flat_geometry((1, 8, 800, 64), *wide[1:])
    assert conv_layouts.layout_group("s", (64, 64), g800) == 2


def _steps(layout, g, group):
    """Steps of the kernels' walk (csrc/layouts_hopper.cuh step_from): up to
    `group` live taps of one chunk, for K10 of one column tap."""
    n = 0
    for k0 in range(0, g.cin_s, 64):
        live = conv_layouts.live_taps(g, k0)
        cols = [[t for t in live if t % g.kwp == b] for b in range(g.kwp)] \
            if layout == "r" else [live]
        n += sum(-(-len(c) // group) for c in cols if c)
    return n


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_steps_and_live_pairs_per_layout(case):
    """K8 runs each chunk's live taps in steps of up to four; K10 one step per
    (chunk, live column tap).  The cin64_s2 case has 9 live (chunk, tap)
    pairs: K8 4 steps, K10 6 (chunk 0 two columns of two row taps, chunk 1
    one column, chunk 2 two columns of one, chunk 3 one).  Every live pair is
    in exactly one step of either walk, and the plain versions multiply only
    those: the same integers as the dense im2col."""
    shape, wshape, strides, padding, izp = case
    g = conv_layouts.flat_geometry(shape, wshape, strides, padding)
    pairs = sum(len(conv_layouts.live_taps(g, k0)) for k0 in range(0, g.cin_s, 64))
    assert _steps("s", g, 1) == _steps("r", g, 1) == pairs
    if case is CASES[4]:
        assert pairs == 9 and _steps("s", g, 4) == 4 and _steps("r", g, 2) == 6
    x, w, *_ = _port_args(case)
    xf, wd, g = conv_layouts.flat_operands(x, w, "s", strides, padding, izp)
    cols = torch.cat([xf[o:o + g.mo] for o in g.offs], dim=1)       # the dense im2col
    dense = conv_layouts.exact_int_matmul(cols, wd)
    for layout in ("s", "r"):
        xf, wl, g = conv_layouts.flat_operands(x, w, layout, strides, padding, izp)
        assert torch.equal(conv_layouts._ACC[layout](xf, wl, g), dense)


def test_kernel_parameters_mirror_params_cuh():
    """`_lib.PARAMS` is `csrc/params.cuh`'s enum Param, in order."""
    import re
    from tachikoma_tpu_torch.ops.kernels import _lib

    text = (_lib.CSRC / "params.cuh").read_text()
    body = re.sub(r"//[^\n]*", "", text[text.index("enum Param {"):text.index("P_COUNT")])
    names = re.findall(r"\bP_([A-Z0-9_]+)", body)
    assert tuple(n.lower() for n in names) == _lib.PARAMS


def test_packed_weights_once_per_tensor_and_version():
    """K7's and K9's (KH, KW, COUT, CIN) weights are packed once per weight
    tensor, again after an in-place write, and dropped with the tensor."""
    w = torch.from_numpy(np.random.default_rng(0).integers(-128, 128, (3, 3, 8, 16)).astype(np.int8))
    wk = conv_layouts.packed_weights(w)
    assert torch.equal(wk, w.permute(0, 1, 3, 2)) and wk.is_contiguous()
    assert conv_layouts.packed_weights(w) is wk
    w.neg_()
    assert torch.equal(conv_layouts.packed_weights(w), w.permute(0, 1, 3, 2))
    key = id(w)
    del w
    assert key not in conv_layouts._PACKED


def test_default_database_reads_only_tk_tune_db(tmp_path, monkeypatch, no_default_db):
    assert tdb.default_database() is None and tdb.lookup_config("anything") is None
    path = tmp_path / "h100.jsonl"
    path.write_text(tdb.TuneRecord("w", {"blocks": [64, 64, 64]}, 0.5).to_json() + "\n")
    monkeypatch.setenv("TK_TUNE_DB", str(path))
    assert tdb.default_database() is None          # loaded once per process
    tdb.reset_default_database()
    assert tdb.lookup_config("w") == {"blocks": [64, 64, 64]}
