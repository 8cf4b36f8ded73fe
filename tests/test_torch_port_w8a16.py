"""The W8A16 path of the port on the CPU (16-bit activations, 8-bit weights,
int64 accumulators), against the JAX package: the wide fixed-point
multiply, the int64 requantize, qnn.conv2d / qnn.dense into int64, the
arithmetic of the card's kernels for those products (the int16 operand's
byte planes, K5's int16 mode), the W8A16
preset's quantize / fuse / run / trace, the int16 and int64 paths of the
other ops, and `runtime/validate.py`.

Every input comes from a seeded numpy generator; integers are compared with
==, float nodes with allclose(rtol=1e-5, atol=1e-6), the JAX package's rule
for its traces (tests/test_trace.py)."""

import io

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.models.vision import lenet5 as j_lenet5
from tachikoma_tpu.models.vision import resnet as j_resnet
from tachikoma_tpu.ops import fixed_point as jfp
from tachikoma_tpu.quantize.config import W8A16 as J_W8A16
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.runtime.validate import audit_int32_overflow as j_audit
from tachikoma_tpu.runtime.validate import validate_graph as j_validate
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import Graph, GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir import registry
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.models.vision import lenet5, resnet
from tachikoma_tpu_torch.ops import fixed_point as fp
from tachikoma_tpu_torch.ops.kernels import wide
from tachikoma_tpu_torch.quantize.config import W8A16, QConfig
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.runtime.validate import audit_int32_overflow, validate_graph
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

I16_MIN, I16_MAX = -2 ** 15, 2 ** 15 - 1
RTOL, ATOL = 1e-5, 1e-6


def _bignum(x: int, m: int, shift: int, rounding: str) -> int:
    """(x * m * 2^shift) >> 31 rounded, in Python's unbounded integers."""
    left, right = max(shift, 0), max(-shift, 0)
    t = right + 31
    p = (int(x) << left) * m
    return (p + (1 << (t - 1)) - (1 if rounding == "TONEAREST" and p < 0 else 0)) >> t


def _wide_inputs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(-2 ** 45, 2 ** 45, 400),
                           rng.integers(-2 ** 31, 2 ** 31, 100),
                           [0, 1, -1, 2 ** 40, -2 ** 40, 2 ** 45, -2 ** 45 - 7,
                            32767 * 127 * 4608, -32768 * 128 * 4608]]).astype(np.int64)


# ---------------------------------------------------------------------------
# the wide multiply and the int64 requantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("shift", [1, 0, -3, -17, -31, -40])
@pytest.mark.parametrize("m", [1, 1073741824, 1518500250, 2147483647])
def test_wide_multiply_equals_big_integers_and_the_reference(m, shift, rounding):
    xs = _wide_inputs(abs(shift) * 7 + (m % 5))
    want = np.array([_bignum(v, m, shift, rounding) for v in xs], np.int64)
    ref = jfp.q_multiply_shift_wide_np(xs, m, shift, rounding)
    got_np = fp.q_multiply_shift_wide_np(xs, m, shift, rounding)
    got_t = fp.q_multiply_shift_wide(torch.from_numpy(xs), m, shift, rounding)
    assert got_t.dtype == torch.int64
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_wide_multiply_per_axis_equals_big_integers_and_the_reference(rng, axis, rounding):
    x = rng.integers(-2 ** 44, 2 ** 44, (6, 5, 4)).astype(np.int64)
    x[0, 0, :] = [0, -1, 2 ** 44, -(2 ** 44)]
    n = x.shape[axis]
    ms = rng.integers(1 << 30, (1 << 31) - 1, n)
    shifts = rng.integers(-38, 3, n)
    ref = jfp.q_multiply_shift_wide_per_axis_np(x, ms, shifts, axis % 3, rounding)
    got_np = fp.q_multiply_shift_wide_per_axis_np(x, ms, shifts, axis % 3, rounding)
    got_t = fp.q_multiply_shift_wide_per_axis(torch.from_numpy(x), ms, shifts, axis, rounding)
    idx = np.moveaxis(np.indices(x.shape), 0, -1).reshape(-1, 3)
    want = np.array([_bignum(x[tuple(i)], int(ms[i[axis]]), int(shifts[i[axis]]), rounding)
                     for i in idx], np.int64).reshape(x.shape)
    for got in (ref, got_np, got_t.numpy()):
        np.testing.assert_array_equal(got, want)


def _graph(builder, infer, op, inputs, attrs, consts=()):
    b = builder("t")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    names += [b.const(c, name=f"c{i}") for i, c in enumerate(consts)]
    return infer(b.build(b.call(op, *names, name="y", **attrs)))


def _four_ways(op, inputs, attrs, consts=()):
    """The JAX package's oracle (the reference), then JaxExecutor, the port's
    oracle and the port's torch impl (TorchExecutor on the CPU) on the same
    one-op graph, whose JSON must be the JAX package's."""
    g = _graph(GraphBuilder, infer_types, op, inputs, attrs, consts)
    jg = _graph(JGraphBuilder, j_infer_types, op, inputs, attrs, consts)
    assert g.to_json() == jg.to_json()
    feeds = {f"x{i}": x for i, x in enumerate(inputs)}
    want = j_run_graph(jg, feeds)[0]
    assert (want.shape, str(want.dtype)) == (g["y"].shape, g["y"].dtype)
    outs = [np.asarray(JaxExecutor(jg, fuse=False).run(feeds)[0]), run_graph(g, feeds)[0],
            TorchExecutor(g, device="cpu").run(feeds)[0]]
    for got in outs:
        assert got.dtype == want.dtype and got.shape == want.shape
    return want, outs


def _acc(rng, shape, extreme: bool):
    x = rng.integers(-2 ** 40, 2 ** 40, shape).astype(np.int64)
    if extreme:
        x.reshape(-1)[:4] = [2 ** 40, -(2 ** 40), 0, -1]
    return x


@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("per_channel,izp,ozp,out_dtype", [
    (False, 0, 0, "int16"), (True, 0, 0, "int16"), (True, 5, -3, "int16"),
    (False, -7, 12, "int8"), (True, 0, 0, "int32")])
def test_int64_requantize_matches_the_reference(rng, per_channel, izp, ozp, out_dtype,
                                                rounding):
    x = _acc(rng, (2, 3, 3, 6), True)
    scale = (rng.uniform(1e-7, 3e-6, 6).astype(np.float32) if per_channel
             else float(np.float32(1.7e-6)))
    attrs = dict(input_scale=scale, input_zero_point=izp, output_scale=0.0021,
                 output_zero_point=ozp, axis=3, rounding=rounding, out_dtype=out_dtype)
    want, outs = _four_ways("qnn.requantize", [x], attrs)
    for got in outs:
        np.testing.assert_array_equal(got, want)
    ref = jfp.requantize_np(x, scale, izp, 0.0021, ozp, axis=3, rounding=rounding,
                            out_dtype=out_dtype)
    np.testing.assert_array_equal(fp.requantize_np(x, scale, izp, 0.0021, ozp, axis=3,
                                                   rounding=rounding, out_dtype=out_dtype), ref)
    np.testing.assert_array_equal(want, ref)


def test_int64_requantize_identity_scale_keeps_int64_arithmetic(rng):
    """Equal scales skip the multiply; the zero points still move in int64
    and the clip saturates at the int16 extremes (-32768, not -32767)."""
    x = np.array([[2 ** 40, -(2 ** 40), 32767, -32768, -32769, 7]], np.int64)
    attrs = dict(input_scale=0.5, input_zero_point=-2, output_scale=0.5, output_zero_point=1,
                 out_dtype="int16")
    want, outs = _four_ways("qnn.requantize", [x], attrs)
    np.testing.assert_array_equal(want, [[32767, -32768, 32767, -32765, -32766, 10]])
    for got in outs:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# qnn.conv2d and qnn.dense into int64
# ---------------------------------------------------------------------------

def _i16(rng, shape, extreme=True):
    x = rng.integers(I16_MIN, I16_MAX + 1, shape).astype(np.int16)
    if extreme:
        flat = x.reshape(-1)
        flat[: flat.size // 4] = I16_MIN
        flat[flat.size // 4: flat.size // 2] = I16_MAX
        rng.shuffle(flat)
    return x


def _w8(rng, shape):
    w = rng.integers(-128, 128, shape).astype(np.int8)
    w.reshape(-1)[:2] = [-128, 127]
    return w


WIDE_CONVS = [
    # (x shape, weight shape, strides, padding, groups, izp)
    ((2, 9, 9, 16), (3, 3, 16, 24), (1, 1), (1, 1, 1, 1), 1, 0),
    ((2, 9, 9, 16), (3, 3, 16, 24), (2, 2), (1, 1, 1, 1), 1, -300),
    ((2, 9, 9, 16), (3, 3, 16, 24), (2, 2), (0, 0, 1, 1), 1, 32767),      # TFLite SAME s2
    ((1, 15, 15, 3), (7, 7, 3, 8), (2, 2), (3, 3, 3, 3), 1, -32768),      # 7x7 s2 stem
    ((2, 7, 7, 16), (1, 1, 16, 32), (1, 1), (0, 0, 0, 0), 1, 256),        # 1x1: lo byte 0
    ((2, 7, 7, 16), (1, 1, 16, 32), (2, 2), (0, 0, 0, 0), 1, -1),         # 1x1 s2
    ((2, 8, 8, 8), (3, 3, 1, 8), (1, 1), (1, 1, 1, 1), 8, 0),             # depthwise
    ((2, 8, 8, 8), (3, 3, 1, 8), (2, 2), (0, 0, 1, 1), 8, -12345),        # depthwise s2 SAME
    ((1, 6, 8, 8), (3, 3, 8, 8), (1, 1), (0, 1, 0, 1), 1, 255),           # asymmetric padding
]


@pytest.mark.parametrize("xs,ws,strides,padding,groups,izp", WIDE_CONVS)
def test_qnn_conv2d_int64_matches_the_reference(rng, xs, ws, strides, padding, groups, izp):
    x, w = _i16(rng, xs), _w8(rng, ws)
    attrs = dict(strides=strides, padding=padding, groups=groups, input_zero_point=izp,
                 kernel_zero_point=0, out_dtype="int64")
    want, outs = _four_ways("qnn.conv2d", [x], attrs, consts=[w])
    assert want.dtype == np.int64
    for got in outs:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n,izp", [(3, 70, 10, 0), (16, 1280, 10, -1), (1, 4608, 64, 32767),
                                       (65, 200, 33, -32768)])
def test_qnn_dense_int64_matches_the_reference(rng, m, k, n, izp):
    x, w = _i16(rng, (m, k)), _w8(rng, (k, n))
    attrs = dict(input_zero_point=izp, kernel_zero_point=0, out_dtype="int64")
    want, outs = _four_ways("qnn.dense", [x], attrs, consts=[w])
    for got in outs:
        np.testing.assert_array_equal(got, want)


def test_int8_data_into_int64_and_int16_into_int32_refusal(rng):
    """int8 data may accumulate into int64 (one plane); int16 data into
    int32 has no kernel and raises, naming what the kernels take."""
    x, w = rng.integers(-128, 128, (1, 6, 6, 8)).astype(np.int8), _w8(rng, (3, 3, 8, 4))
    attrs = dict(padding=(1, 1, 1, 1), input_zero_point=-128, out_dtype="int64")
    want, outs = _four_ways("qnn.conv2d", [x], attrs, consts=[w])
    for got in outs:
        np.testing.assert_array_equal(got, want)
    node = Node("c", "qnn.conv2d", ("a", "b"), dict(out_dtype="int32"))
    with pytest.raises(NotImplementedError, match="int16 x int8 into int64"):
        get_op("qnn.conv2d").torch_impl(torch.from_numpy(_i16(rng, (1, 4, 4, 8))),
                                        torch.from_numpy(w), node=node)


@pytest.mark.parametrize("bad,match", [
    (dict(kernel_zero_point=3), "kernel_zero_point.*item 2"),
    (dict(out_dtype="int8"), "out_dtype int8"),
    (dict(out_dtype="int16"), "out_dtype int16"),
])
def test_wide_products_refuse_what_no_kernel_runs(rng, bad, match):
    """A nonzero kernel zero point and accumulators other than int32 and
    int64 raise (grouped and dilated convs into int64 run on qconv_wide /
    qdwconv_wide since they came: tests/test_torch_port_w8a16_families.py)."""
    x, w = torch.from_numpy(_i16(rng, (1, 6, 6, 8))), torch.from_numpy(_w8(rng, (3, 3, 4, 8)))
    attrs = dict(out_dtype="int64", padding=(1, 1, 1, 1)) | bad
    with pytest.raises(NotImplementedError, match=match):
        get_op("qnn.conv2d").torch_impl(x, w, node=Node("layer1_conv", "qnn.conv2d",
                                                        ("a", "b"), attrs))


# ---------------------------------------------------------------------------
# the kernels' arithmetic: the CPU model of qgemm_wide / qconv_wide's byte
# planes and of K5's int16 mode, against the JAX package's int64 oracle
# ---------------------------------------------------------------------------

PLANE_ZPS = [0, 1, -1, 255, 256, -256, -128, 32767, -32768, 12345, -3840]
WIDE_DENSE = [(1, 70, 10), (16, 1280, 10), (65, 576, 96), (8, 2048, 1000)]


@pytest.mark.parametrize("izp", PLANE_ZPS)
def test_split_planes_recompose_at_the_int16_extremes(izp):
    """hi is an s8 byte, lo a u8 byte, 256 hi + lo == x; izp's fill splits
    alike, so x - izp == 256 (hi - zh) + (lo - zl) term by term."""
    x = torch.tensor([I16_MIN, I16_MIN + 1, -257, -256, -255, -1, 0, 1, 255, 256, I16_MAX,
                      izp], dtype=torch.int16)
    hi, lo = wide.byte_planes(x)
    assert int(hi.min()) >= -128 and int(hi.max()) <= 127
    assert int(lo.min()) >= 0 and int(lo.max()) <= 255
    assert torch.equal(256 * hi + lo, x.to(torch.int64))
    zh, zl = wide.byte_planes(torch.tensor([izp], dtype=torch.int16))
    assert torch.equal(256 * (hi - zh) + (lo - zl), x.to(torch.int64) - izp)
    assert int(hi[-1]) == int(zh) and int(lo[-1]) == int(zl)


@pytest.mark.parametrize("izp", PLANE_ZPS)
@pytest.mark.parametrize("xs,ws,strides,padding,groups",
                         [c[:5] for c in WIDE_CONVS], ids=[f"conv{i}" for i in range(9)])
def test_conv_planes_through_k4_k5_plain_equal_the_direct_int64_sum(rng, xs, ws, strides,
                                                                    padding, groups, izp):
    """The kernels' arithmetic (`wide_conv_model`: the izp fill, the s8 / u8
    planes' int32 sums, the int64 combine less izp colsum; K5's int16 sum
    for the depthwise cases) == the plain version == the JAX package's
    qnn.conv2d int64 oracle, at the int16 extremes."""
    x, w = _i16(rng, xs), _w8(rng, ws)
    kw = dict(strides=strides, padding=padding, groups=groups, izp=izp)
    want = wide.wide_conv_plain(torch.from_numpy(x), torch.from_numpy(w), **kw)
    got = wide.wide_conv_model(torch.from_numpy(x), torch.from_numpy(w), **kw)
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    attrs = dict(strides=strides, padding=padding, groups=groups, input_zero_point=izp,
                 out_dtype="int64")
    ref = j_get_op("qnn.conv2d").np_impl(x, w, node=JNode("y", "qnn.conv2d", ("x", "w"), attrs))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("izp", PLANE_ZPS)
@pytest.mark.parametrize("m,k,n", WIDE_DENSE)
def test_dense_planes_through_k4_plain_equal_the_direct_int64_sum(rng, m, k, n, izp):
    """`wide_dense_model` (qgemm_wide's planes) == the plain version == the
    JAX package's qnn.dense int64 oracle."""
    x, w = _i16(rng, (m, k)), _w8(rng, (k, n))
    attrs = dict(input_zero_point=izp, out_dtype="int64")
    want = j_get_op("qnn.dense").np_impl(x, w, node=JNode("y", "qnn.dense", ("x", "w"), attrs))
    got = wide.wide_dense_model(torch.from_numpy(x), torch.from_numpy(w), izp=izp)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(wide.wide_dense_plain(torch.from_numpy(x),
                                                        torch.from_numpy(w), izp=izp), want)


def test_planes_are_exact_at_the_k_bound_and_raise_past_it():
    """The worst case at K = K_BOUND: x = -1 (lo 255) and w = -128 on every
    term fill the lo plane's int32 sum to -2^31 + 128; one more term leaves
    int32 (the range check) and the model, like the kernels, raises."""
    k = wide.K_BOUND
    assert 255 * 128 * k <= 2 ** 31 - 1 < 255 * 128 * (k + 1)
    w = torch.full((k, 1), -128, dtype=torch.int8)
    for xv, izp in ((-1, 0), (255, -256), (I16_MIN, I16_MAX)):
        got = wide.wide_dense_model(torch.full((1, k), xv, dtype=torch.int16), w, izp=izp)
        assert int(got) == (xv - izp) * -128 * k
    lo_sum = -255 * 128 * k
    assert -2 ** 31 <= lo_sum == -2 ** 31 + 128
    with pytest.raises(OverflowError, match="the lo plane"):
        wide.plane_product(torch.full((1, k + 1), -1, dtype=torch.int16),
                           torch.full((k + 1, 1), -128, dtype=torch.int8), 0)
    with pytest.raises(ValueError, match="K 65794 is above 65793"):
        wide.wide_dense_model(torch.zeros((1, k + 1), dtype=torch.int16),
                              torch.zeros((k + 1, 1), dtype=torch.int8))
    with pytest.raises(ValueError, match="above 65793"):
        wide.wide_conv_model(torch.zeros((1, 3, 3, 7400), dtype=torch.int16),
                             torch.zeros((3, 3, 7400, 1), dtype=torch.int8))


def test_depthwise_is_exact_at_its_tap_bound_and_raises_past_it():
    """K5's int16 mode: (x - izp) w = 65535 * 128 on each of 256 taps stays
    in int32 (2^31 - 32768); a 257th term would leave it, and the model and
    the kernel raise above DW_TAP_BOUND taps."""
    taps = wide.DW_TAP_BOUND
    assert taps == 256 and 65535 * 128 * taps <= 2 ** 31 - 1 < 65535 * 128 * (taps + 1)
    x = torch.full((1, 16, 16, 4), I16_MIN, dtype=torch.int16)
    w = torch.full((16, 16, 1, 4), -128, dtype=torch.int8)
    got = wide.wide_conv_model(x, w, groups=4, izp=I16_MAX)
    assert bool((got == 65535 * 128 * taps).all())
    assert torch.equal(got, wide.wide_conv_plain(x, w, groups=4, izp=I16_MAX))
    with pytest.raises(ValueError, match="K 257 is above 256"):
        wide.wide_conv_model(torch.zeros((1, 1, 257, 4), dtype=torch.int16),
                             torch.zeros((1, 257, 1, 4), dtype=torch.int8), groups=4)


def test_plans_cover_k_and_fill_the_card():
    """`wide_plan` at W8A16 ResNet-50's calls: a built tile, every split
    non-empty and covering K, the small grids (M 1, 8, 49) split."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import split_covers

    for m, k, n in [(8, 2048, 1000), (1, 2048, 1000), (49, 4608, 512), (392, 4608, 512),
                    (25088, 64, 256), (100352, 147, 64), (12544, 147, 64), (1, 16, 10)]:
        p = wide.wide_plan(m, k, n)
        assert (p["bm"], p["bn"]) in wide.WIDE_TILES
        assert split_covers(p["ks"], p["kper"], -(-k // 64)), (m, k, n, p)
        if m <= 49 and k >= 2048:
            assert p["ks"] > 1, (m, k, n, p)
    for plan in wide.wide_plans(4608):
        assert split_covers(plan["ks"], plan["kper"], 72)


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """On a CPU tensor the wrappers run their plain versions and count no
    launch; a device with no kernel raises."""
    from tachikoma_tpu_torch.ops.kernels import _lib

    monkeypatch.setattr(wide, "_launch_wide", lambda *a, **k: pytest.fail("kernel"))
    names = ("qgemm_wide", "qconv_wide", "qdwconv_wide")
    before = {k: _lib.LAUNCHES[k] for k in names}
    x, w = torch.ones((2, 5), dtype=torch.int16), torch.ones((5, 3), dtype=torch.int8)
    assert int(wide.wide_dense(x, w, izp=-2).sum()) == 2 * 3 * 15
    assert int(wide.qgemm_wide(x, w, izp=-2).sum()) == 2 * 3 * 15
    wide.wide_conv(torch.ones((1, 3, 3, 2), dtype=torch.int16),
                   torch.ones((1, 1, 2, 2), dtype=torch.int8))
    wide.qdwconv_wide(torch.ones((1, 3, 3, 2), dtype=torch.int16),
                      torch.ones((3, 3, 1, 2), dtype=torch.int8), padding=(1, 1, 1, 1))
    assert {k: _lib.LAUNCHES[k] for k in names} == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wide.wide_dense(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wide.qconv_wide(torch.ones((1, 3, 3, 2), dtype=torch.int16, device="meta"),
                        torch.ones((1, 1, 2, 2), dtype=torch.int8, device="meta"))


# ---------------------------------------------------------------------------
# the other ops on int16 and int64 (the 16x8 graphs' ops)
# ---------------------------------------------------------------------------

def _r(rng, shape, dtype, lo=None, hi=None):
    info = np.iinfo(dtype)
    return rng.integers(info.min if lo is None else lo, (info.max if hi is None else hi) + 1,
                        shape).astype(dtype)


OP_CASES = [
    ("bias_add_int64", "nn.bias_add", lambda r: [_acc(r, (2, 5, 5, 6), True)],
     dict(axis=-1), lambda r: [r.integers(-2 ** 33, 2 ** 33, 6).astype(np.int64)]),
    ("bias_add_int64_int32_bias", "nn.bias_add", lambda r: [_acc(r, (2, 6), False)],
     dict(axis=-1), lambda r: [r.integers(-2 ** 31, 2 ** 31, 6).astype(np.int32)]),
    ("clip_int16", "clip", lambda r: [_r(r, (3, 40), np.int16)],
     dict(a_min=-32768, a_max=1200), lambda r: []),
    ("clip_int64", "clip", lambda r: [_acc(r, (3, 40), True)],
     dict(a_min=-2 ** 35, a_max=2 ** 34), lambda r: []),
    ("pad_int16_zero_point", "nn.pad", lambda r: [_r(r, (1, 5, 5, 3), np.int16)],
     dict(pad_width=((0, 0), (1, 2), (0, 1), (0, 0)), pad_value=-31000), lambda r: []),
    ("max_pool_int16", "nn.max_pool2d", lambda r: [_r(r, (1, 7, 7, 4), np.int16)],
     dict(pool_size=(3, 3), strides=(2, 2), padding=(0, 0, 1, 1)), lambda r: []),
    ("avg_pool_int32", "nn.avg_pool2d", lambda r: [_r(r, (1, 7, 7, 4), np.int16).astype(np.int32)],
     dict(pool_size=(2, 2), strides=(2, 2), padding=(0, 0, 1, 1)), lambda r: []),
    ("mean_int32", "mean", lambda r: [_r(r, (2, 5, 5, 6), np.int16).astype(np.int32)],
     dict(axis=(1, 2), keepdims=False), lambda r: []),
    ("cast_int16_int32", "cast", lambda r: [_r(r, (4, 9), np.int16)],
     dict(dtype="int32"), lambda r: []),
    ("cast_int32_int16_wraps", "cast", lambda r: [_r(r, (4, 9), np.int32, -2 ** 20, 2 ** 20)],
     dict(dtype="int16"), lambda r: []),
    ("cast_int32_int8_wraps", "cast", lambda r: [_r(r, (4, 9), np.int32, -2 ** 12, 2 ** 12)],
     dict(dtype="int8"), lambda r: []),
    ("cast_int64_int32", "cast", lambda r: [_acc(r, (4, 9), True)],
     dict(dtype="int32"), lambda r: []),
    ("cast_float_int32_truncates", "cast",
     lambda r: [(r.standard_normal((4, 9)) * 300).astype(np.float32)], dict(dtype="int32"),
     lambda r: []),
    ("cast_int8_float32", "cast", lambda r: [_r(r, (4, 9), np.int8)],
     dict(dtype="float32"), lambda r: []),
    ("quantize_int16", "qnn.quantize", lambda r: [(r.standard_normal((3, 17)) * 3).astype(np.float32)],
     dict(scale=1e-4, zero_point=0, out_dtype="int16"), lambda r: []),
    ("dequantize_int16", "qnn.dequantize", lambda r: [_r(r, (3, 17), np.int16)],
     dict(scale=3.0517578e-05, zero_point=0), lambda r: []),
    ("qnn_add_int16", "qnn.add",
     lambda r: [_r(r, (2, 4, 4, 3), np.int16), _r(r, (2, 4, 4, 3), np.int16)],
     dict(lhs_scale=2e-4, lhs_zero_point=0, rhs_scale=3e-4, rhs_zero_point=0,
          output_scale=4e-4, output_zero_point=0, out_dtype="int16"), lambda r: []),
    ("qnn_concatenate_int16", "qnn.concatenate",
     lambda r: [_r(r, (2, 3, 3, 4), np.int16), _r(r, (2, 3, 3, 5), np.int16)],
     dict(axis=3, input_scales=(2e-4, 3e-4), input_zero_points=(0, 0), output_scale=3e-4,
          output_zero_point=0, out_dtype="int16"), lambda r: []),
]


@pytest.mark.parametrize("op,make,attrs,consts", [c[1:] for c in OP_CASES],
                         ids=[c[0] for c in OP_CASES])
def test_int16_and_int64_ops_match_the_reference(op, make, attrs, consts):
    rng = np.random.default_rng(11)
    want, outs = _four_ways(op, make(rng), attrs, consts(rng))
    for got in outs:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the W8A16 preset: quantize, fuse, run, trace
# ---------------------------------------------------------------------------

def _cnn(builder, infer, seed=0):
    """tests/test_w8a16.py's CNN: two 3x3 convs (one s2), a max pool, a dense."""
    rng = np.random.default_rng(seed)
    b = builder()
    x = b.var("x", (2, 12, 12, 8), "float32")

    def conv(src, cin, cout, name, stride=1):
        w = b.const(rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.25,
                    name + "_w")
        bias = b.const(rng.standard_normal(cout).astype(np.float32) * 0.1, name + "_b")
        c = b.call("nn.conv2d", src, w, padding=(1, 1, 1, 1), strides=(stride, stride),
                   name=name)
        return b.call("nn.relu", b.call("nn.bias_add", c, bias))

    h = conv(conv(x, 8, 16, "c1"), 16, 16, "c2", stride=2)
    h = b.call("nn.max_pool2d", h, pool_size=(2, 2), strides=(2, 2))
    h = b.call("reshape", h, newshape=(2, 3 * 3 * 16))
    wfc = b.const(rng.standard_normal((3 * 3 * 16, 10)).astype(np.float32) * 0.2, "fc_w")
    return infer(b.build(b.call("nn.dense", h, wfc, name="fc")))


def test_w8a16_preset_is_the_references():
    assert W8A16 == QConfig(**vars(J_W8A16))
    assert (W8A16.act_dtype, W8A16.accum_dtype, W8A16.bias_dtype) == ("int16", "int64", "int64")


def test_w8a16_cnn_quantizes_runs_and_beats_int8_as_the_reference(rng):
    calib = [rng.standard_normal((2, 12, 12, 8)).astype(np.float32) for _ in range(3)]
    g, jg = _cnn(GraphBuilder, infer_types), _cnn(JGraphBuilder, j_infer_types)
    q16, jq16 = quantize(g, calib, W8A16), j_quantize(jg, calib, config=J_W8A16)
    assert q16.to_json() == jq16.to_json()
    assert {"int16", "int64"} <= {n.dtype for n in q16.nodes}
    x = calib[0]
    names = computational_nodes(jq16)
    want = j_run_graph(jq16, x)
    jx = JaxExecutor(jq16, capture=names, fuse=False).run(x)
    own = TorchExecutor(q16, capture=names, device="cpu").run(x)
    ref_nodes = _captured_oracle(jq16, x, names)
    for nm, a, b, c in zip(names, own, jx, ref_nodes):
        assert a.dtype == np.asarray(c).dtype, nm
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=nm)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=nm)
    np.testing.assert_array_equal(TorchExecutor(q16, device="cpu").run(x)[0], want[0])
    # W8A16 is closer to float than int8 (the test of the JAX package)
    ref = np.asarray(run_graph(g, x)[0], np.float64)
    e16 = np.abs(np.asarray(want[0], np.float64) - ref).mean()
    q8 = quantize(g, calib, QConfig())
    e8 = np.abs(np.asarray(TorchExecutor(q8, device="cpu").run(x)[0], np.float64) - ref).mean()
    assert e16 < e8 * 0.75


def _captured_oracle(graph, x, names):
    seen = {}
    j_run_graph(graph, x, intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    return [seen[nm] for nm in names]


@pytest.fixture(scope="module")
def w8a16_resnet():
    """ResNet-18 at 32^2 b2, quantized W8A16 by both packages."""
    rng = np.random.default_rng(5)
    calib = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    q = quantize(resnet(18, batch_size=2, image_size=32, num_classes=10), [calib], W8A16)
    jq = j_quantize(j_resnet(18, batch_size=2, image_size=32, num_classes=10), [calib],
                    config=J_W8A16)
    return q, jq, x


def test_w8a16_resnet_graph_and_fused_graph_equal_the_references(w8a16_resnet):
    q, jq, _ = w8a16_resnet
    assert q.to_json() == jq.to_json()
    ops = {}
    for n in q.nodes:
        ops[(n.op, n.dtype)] = ops.get((n.op, n.dtype), 0) + 1
    assert ops[("qnn.conv2d", "int64")] == 20 and ops[("qnn.dense", "int64")] == 1
    assert ops[("qnn.requantize", "int16")] == 21 and ("qnn.add", "int16") in ops
    # the int16 activation limits and int64 biases of the quantizer
    quant = [n for n in q.nodes if n.op == "qnn.quantize"]
    assert quant and all(n.attrs["out_dtype"] == "int16" for n in quant)
    biases = [q.params[n.inputs[1]] for n in q.nodes if n.op == "nn.bias_add"]
    assert biases and all(b.dtype == np.int64 for b in biases)
    rq = [n for n in q.nodes if n.op == "qnn.requantize"]
    assert all(n.attrs["out_dtype"] == "int16" for n in rq)
    clips = [n for n in q.nodes if n.op == "clip" and n.dtype == "int16"]
    assert clips and all(n.attrs["a_min"] >= -32768 for n in clips)
    fused, jfused = fuse_qnn(q), j_fuse_qnn(jq)
    assert fused.to_json() == jfused.to_json()
    # the int64 heads stay unfused
    assert not any(n.op.startswith("tk.") for n in fused.nodes)


def test_w8a16_resnet_every_node_equals_the_reference(w8a16_resnet):
    q, jq, x = w8a16_resnet
    names = computational_nodes(jq)
    want = _captured_oracle(jq, x, names)
    own = TorchExecutor(q, capture=names, device="cpu", fuse=True).run(x)
    jx = JaxExecutor(jq, capture=names, fuse=False).run(x)
    for nm, a, b, c in zip(names, own, jx, want):
        assert a.dtype == c.dtype and a.shape == c.shape, nm
        if c.dtype.kind in "iu":
            np.testing.assert_array_equal(a, c, err_msg=nm)
            np.testing.assert_array_equal(np.asarray(b), c, err_msg=nm)
        else:  # the softmax: another float32 sum order on XLA
            np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL, err_msg=nm)
            np.testing.assert_allclose(np.asarray(b), c, rtol=RTOL, atol=ATOL, err_msg=nm)


def test_w8a16_resnet_trace_is_the_references_numpy_trace(w8a16_resnet):
    q, jq, x = w8a16_resnet
    blob = emit_trace(q, x, backend="torch", device="cpu")
    want = j_emit_trace(jq, x, backend="numpy")
    got_recs = list(fmt.TraceReader(io.BytesIO(blob)))
    want_recs = list(j_format.TraceReader(io.BytesIO(want)))
    assert len(got_recs) == len(want_recs)
    dtypes = set()
    for a, b in zip(got_recs, want_recs):
        dtypes |= {t.dtype for t in a.tensors}
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), a.name
        else:  # the dequantized logits: a float32 product of equal integers
            for ta, tb in zip(a.tensors, b.tensors):
                np.testing.assert_array_equal(ta.to_array(), tb.to_array())
    assert {"int16", "int64"} <= dtypes
    assert blob == want
    res = verify_trace(blob, q)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got_recs)


# ---------------------------------------------------------------------------
# runtime/validate.py (tests/test_validate.py's cases)
# ---------------------------------------------------------------------------

def test_validate_good_graph(rng):
    data = [rng.standard_normal((1, 28, 28, 1)).astype(np.float32)]
    qg = quantize(lenet5(batch_size=1), data)
    rep = validate_graph(qg)
    assert rep.ok and rep.errors == [] and rep.warnings == []
    jrep = j_validate(j_quantize(j_lenet5(batch_size=1), data))
    assert jrep.ok and jrep.errors == rep.errors


def test_validate_catches_unregistered_op_and_missing_torch_impl():
    g = Graph([Node("x", "var", shape=(2,), dtype="float32"),
               Node("y", "my.unknown.op", ("x",))], ["y"])
    rep = validate_graph(g)
    assert not rep.ok and any("my.unknown.op" in e for e in rep.errors)
    b = GraphBuilder()
    x = b.var("x", (2, 4), "float32")
    rep = validate_graph(infer_types(b.build(b.call("nn.softmax", x))))
    assert rep.ok and rep.warnings == []
    registry.register_op("test.no_torch", infer=lambda node, ins: ins[0],
                         np_impl=lambda a, *, node: a)
    g = infer_types(Graph([Node("x", "var", shape=(2,), dtype="float32"),
                           Node("y", "test.no_torch", ("x",))], ["y"]))
    rep = validate_graph(g)
    assert rep.ok and rep.warnings == ["y: op test.no_torch has no torch impl"]
    assert validate_graph(g, require_torch=False).warnings == []


def test_overflow_audit_clean(rng):
    b = GraphBuilder()
    x = b.var("x", (2, 16), "int8")
    w = b.const(rng.integers(-10, 10, (16, 8)).astype(np.int8))
    g = infer_types(b.build(b.call("qnn.dense", x, w, input_zero_point=0, kernel_zero_point=0,
                                   out_dtype="int32")))
    assert audit_int32_overflow(g, rng.integers(-10, 10, (2, 16)).astype(np.int8)) == []


def test_overflow_audit_flags_as_the_reference():
    findings = []
    for builder, infer, audit in ((GraphBuilder, infer_types, audit_int32_overflow),
                                  (JGraphBuilder, j_infer_types, j_audit)):
        b = builder()
        x = b.var("x", (1, 64), "int32")
        w = b.const(np.full((64, 4), 2 ** 20, dtype=np.int32))
        g = infer(b.build(b.call("qnn.dense", x, w, input_zero_point=0, kernel_zero_point=0,
                                 out_dtype="int32")))
        findings.append(audit(g, np.full((1, 64), 2 ** 12, dtype=np.int32)))
    own, ref = findings
    assert own and own[0].op == "qnn.dense" and own[0].headroom_bits < 0
    assert [vars(f) for f in own] == [vars(f) for f in ref]


def test_overflow_audit_accepts_w8a16(rng):
    b = GraphBuilder()
    x = b.var("x", (2, 64), "int16")
    w = b.const(rng.integers(-127, 127, (64, 32)).astype(np.int8), "w")
    g = infer_types(b.build(b.call("qnn.dense", x, w, out_dtype="int64")))
    assert audit_int32_overflow(g, rng.integers(-30000, 30000, (2, 64)).astype(np.int16)) == []
