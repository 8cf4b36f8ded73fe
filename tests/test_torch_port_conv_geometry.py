"""Dilated and grouped int8 convs on the CPU: the plain versions of K2
(`qconv_rq_plain`) and K4's conv mode (`qconv_raw_plain`) and the entries
that route to them, against the JAX package's `tk.conv2d_rq` and
`qnn.conv2d` (their XLA impls and their numpy oracles; the XLA
`tk.conv2d_rq` at three of the cases, `XLA_RQ`).

  * dilations 2, 4, 12 on maps at least 2 d + 1 wide (every tap lands), 36
    on an 80^2 map of 8 channels; groups 32 at group widths 4 and 32, groups
    2 with CIN / G != COUT / G, groups with stride 2 and with dilation;
    izp != 0;
  * the kernels' grouped form: a super-group of `group_span` groups as one
    dense conv of its channel run and its block-diagonal weights
    (`expand_groups`, packed by `grouped_weights`), the border filled with
    izp and izp * colsum(w) taken off the bias, == plain;
  * the tuning key: a dilated conv's key carries its dilation, undilated
    keys stay the reference's, and no record of an undilated conv (nor its
    layout) reaches a dilated one;
  * what stays refused: a dilated depthwise conv (K5) and a dilated or
    grouped W8A16 conv, each naming its ROADMAP item.

Integers are compared with ==.
"""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import tachikoma_tpu.runtime.fuse  # noqa: F401  (registers tk.conv2d_rq)
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.ops.pallas.conv_flat import flat_conv_workload as j_workload
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.ops.kernels import _lib, conv
from tachikoma_tpu_torch.ops.kernels.matmul_int8 import fold_input_zero_point, kmajor_pack
from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
from tachikoma_tpu_torch.tune import database as p_db

# (x shape, k, stride, dilation, groups, cout, izp); padding d * (k // 2)
CASES = [
    ((1, 9, 9, 16), 3, 1, 2, 1, 24, 0),
    ((2, 11, 11, 8), 3, 1, 4, 1, 16, -3),
    ((1, 27, 25, 8), 3, 1, 12, 1, 8, 5),
    ((1, 80, 80, 8), 3, 1, 36, 1, 8, -7),       # ASPP's rate 36 on an 80^2 map
    ((2, 6, 6, 128), 3, 1, 1, 32, 128, 3),      # groups 32, group width 4
    ((1, 4, 4, 1024), 3, 1, 1, 32, 1024, 0),    # groups 32, group width 32
    ((1, 7, 7, 12), 3, 1, 1, 2, 10, 2),         # groups 2, CIN / G 6, COUT / G 5
    ((2, 9, 9, 64), 3, 2, 1, 8, 64, -4),        # groups with stride 2
    ((1, 13, 13, 32), 3, 2, 3, 4, 48, 1),       # groups, dilation and stride
    ((1, 10, 12, 24), 5, 1, 2, 3, 9, 6),        # 5x5, groups 3
]
IDS = [f"x{'x'.join(map(str, c[0]))}-k{c[1]}s{c[2]}d{c[3]}g{c[4]}o{c[5]}" for c in CASES]
# the cases whose requantize mode is also held to the XLA impl of
# tk.conv2d_rq, run eagerly (its conv is held to XLA at every case through
# qnn.conv2d; an eager epilogue costs seconds a shape)
XLA_RQ = {3, 4, 8}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions in one thread: the suite runs a worker a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _operands(rng, case):
    shape, k, s, d, g, cout, izp = case
    x, w = _i8(rng, shape), _i8(rng, (k, k, shape[3] // g, cout))
    bias = rng.integers(-3000, 3000, cout).astype(np.int32)
    geometry = dict(strides=(s, s), padding=(d * (k // 2),) * 4, dilation=(d, d), groups=g)
    return x, w, bias, geometry, izp


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_raw_mode_matches_jax_and_oracle(rng, case):
    x, w, bias, geometry, izp = _operands(rng, case)
    attrs = dict(geometry, input_zero_point=izp, kernel_zero_point=0, out_dtype="int32")
    node = JNode("c", "qnn.conv2d", ("d", "w"), attrs)
    acc = j_get_op("qnn.conv2d").np_impl(x, w, node=node)
    np.testing.assert_array_equal(np.asarray(j_get_op("qnn.conv2d").jax_impl(x, w, node=node)),
                                  acc)
    want = (acc.astype(np.int64) + bias).astype(np.int32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, bias))
    before = dict(_lib.LAUNCHES)
    np.testing.assert_array_equal(conv.qconv_raw_plain(tx, tw, tb, izp=izp, **geometry).numpy(),
                                  want)
    np.testing.assert_array_equal(conv.qconv2d_flat(tx, w, bias, input_zero_point=izp,
                                                    **geometry).numpy(), want)
    got = get_op("qnn.conv2d").torch_impl(tx, tw, node=Node("c", "qnn.conv2d", ("d", "w"),
                                                                 attrs))
    np.testing.assert_array_equal(got.numpy(), acc)
    assert dict(_lib.LAUNCHES) == before  # the CPU launches nothing


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_requantize_mode_matches_jax_and_oracle(rng, i):
    x, w, bias, geometry, izp = _operands(rng, CASES[i])
    cout = w.shape[3]
    m, s = plan_requantize(0.0002 + rng.random(cout) * 0.0006, 0.07)
    attrs = dict(geometry, input_zero_point=izp, kernel_zero_point=0, multiplier=m, shift=s,
                 output_zero_point=3, rounding="TONEAREST", out_dtype="int8", a_min=-100,
                 a_max=120, has_bias=True)
    jnode = JNode("c", "tk.conv2d_rq", ("d", "w", "b"), attrs)
    want = j_get_op("tk.conv2d_rq").np_impl(x, w, bias, node=jnode)
    if i in XLA_RQ:
        np.testing.assert_array_equal(
            np.asarray(j_get_op("tk.conv2d_rq").jax_impl(x, w, bias, node=jnode)), want)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, bias))
    kw = dict(izp=izp, out_zp=3, rounding="TONEAREST", qmin=-100, qmax=120, **geometry)
    plain = conv.qconv_rq_plain(tx, tw, tb, channel_vector(m, cout, "cpu"),
                                channel_vector(s, cout, "cpu"), **kw)
    np.testing.assert_array_equal(plain.numpy(), want)
    got = get_op("tk.conv2d_rq").torch_impl(tx, tw, tb, node=Node("c", "tk.conv2d_rq",
                                                                   ("d", "w", "b"), attrs))
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_model(x, w, bias, geometry, izp, bn):
    """What K2 / K4's conv mode compute for a call at the N tile `bn`: the
    image's border filled with izp; each super-group's run of input channels
    times its columns of the block-diagonal weights, one dense conv; the
    bias less izp * colsum(w) added."""
    groups = geometry["groups"]
    kh, kw, cin_g, cout = w.shape
    k, span = conv._geometry(tuple(x.shape), tuple(w.shape), bn, groups)
    we = conv.expand_groups(w, groups, span) if groups != 1 else w
    cspan = span * cin_g
    nspan = cout * cspan // x.shape[3]
    assert k == kh * kw * cspan and we.shape == (kh, kw, cspan, cout)
    assert nspan == cout or nspan % bn == 0  # no N tile straddles two super-groups
    pt, pl, pb, pr = geometry["padding"]
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb), value=izp)
    acc = torch.cat([conv.conv_acc_exact(xp[..., sg * cspan:(sg + 1) * cspan],
                                         we[..., sg * nspan:(sg + 1) * nspan],
                                         geometry["strides"], (0, 0, 0, 0), 0,
                                         geometry["dilation"])
                     for sg in range(cout // nspan)], dim=-1)
    return (acc + fold_input_zero_point(bias, w, izp).to(torch.int64)).to(torch.int32)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_super_groups_and_the_column_sum_fold_equal_plain(rng, case, bn):
    x, w, bias, geometry, izp = _operands(rng, case)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, bias))
    want = conv.qconv_raw_plain(tx, tw, tb, izp=izp, **geometry)
    assert torch.equal(_kernel_model(tx, tw, tb, geometry, izp, bn), want)


def test_block_diagonal_packing(rng):
    """ResNeXt-50's four group widths: the super-groups the 64- and
    128-column tiles take, the expanded weights' zeros and column sums, and
    the K-major packing of the expansion, made once per weight and span."""
    for cin_g, spans in ((4, (16, 32)), (8, (8, 16)), (16, (4, 8)), (32, (2, 4))):
        assert (conv.group_span(32, cin_g, 64), conv.group_span(32, cin_g, 128)) == spans
    assert conv.group_span(2, 5, 64) == 2 and conv.group_span(3, 3, 64) == 3
    w = torch.from_numpy(_i8(rng, (3, 3, 4, 128)))
    we = conv.expand_groups(w, 32, 16)
    assert we.shape == (3, 3, 64, 128)
    for n in range(128):
        g = (n % 64) // 4  # the column's group within its super-group
        assert torch.equal(we[:, :, 4 * g:4 * g + 4, n], w[:, :, :, n])
        assert not we[:, :, :4 * g, n].any() and not we[:, :, 4 * g + 4:, n].any()
    assert torch.equal(we.to(torch.int64).sum((0, 1, 2)), w.to(torch.int64).sum((0, 1, 2)))
    packed = conv.grouped_weights(w, 32, 16)
    assert conv.grouped_weights(w, 32, 16) is packed
    assert torch.equal(packed, kmajor_pack(we)) and packed.shape == (9, 128, 64)
    assert conv.grouped_weights(w, 32, 32).shape == (18, 128, 64)
    # a grouped K2 call without a tile takes 64 columns
    (bm, bn), ks, kper = conv.rq_launch((8, 56, 56, 128), (3, 3, 4, 128), (1, 1),
                                        (1, 1, 1, 1), groups=32)
    assert bn == 64 and ks * kper >= 9


def test_dilated_output_size():
    assert conv._out_hw((1, 65, 65, 8), (3, 3), (1, 1), (36,) * 4, (36, 36)) == (65, 65)
    assert conv._out_hw((1, 13, 13, 8), (3, 3), (2, 2), (3,) * 4, (3, 3)) == (7, 7)


def test_tuning_key_of_dilated_convs(monkeypatch):
    args = (8, 65, 65, 512, 512, 3, 3, (1, 1), True)
    assert conv.flat_conv_workload(*args) == j_workload(*args)
    assert conv.flat_conv_workload(*args, 32) == j_workload(*args, 32)
    assert conv.flat_conv_workload(*args, 1, (4, 4)) == j_workload(*args)[:-3] + "_D4x4_rq"
    x_shape, w_shape, pad = (8, 65, 65, 512), (3, 3, 512, 512), (4, 4, 4, 4)
    db = p_db.TuneDatabase()
    db.add(p_db.TuneRecord(conv.flat_conv_workload(*args), {"blocks": [128, 64, 64],
                                                            "layout": "t"}, 0.5))
    grouped = (8, 65, 65, 512, 512, 3, 3, (1, 1), True, 8)
    db.add(p_db.TuneRecord(conv.flat_conv_workload(*grouped), {"blocks": [64, 128, 64],
                                                               "layout": "t"}, 0.5))
    with p_db.apply_history_best(db):
        assert conv._conv_config(x_shape, w_shape, (1, 1), (1,) * 4, None, None) == (
            (128, 64, 64), "t")
        # the undilated record reaches neither the dilated conv nor its layout
        assert conv._conv_config(x_shape, w_shape, (1, 1), pad, None, None, (4, 4)) == (
            None, None)
        assert conv._conv_config(x_shape, w_shape, (1, 1), pad, None, "t", (4, 4)) == (
            None, None)
        # a grouped conv reads its own record's tile and no layout
        assert conv._conv_config(x_shape, (3, 3, 64, 512), (1, 1), (1,) * 4, None, None,
                                 (1, 1), 8) == ((64, 128, 64), None)
        db.add(p_db.TuneRecord(conv.flat_conv_workload(*args, 1, (4, 4)),
                               {"blocks": [64, 128, 64], "layout": "t"}, 0.5))
        assert conv._conv_config(x_shape, w_shape, (1, 1), pad, None, None, (4, 4)) == (
            (64, 128, 64), None)


def test_what_stays_refused_names_its_roadmap_item(rng):
    x = torch.from_numpy(_i8(rng, (1, 9, 9, 16)))
    dw = _i8(rng, (3, 3, 1, 16))
    m, s = plan_requantize(0.0004, 0.05)
    # a dilated depthwise conv is no longer refused: it runs on K5 (its
    # plain version here) == the JAX package's oracle
    attrs = dict(groups=16, dilation=(2, 2), padding=(2,) * 4)
    jnode = JNode("c", "qnn.conv2d", ("d", "w"), dict(attrs, input_zero_point=0,
                                                      kernel_zero_point=0, out_dtype="int32"))
    want = j_get_op("qnn.conv2d").np_impl(x.numpy(), dw, node=jnode)
    np.testing.assert_array_equal(conv.qconv2d_flat(x, dw, **attrs).numpy(), want)
    got = get_op("qnn.conv2d").torch_impl(x, torch.from_numpy(dw),
                                          node=Node("c", "qnn.conv2d", ("d", "w"), attrs))
    np.testing.assert_array_equal(got.numpy(), want)
    rq = dict(attrs, multiplier=m, shift=s)
    got = get_op("tk.conv2d_rq").torch_impl(
        x, torch.from_numpy(dw), node=Node("c", "tk.conv2d_rq", ("d", "w"), rq))
    want = j_get_op("tk.conv2d_rq").np_impl(x.numpy(), dw,
                                            node=JNode("c", "tk.conv2d_rq", ("d", "w"), rq))
    np.testing.assert_array_equal(got.numpy(), want)
    # a dilated or grouped W8A16 conv into int64 is no longer refused: it
    # runs on qconv_wide (its plain version here) == the JAX package's oracle
    x16 = rng.integers(-2000, 2000, (1, 9, 9, 16)).astype(np.int16)
    for more in (dict(dilation=(2, 2), padding=(2,) * 4), dict(groups=4, padding=(1,) * 4)):
        w = _i8(rng, (3, 3, 16 // more.get("groups", 1), 16))
        attrs = dict(more, out_dtype="int64")
        jnode = JNode("c", "qnn.conv2d", ("d", "w"), dict(attrs, input_zero_point=0,
                                                          kernel_zero_point=0))
        want = j_get_op("qnn.conv2d").np_impl(x16, w, node=jnode)
        got = get_op("qnn.conv2d").torch_impl(torch.from_numpy(x16), torch.from_numpy(w),
                                              node=Node("c", "qnn.conv2d", ("d", "w"), attrs))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    # a 1x1 conv's dilation is a no-op: on K1's plain version, == undilated
    w1 = _i8(rng, (1, 1, 16, 8))
    assert torch.equal(conv.qconv2d_flat(x, w1, multiplier=m, shift=s, dilation=(3, 3)),
                       conv.qconv2d_flat(x, w1, multiplier=m, shift=s))
    with pytest.raises(ValueError, match="groups 3 do not fit"):
        conv.qconv2d_flat(x, _i8(rng, (3, 3, 5, 15)), groups=3)
