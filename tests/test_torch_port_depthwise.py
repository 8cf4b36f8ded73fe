"""K5 on the CPU: the depthwise int8 conv's plain versions, and qconv2d_flat
with groups == C, against the JAX package and the numpy oracle.

  * requantize mode: `qdwconv_rq_plain` and `qconv2d_flat(groups=C)` ==
    the JAX package's `conv_flat.qconv2d_flat(groups=C)` on its Pallas route
    (`TK_CONV_ROUTE=pallas`: `_flat_dw_kernel` in interpret mode) and on its
    default route, and == the oracle (qnn.conv2d + bias + requantize, clipped
    to qmin/qmax);
  * raw mode: `qdwconv_raw_plain` and `qconv2d_flat(groups=C)` without a
    multiplier == the JAX package's grouped `qnn.conv2d` (`jax_impl`,
    lax.conv) + bias and == the oracle.

Integers are compared with ==.
"""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.ops.fixed_point import requantize_np
from tachikoma_tpu.ops.pallas.conv_flat import qconv2d_flat as j_qconv2d_flat
from tachikoma_tpu_torch.ops.kernels import _lib
from tachikoma_tpu_torch.ops.kernels.conv import qconv2d_flat
from tachikoma_tpu_torch.ops.kernels.depthwise import (dw_plan, dw_thread_outputs, qdwconv_raw,
                                                       qdwconv_raw_plain, qdwconv_rq,
                                                       qdwconv_rq_plain)
from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize

CASES = [
    # (x shape, k, strides, padding (t, l, b, r), izp, qmin, qmax, rounding)
    ((2, 10, 10, 24), 3, (1, 1), (1, 1, 1, 1), 0, -128, 127, "UPWARD"),     # dw s1
    ((1, 11, 11, 96), 3, (2, 2), (1, 1, 1, 1), 3, -128, 127, "UPWARD"),     # dw s2, odd edge
    ((1, 12, 12, 96), 3, (2, 2), (1, 1, 1, 1), 0, 0, 24, "UPWARD"),         # s2 even, ReLU6 bounds
    ((1, 9, 9, 13), 5, (2, 2), (2, 2, 2, 2), -5, -128, 127, "TONEAREST"),   # 5x5 s2, C % 4 != 0
    ((2, 8, 7, 13), 3, (1, 1), (0, 1, 0, 1), 7, 0, 8, "UPWARD"),            # asymmetric pad
    ((1, 7, 9, 24), 3, (2, 1), (1, 0, 2, 1), -2, -10, 100, "TONEAREST"),    # mixed strides
]


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _operands(rng, case):
    shape, k, _, _, _, _, _, _ = case
    c = shape[3]
    x, w = _i8(rng, shape), _i8(rng, (k, k, 1, c))
    bias = rng.integers(-3000, 3000, c).astype(np.int32)
    scales = 0.0002 + rng.random(c) * 0.0006       # per-channel: per-channel shifts
    return x, w, bias, scales


def _oracle_acc(x, w, case):
    _, _, strides, padding, izp, _, _, _ = case
    node = JNode("c", "qnn.conv2d", ("d", "w"),
                 {"strides": strides, "padding": padding, "groups": x.shape[3],
                  "input_zero_point": izp, "kernel_zero_point": 0, "out_dtype": "int32"})
    return j_get_op("qnn.conv2d").np_impl(x, w, node=node), node


@pytest.mark.parametrize("route", ["pallas", ""])
@pytest.mark.parametrize("case", CASES)
def test_requantize_mode_matches_jax_routes_and_oracle(rng, monkeypatch, route, case):
    _, _, strides, padding, izp, qmin, qmax, rounding = case
    x, w, bias, scales = _operands(rng, case)
    m, s = plan_requantize(scales, 0.07)
    assert len(set(s.tolist())) > 1
    out_zp = 4 if qmin == -128 else 0
    monkeypatch.setenv("TK_CONV_ROUTE", route)
    want = np.asarray(j_qconv2d_flat(
        x, w, bias=bias, multiplier=m, shift=s, strides=strides, padding=padding,
        groups=x.shape[3], input_zero_point=izp, out_zp=out_zp, rounding=rounding,
        qmin=qmin, qmax=qmax))
    acc, _ = _oracle_acc(x, w, case)
    oracle = np.clip(requantize_np(acc + bias, scales, 0, 0.07, out_zp, axis=3,
                                   rounding=rounding, out_dtype="int8"), qmin, qmax)
    np.testing.assert_array_equal(want, oracle)

    kw = dict(strides=strides, padding=padding, rounding=rounding, qmin=qmin, qmax=qmax)
    got = qconv2d_flat(torch.from_numpy(x), w, bias, m, s, groups=x.shape[3],
                       input_zero_point=izp, out_zp=out_zp, **kw).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    c = x.shape[3]
    plain = qdwconv_rq_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                             channel_vector(m, c, "cpu"), channel_vector(s, c, "cpu"),
                             izp=izp, out_zp=out_zp, **kw).numpy()
    np.testing.assert_array_equal(plain, want)


@pytest.mark.parametrize("case", CASES)
def test_raw_mode_matches_jax_grouped_conv_and_oracle(rng, case):
    _, _, strides, padding, izp, _, _, _ = case
    x, w, bias, _ = _operands(rng, case)
    acc, node = _oracle_acc(x, w, case)
    jax_acc = np.asarray(j_get_op("qnn.conv2d").jax_impl(x, w, node=node))
    np.testing.assert_array_equal(jax_acc, acc)
    want = (acc.astype(np.int64) + bias).astype(np.int32)
    got = qdwconv_raw_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                            strides=strides, padding=padding, izp=izp).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got = qconv2d_flat(torch.from_numpy(x), w, bias, strides=strides, padding=padding,
                       groups=x.shape[3], input_zero_point=izp).numpy()
    np.testing.assert_array_equal(got, want)


def test_raw_mode_wraps_like_int32(rng):
    """acc + bias wraps around in int32, as the oracle's int32 bias add does."""
    x = np.full((1, 3, 3, 4), -128, np.int8)
    w = np.full((3, 3, 1, 4), -128, np.int8)
    bias = np.array([2 ** 31 - 1, -(2 ** 31), 0, 5], np.int32)
    got = qdwconv_raw_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                            padding=(1, 1, 1, 1), izp=127).numpy()
    acc = _oracle_acc(x, w, ((1, 3, 3, 4), 3, (1, 1), (1, 1, 1, 1), 127, 0, 0, ""))[0]
    np.testing.assert_array_equal(got, (acc.astype(np.int64) + bias).astype(np.int32))


def test_wrappers_on_cpu_count_no_launch_and_refuse_other_devices(rng):
    x, w = torch.from_numpy(_i8(rng, (1, 5, 5, 8))), torch.from_numpy(_i8(rng, (3, 3, 1, 8)))
    b = torch.zeros(8, dtype=torch.int32)
    before = dict(_lib.LAUNCHES)
    qdwconv_raw(x, w, b, padding=(1, 1, 1, 1))
    qdwconv_rq(x, w, b, b + (1 << 30), b - 8, padding=(1, 1, 1, 1))
    assert dict(_lib.LAUNCHES) == before
    meta = [t.to("meta") for t in (x, w, b)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        qdwconv_raw(*meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        qdwconv_rq(*meta, meta[2], meta[2])


@pytest.mark.parametrize("wshape,groups", [((3, 3, 1, 16), 8),      # channel multiplier 2
                                           ((3, 3, 2, 8), 4)])      # grouped, not depthwise
def test_qconv2d_flat_refuses_other_grouped_convs(rng, wshape, groups):
    """Grouped convs other than depthwise run on K2 / K4's conv mode now
    (== the oracle's grouped qnn.conv2d), a dilated depthwise conv on K5
    (== the oracle too); groups that do not fit the channels are an
    error."""
    x, w = _i8(rng, (1, 5, 5, 8)), _i8(rng, wshape)
    node = JNode("c", "qnn.conv2d", ("d", "w"),
                 {"padding": (1, 1, 1, 1), "groups": groups, "input_zero_point": 3,
                  "kernel_zero_point": 0, "out_dtype": "int32"})
    want = j_get_op("qnn.conv2d").np_impl(x, w, node=node)
    got = qconv2d_flat(torch.from_numpy(x), w, groups=groups, padding=(1, 1, 1, 1),
                       input_zero_point=3)
    np.testing.assert_array_equal(got.numpy(), want)
    wd = _i8(rng, (3, 3, 1, 8))
    dnode = JNode("c", "qnn.conv2d", ("d", "w"),
                  {"groups": 8, "dilation": (2, 2), "input_zero_point": 3,
                   "kernel_zero_point": 0, "out_dtype": "int32"})
    got = qconv2d_flat(torch.from_numpy(x), wd, groups=8, dilation=(2, 2), input_zero_point=3)
    np.testing.assert_array_equal(got.numpy(), j_get_op("qnn.conv2d").np_impl(x, wd, node=dnode))
    with pytest.raises(ValueError, match=f"groups {groups + 1} do not fit"):
        qconv2d_flat(torch.from_numpy(x), w, groups=groups + 1)


# MobileNetV2 224^2's 17 depthwise convs as (input side, channels, stride),
# 3x3 pad 1, at b8 and b1; then odd ones: C % 4 != 0, 5x5 and 7x7, stride 2
# with asymmetric padding, stride 3, a channel count of three tiles
MBV2_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1), (28, 192, 1),
           (28, 192, 2), (14, 384, 1), (14, 384, 1), (14, 384, 1), (14, 384, 1), (14, 576, 1),
           (14, 576, 1), (14, 576, 2), (7, 960, 1), (7, 960, 1), (7, 960, 1)]
PLAN_CASES = ([((b, side, side, c), 3, s, (1, 1, 1, 1)) for b in (8, 1) for side, c, s in MBV2_DW]
              + [((2, 9, 9, 13), 5, 2, (2, 2, 2, 2)), ((2, 8, 7, 24), 3, 1, (0, 1, 2, 0)),
                 ((1, 10, 10, 300), 7, 3, (3, 3, 3, 3)), ((2, 11, 13, 20), 3, 2, (0, 1, 1, 0)),
                 ((1, 9, 9, 16), 7, 1, (3, 3, 3, 3)), ((1, 12, 12, 40), 3, 2, (1, 0, 1, 0)),
                 ((1, 3, 3, 5), 3, 1, (0, 0, 0, 0))])


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"k{c[1]}s{c[2]}")
def test_tile_plan_covers_every_output_once(case):
    """K5's tile plan: the outputs its launch's threads write (R pixels x 4
    channels each, as csrc/qdwconv.cu maps them) cover every pixel and
    channel exactly once; a block's window and weights fit in 227 KB of
    shared memory, its threads in 256; where there is work for it, the grid
    has a block for every SM."""
    shape, k, s, (pt, pl, pb, pr) = case
    n, h, w, c = shape
    oh, ow = (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1
    plan = dw_plan(n, oh, ow, c, k, k, s, s)
    assert plan["ct"] in (16, 32, 48, 64) and plan["tw"] % 4 == 0
    assert plan["threads"] == plan["ct"] // 4 * plan["th"] * plan["tw"] // 4 <= 256
    iw = (plan["tw"] - 1) * s + k
    assert plan["rp"] % 4 == 0 and plan["rp"] >= iw * plan["ct"] // 4
    assert plan["smem"] <= 227 * 1024
    outs = dw_thread_outputs(plan, n, oh, ow, c)
    flat = ((outs[:, 0] * oh + outs[:, 1]) * ow + outs[:, 2]) * c + outs[:, 3]
    assert len(flat) == n * oh * ow * c
    np.testing.assert_array_equal(np.sort(flat), np.arange(n * oh * ow * c))
    if n * oh * ow * c >= 132 * 4096:   # work enough for a block of 4 K outputs an SM
        assert plan["blocks"] >= 132
