"""The arithmetic of K2's, K3's and K4's Hopper kernels
(csrc/qconv_igemm_hopper.cu) that the CPU can check, against the JAX
package's oracle:

  * K3's residual add as two 256-entry tables (`res_add_table_plain`) ==
    `res_add_plain` and the JAX package's `_res_add_np` over all 65,536
    (v, r) int8 pairs, both roundings, each side skipped or not;
  * K3's requantize product, one widening multiply then the left shift
    (`q_multiply_shift_wide_np`), == `q_multiply_shift_np` at the extremes
    of x, m and the shift;
  * K4's split of K (`raw_split`) covers every K index exactly once, each
    split non-empty, at every ResNet-50 b1 conv shape of the trace path and
    MobileNetV2 b1's stem;
  * K2's split of K (`rq_split`) does the same at every ResNet-50 b8 and
    VGG-16 b8 call shape and every tile, and its int32 partial sums, added
    in wraparound, give the complete sum the requantize takes;
  * the K-major weights the three kernels stage from (`kmajor_weights`).

The kernels themselves run on the card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

from tachikoma_tpu.ops.fixed_point import q_multiply_shift_np as j_qms
from tachikoma_tpu.runtime.fuse import _res_add_np as j_res_add_np
from tachikoma_tpu_torch.ops.kernels import conv
from tachikoma_tpu_torch.ops.kernels.requantize import (plan_res_add, q_multiply_shift_wide_np,
                                                         res_add_plain, res_add_table_plain,
                                                         res_add_tables)

ROUNDINGS = ("UPWARD", "TONEAREST")


def _ra(l_skip, r_skip, rounding, clip):
    """Residual-add attrs; a skipped side has the output's scale and zero point."""
    ra = dict(lhs_scale=0.03 if l_skip else 0.061, lhs_zero_point=4 if l_skip else -3,
              rhs_scale=0.03 if r_skip else 0.044, rhs_zero_point=4 if r_skip else 7,
              output_scale=0.03, output_zero_point=4, rounding=rounding)
    if clip:
        ra.update(a_min=-90, a_max=100)
    return ra


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("l_skip,r_skip", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_residual_add_tables_equal_the_add_on_every_pair(rounding, l_skip, r_skip):
    ra = _ra(l_skip, r_skip, rounding, clip=not (l_skip and r_skip))
    plan = plan_res_add(ra)
    assert (plan["lhs"][0], plan["rhs"][0]) == (l_skip, r_skip)
    v8 = torch.arange(256).to(torch.uint8).view(torch.int8)
    v, r = (t.contiguous() for t in torch.meshgrid(v8, v8, indexing="ij"))
    got = res_add_table_plain(v, r, ra)
    assert torch.equal(got, res_add_plain(v, r, ra))
    np.testing.assert_array_equal(got.numpy(), j_res_add_np(v.numpy(), r.numpy(), ra))
    tl, tr = res_add_tables(plan)
    assert tl.dtype == tr.dtype == torch.int32 and tl.shape == tr.shape == (256,)
    if l_skip:  # the identity, by bits
        assert torch.equal(tl, v8.to(torch.int32))
    if r_skip:
        assert torch.equal(tr, v8.to(torch.int32) - 4)


def test_residual_add_tables_wrap_like_the_oracle():
    """Extreme scales push a side past int32 before the clip: the tables add
    with the oracle's int32 wraparound."""
    ra = dict(lhs_scale=3e6, lhs_zero_point=-128, rhs_scale=2e6, rhs_zero_point=127,
              output_scale=1e-3, output_zero_point=-7, rounding="TONEAREST")
    v8 = torch.arange(256).to(torch.uint8).view(torch.int8)
    v, r = (t.contiguous() for t in torch.meshgrid(v8, v8, indexing="ij"))
    got = res_add_table_plain(v, r, ra)
    assert torch.equal(got, res_add_plain(v, r, ra))
    np.testing.assert_array_equal(got.numpy(), j_res_add_np(v.numpy(), r.numpy(), ra))


X_EXTREMES = np.array([-2 ** 31, -2 ** 31 + 1, -2 ** 30, -65536, -1, 0, 1, 3, 65535, 2 ** 30,
                       2 ** 31 - 2, 2 ** 31 - 1], np.int64)
M_EXTREMES = [-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 30, 1518500250, 2 ** 31 - 1]


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("m", M_EXTREMES)
def test_wide_product_equals_q_multiply_shift(rounding, m):
    rng = np.random.default_rng(m & 0xffff)
    x = np.concatenate([X_EXTREMES, rng.integers(-2 ** 31, 2 ** 31, 64)])
    for shift in range(-31, 32):
        want = j_qms(x.astype(np.int32), m, shift, rounding)
        np.testing.assert_array_equal(q_multiply_shift_wide_np(x, m, shift, rounding), want,
                                      err_msg=f"m={m} shift={shift}")


def test_wide_product_per_channel_broadcast():
    rng = np.random.default_rng(1)
    x = rng.integers(-2 ** 31, 2 ** 31, (5, 16))
    m = rng.integers(2 ** 30, 2 ** 31, 16)
    s = rng.integers(-31, 8, 16)
    got = q_multiply_shift_wide_np(x, m, s, "UPWARD")
    want = np.stack([j_qms(x[:, c].astype(np.int32), int(m[c]), int(s[c]), "UPWARD")
                     for c in range(16)], axis=1)
    np.testing.assert_array_equal(got, want)


# (x shape, k, stride, padding, cout): ResNet-50 b1 224^2's conv-mode calls
# (the stem and the eight 3x3 shapes) and MobileNetV2 b1's stem
RAW_SHAPES = [
    ((1, 224, 224, 3), 7, 2, 3, 64),
    ((1, 56, 56, 64), 3, 1, 1, 64),
    ((1, 56, 56, 128), 3, 2, 1, 128),
    ((1, 28, 28, 128), 3, 1, 1, 128),
    ((1, 28, 28, 256), 3, 2, 1, 256),
    ((1, 14, 14, 256), 3, 1, 1, 256),
    ((1, 14, 14, 512), 3, 2, 1, 512),
    ((1, 7, 7, 512), 3, 1, 1, 512),
    ((1, 224, 224, 3), 3, 2, 1, 32),
]


def _mk(shape, k, s, p, cout):
    n, h, w, cin = shape
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    return n * oh * ow, cout, k * k * cin


@pytest.mark.parametrize("case", RAW_SHAPES)
def test_raw_split_covers_every_k_index_once(case):
    m, cout, k = _mk(*case)
    ks, kper = conv.raw_split(m, cout, k)
    steps = -(-k // conv.KSTEP)
    covered = np.zeros(steps * conv.KSTEP, np.int64)
    for z in range(ks):
        lo, hi = z * kper, min((z + 1) * kper, steps)
        assert lo < hi, f"split {z} of {ks} is empty"
        covered[lo * conv.KSTEP:hi * conv.KSTEP] += 1
    assert (covered == 1).all()
    tiles = -(-m // conv.RAW_TILE[0]) * -(-cout // conv.RAW_TILE[1])
    if tiles >= 132 or steps <= conv.RAW_UNSPLIT_STEPS:
        assert ks == 1  # the tiles fill the card, or K is short
    else:  # short splits, at most two blocks an SM
        assert kper <= conv.RAW_SPLIT_STEPS and ks * tiles <= 2 * 132


def test_raw_split_of_the_trace_path():
    """The splits chip_smoke.py phase 7 reports for ResNet-50 b1."""
    got = [conv.raw_split(*_mk(*c)) for c in RAW_SHAPES]
    assert got == [(1, 3), (1, 9), (3, 6), (3, 6), (6, 6), (6, 6), (12, 6), (12, 6), (1, 1)]


# (x shape, k, stride, padding, cout): K2's calls of ResNet-50 b8 (the stem,
# the 3x3 stages and the three 3x3 s2 convs) and VGG-16 b8 (its 3x3s)
RQ_SHAPES = [
    ((8, 224, 224, 3), 7, 2, 3, 64),
    ((8, 56, 56, 64), 3, 1, 1, 64),
    ((8, 56, 56, 128), 3, 2, 1, 128),
    ((8, 28, 28, 128), 3, 1, 1, 128),
    ((8, 28, 28, 256), 3, 2, 1, 256),
    ((8, 14, 14, 256), 3, 1, 1, 256),
    ((8, 14, 14, 512), 3, 2, 1, 512),
    ((8, 7, 7, 512), 3, 1, 1, 512),
    ((8, 224, 224, 3), 3, 1, 1, 64),
    ((8, 224, 224, 64), 3, 1, 1, 64),
    ((8, 112, 112, 64), 3, 1, 1, 128),
    ((8, 112, 112, 128), 3, 1, 1, 128),
    ((8, 56, 56, 128), 3, 1, 1, 256),
    ((8, 56, 56, 256), 3, 1, 1, 256),
    ((8, 28, 28, 256), 3, 1, 1, 512),
    ((8, 28, 28, 512), 3, 1, 1, 512),
    ((8, 14, 14, 512), 3, 1, 1, 512),
]


@pytest.mark.parametrize("case", RQ_SHAPES)
def test_rq_split_covers_every_k_step_once(case):
    m, cout, k = _mk(*case)
    steps = -(-k // conv.KSTEP)
    for tile in ((64, 64), (64, 128), (128, 64), (128, 128)):
        ks, kper = conv.rq_split(m, cout, k, tile)
        covered = np.zeros(steps, np.int64)
        for z in range(ks):
            lo, hi = z * kper, min((z + 1) * kper, steps)
            assert lo < hi, f"split {z} of {ks} is empty"
            covered[lo:hi] += 1
        assert (covered == 1).all()
        tiles = -(-m // tile[0]) * -(-cout // tile[1])
        if tiles >= 132 or steps <= conv.RQ_UNSPLIT_STEPS:
            assert ks == 1  # the tiles fill the card, or K is short
        else:  # no more blocks than fill the card RQ_FILL times, no split too short
            assert ks > 1 and (ks - 1) * tiles < conv.RQ_FILL * 132
            assert kper >= conv.RQ_MIN_STEPS


def test_rq_launch_of_resnet50_and_vgg16():
    """The tiles and splits chip_smoke.py phases 4 and 16a.2 report: K2
    splits only ResNet-50 b8's 14^2 and 7^2 calls; VGG-16 b8's large convs
    take the 128-row tiles, its 28^2 ones 64 x 128."""
    got = [conv.rq_launch(c[0], (c[1], c[1], c[0][3], c[4]), (c[2],) * 2, (c[3],) * 4)
           for c in RQ_SHAPES]
    assert got == [((128, 64), 1, 3), ((64, 64), 1, 9), ((64, 64), 1, 18), ((64, 64), 1, 18),
                   ((64, 64), 3, 12), ((64, 64), 3, 12), ((64, 64), 5, 15), ((64, 64), 5, 15),
                   ((128, 64), 1, 1), ((128, 64), 1, 9), ((128, 128), 1, 9),
                   ((128, 128), 1, 18), ((128, 128), 1, 18), ((128, 128), 1, 36),
                   ((64, 128), 1, 36), ((64, 128), 1, 72), ((64, 64), 1, 72)]


def test_rq_split_partial_sums_wrap_to_the_total():
    """Each split's int32 sum of its K steps, added into a zeroed int32 in
    any order with wraparound, is the whole K's wraparound sum: what K2's
    last block reads back and requantizes."""
    rng = np.random.default_rng(0)
    k = 7 * 64
    prod = rng.integers(-128 * 127, 128 * 128, (5, k)).astype(np.int64) * 65537
    want = (prod.sum(1) + 2 ** 31) % 2 ** 32 - 2 ** 31
    for ks, kper in [(1, 7), (2, 4), (3, 3), (7, 1)]:
        parts = [prod[:, z * kper * 64:(z + 1) * kper * 64].sum(1) for z in range(ks)]
        parts = [(p + 2 ** 31) % 2 ** 32 - 2 ** 31 for p in parts]  # each split's int32
        for order in (range(ks), reversed(range(ks))):
            total = np.zeros(5, np.int64)
            for z in order:
                total = (total + parts[z] + 2 ** 31) % 2 ** 32 - 2 ** 31
            np.testing.assert_array_equal(total, want)
    assert (np.abs(prod.sum(1)) >= 2 ** 31).any()  # the sums did wrap


@pytest.mark.parametrize("wshape", [(1, 1, 64, 256), (3, 3, 40, 24), (7, 7, 3, 64),
                                    (3, 3, 3, 32)])
def test_kmajor_weights(wshape):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.integers(-128, 128, wshape).astype(np.int8))
    kh, kw, cin, cout = wshape
    k = kh * kw * cin
    wk = conv.kmajor_weights(w)
    steps = -(-k // 64)
    assert wk.shape == (steps, cout, 64) and wk.is_contiguous()
    flat = wk.transpose(0, 1).reshape(cout, steps * 64)  # output channel n's K row
    for n in (0, cout - 1):
        assert torch.equal(flat[n, :k], w[..., n].reshape(k))  # (ky, kx, ci) order
    assert not flat[:, k:].any()
    assert conv.kmajor_weights(w) is wk
    w.neg_()
    flat = conv.kmajor_weights(w).transpose(0, 1).reshape(cout, steps * 64)
    assert torch.equal(flat[:, :k], w.reshape(k, cout).t())
    key = id(w)
    del w
    assert key not in conv._KMAJOR
