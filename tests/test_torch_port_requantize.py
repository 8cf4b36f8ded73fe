"""The port's fixed-point core (tachikoma_tpu_torch/ops/fixed_point.py,
ops/kernels/requantize.py) against the JAX package's numpy oracle, with ==."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tachikoma_tpu.ops.fixed_point import (fixed_point_multiplier_shift as j_fpms,
                                           q_multiply_shift_np as j_qms,
                                           q_multiply_shift_per_axis_np as j_qms_axis,
                                           requantize_np as j_requantize_np)
from tachikoma_tpu.runtime.fuse import _res_add_np as j_res_add_np
from tachikoma_tpu_torch.ops.fixed_point import (fixed_point_multiplier_shift,
                                                 q_multiply_shift, q_multiply_shift_np,
                                                 q_multiply_shift_per_axis, requantize,
                                                 requantize_np)
from tachikoma_tpu_torch.ops.kernels.requantize import plan_res_add, res_add_plain

ROUNDINGS = ["UPWARD", "TONEAREST"]
# the multipliers of tests/test_qms32.py
MULTS = [1e-6, 0.0003, 0.021, 0.25, 0.4999, 0.5, 0.75, 1.0 - 2**-31, 1.5, 3.75]


def _values(rng, n=4096):
    """The value vectors of tests/test_qms32.py."""
    return np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int64),
        rng.integers(-(2**16), 2**16, size=n, dtype=np.int64),
        np.array([0, 1, -1, 127, -128, 2**31 - 1, -(2**31), 2**30, -(2**30)]),
    ]).astype(np.int32)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("mult", MULTS)
def test_q_multiply_shift_matches_oracle(rng, rounding, mult):
    m, s = fixed_point_multiplier_shift(mult)
    assert (m, s) == j_fpms(mult)
    xs = _values(rng)
    want = j_qms(xs, m, s, rounding)
    np.testing.assert_array_equal(q_multiply_shift_np(xs, m, s, rounding), want)
    np.testing.assert_array_equal(
        q_multiply_shift(torch.from_numpy(xs), m, s, rounding).numpy(), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_q_multiply_shift_per_axis_matches_oracle(rng, rounding):
    mults = np.array([0.003, 0.77, 1.25, 0.5, 0.031, 2.5, 0.124, 0.9999])
    ms, ss = zip(*(fixed_point_multiplier_shift(float(v)) for v in mults))
    xs = _values(rng, 512)[: 8 * 128].reshape(128, 8)
    want = j_qms_axis(xs, np.array(ms), np.array(ss), 1, rounding)
    got = q_multiply_shift_per_axis(torch.from_numpy(xs), ms, ss, 1, rounding).numpy()
    np.testing.assert_array_equal(got, want)


_int32 = st.integers(-(2**31), 2**31 - 1)


@settings(max_examples=300, deadline=None)
@given(xs=st.lists(_int32, min_size=1, max_size=16),
       m=st.integers(0, 2**31 - 1), shift=st.integers(-31, 8),
       rounding=st.sampled_from(ROUNDINGS))
def test_q_multiply_shift_hypothesis(xs, m, shift, rounding):
    """Every (value, multiplier, shift, rounding), including products that
    wrap around int64 (left shifts up to 8 of a full int32 times a full
    multiplier)."""
    x = np.array(xs, np.int32)
    want = j_qms(x, m, shift, rounding)
    np.testing.assert_array_equal(q_multiply_shift(torch.from_numpy(x), m, shift, rounding).numpy(),
                                  want)
    np.testing.assert_array_equal(q_multiply_shift_np(x, m, shift, rounding), want)


@settings(max_examples=100, deadline=None)
@given(xs=st.lists(_int32, min_size=4, max_size=4),
       ms=st.lists(st.integers(0, 2**31 - 1), min_size=4, max_size=4),
       shifts=st.lists(st.integers(-31, 8), min_size=4, max_size=4),
       rounding=st.sampled_from(ROUNDINGS))
def test_q_multiply_shift_per_axis_hypothesis(xs, ms, shifts, rounding):
    x = np.array(xs * 3, np.int32).reshape(3, 4)
    want = j_qms_axis(x, np.array(ms), np.array(shifts), 1, rounding)
    got = q_multiply_shift_per_axis(torch.from_numpy(x), ms, shifts, 1, rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("izp,ozp,out_dtype", [(0, 0, "int8"), (7, -3, "int8"),
                                               (-5, 9, "int32")])
def test_requantize_matches_oracle(rng, rounding, per_channel, izp, ozp, out_dtype):
    x = rng.integers(-(2**20), 2**20, (16, 6)).astype(np.int32)
    scale = 0.001 + rng.random(6) * 0.01 if per_channel else 0.004
    want = j_requantize_np(x, scale, izp, 0.05, ozp, axis=-1, rounding=rounding,
                           out_dtype=out_dtype)
    np.testing.assert_array_equal(
        requantize_np(x, scale, izp, 0.05, ozp, rounding=rounding, out_dtype=out_dtype), want)
    got = requantize(torch.from_numpy(x), scale, izp, 0.05, ozp, rounding=rounding,
                     out_dtype=out_dtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


RES_PARAMS = [
    # (lhs scale, lhs zp, rhs scale, rhs zp, out scale, out zp, clip)
    (0.06, 2, 0.045, -1, 0.03, 3, True),
    (0.03, 3, 0.03, 3, 0.03, 3, False),       # both sides skip the requantize
    (0.03, 1, 0.05, 0, 0.03, 4, False),       # equal scale, other zp
    (0.011, 0, 0.023, 0, 0.017, 0, False),    # ResNet: every zp 0
]


def _ra(case, rounding):
    ls, lz, rs, rz, so, zo, clip = case
    ra = dict(lhs_scale=ls, lhs_zero_point=lz, rhs_scale=rs, rhs_zero_point=rz,
              output_scale=so, output_zero_point=zo, rounding=rounding)
    if clip:
        ra.update(a_min=-100, a_max=90)
    return ra


def _res_add_device_formula(v, r, plan):
    """The residual add as plan_res_add plans it (each side's
    q_multiply_shift, the sum, the clip), in numpy; K3's kernel computes the
    same as two tables (tests/test_torch_port_igemm.py)."""
    def side(x, p):
        skip, m, s, zp = p
        if skip:
            return x.astype(np.int32)
        return q_multiply_shift_np(x.astype(np.int32) - np.int32(zp), m, s,
                                   plan["rounding"]) + np.int32(plan["zo"])

    out = side(v, plan["lhs"]) + side(r, plan["rhs"]) - np.int32(plan["zo"])
    return np.clip(out, plan["lo"], plan["hi"]).astype(np.int8)


@pytest.mark.parametrize("case", RES_PARAMS)
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_residual_add_matches_reference(rng, case, rounding):
    ra = _ra(case, rounding)
    v = rng.integers(-128, 128, (5, 7)).astype(np.int8)
    r = rng.integers(-128, 128, (5, 7)).astype(np.int8)
    want = j_res_add_np(v, r, ra)
    got = res_add_plain(torch.from_numpy(v), torch.from_numpy(r), ra).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_res_add_device_formula(v, r, plan_res_add(ra)), want)
