"""The port's int8 kernels (tachikoma_tpu_torch/ops/kernels).

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
against the JAX package's entry of the same name, run on the CPU as the JAX
package's own tests run it (Pallas interpret mode), on the same numpy inputs.
Integers are compared with ==.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

from tachikoma_tpu.ops.pallas.conv_flat import (qconv2d_flat as j_qconv2d_flat,
                                                qconv2d_flat_block_stack as j_block_stack,
                                                qconv2d_flat_chain as j_chain)
from tachikoma_tpu.ops.pallas.matmul_int8 import qmatmul_int8 as j_qmatmul_int8
from tachikoma_tpu.ops.pallas.qms32 import plan_requantize as j_plan_requantize
from tachikoma_tpu_torch.ops.kernels import _lib
from tachikoma_tpu_torch.ops.kernels.conv import (qconv2d_flat, qconv2d_flat_block_stack,
                                                  qconv2d_flat_chain)
from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qgemm_rq, qgemm_rq_plain, qmatmul_int8
from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _rq(rng, n, per_channel, ratio=0.02):
    """(multiplier, shift) for realistic requantize ratios."""
    if per_channel:
        return plan_requantize(ratio * (0.5 + rng.random(n)), 1.0)
    return plan_requantize(ratio, 1.0)


def test_plan_requantize_matches_reference():
    scales = np.array([1e-6, 3e-4, 0.021, 0.5, 0.75, 1.5, 3.75])
    m, s = plan_requantize(scales, 0.9)
    jm, js = j_plan_requantize(scales, 0.9)
    assert (m == jm).all() and (s == js).all() and m.dtype == jm.dtype
    assert plan_requantize(0.01, 0.3) == j_plan_requantize(0.01, 0.3)


# (per-channel multipliers, rounding)
EPILOGUES = [(True, "UPWARD"), (True, "TONEAREST"), (False, "TONEAREST")]


@pytest.mark.parametrize("shape", [(7, 33, 5), (40, 64, 24), (3, 130, 17)])
@pytest.mark.parametrize("per_channel,rounding", EPILOGUES)
def test_qmatmul_plain_matches_reference(rng, shape, per_channel, rounding):
    m_, k, n = shape
    x, w = _i8(rng, (m_, k)), _i8(rng, (k, n))
    bias = rng.integers(-3000, 3000, n).astype(np.int32)
    mult, shift = _rq(rng, n, per_channel, 0.004)
    kw = dict(bias=bias, multiplier=mult, shift=shift, out_zp=-3, rounding=rounding,
              qmin=-100, qmax=110)
    want = np.asarray(j_qmatmul_int8(x, w, **kw))
    got = qmatmul_int8(torch.from_numpy(x), w, **kw).numpy()
    np.testing.assert_array_equal(got, want)


CONV_CASES = [
    # (x shape, k, stride, padding, cout, izp)
    ((2, 9, 9, 16), 3, (2, 2), (1, 1, 1, 1), 24, 3),      # strided 3x3
    ((1, 15, 15, 3), 7, (2, 2), (3, 3, 3, 3), 8, -5),     # 7x7 s2 stem, cin 3
    ((2, 7, 7, 16), 1, (2, 2), (0, 0, 0, 0), 12, 2),      # 1x1 s2 downsample
    ((1, 6, 8, 8), 3, (1, 1), (0, 1, 0, 1), 8, -2),       # asymmetric pad
]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("per_channel,rounding", EPILOGUES)
def test_qconv2d_flat_plain_matches_reference(rng, case, per_channel, rounding):
    shape, k, strides, padding, cout, izp = case
    x, w = _i8(rng, shape), _i8(rng, (k, k, shape[3], cout))
    bias = rng.integers(-2000, 2000, cout).astype(np.int32)
    mult, shift = _rq(rng, cout, per_channel, 0.003)
    kw = dict(bias=bias, multiplier=mult, shift=shift, strides=strides, padding=padding,
              input_zero_point=izp, out_zp=4, rounding=rounding, qmin=-120, qmax=127)
    want = np.asarray(j_qconv2d_flat(x, w, **kw))
    got = qconv2d_flat(torch.from_numpy(x), w, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def _stage(rng, kh, cin, cout, izp, out_zp, per_channel, rounding="UPWARD", clip=False):
    mult, shift = _rq(rng, cout, per_channel, 0.003)
    pad = kh // 2
    st = dict(w=_i8(rng, (kh, kh, cin, cout)),
              bias=rng.integers(-1000, 1000, cout).astype(np.int32),
              multiplier=mult, shift=shift, izp=izp, out_zp=out_zp, rounding=rounding,
              padding=(pad, pad, pad, pad))
    if clip:
        st.update(qmin=-90, qmax=100)
    return st


def _res_params(lzp, rzp, ozp, rounding="UPWARD", clip=False, same_rhs=False):
    rp = dict(lhs_scale=0.06, lhs_zero_point=lzp, rhs_scale=0.03 if same_rhs else 0.045,
              rhs_zero_point=rzp, output_scale=0.03, output_zero_point=ozp, rounding=rounding)
    if clip:
        rp.update(a_min=-100, a_max=100)
    return rp


@pytest.mark.parametrize("per_channel,rounding", EPILOGUES)
def test_chain_with_residual_plain_matches_reference(rng, per_channel, rounding):
    stages = [_stage(rng, 1, 16, 8, 1, 2, per_channel, rounding),
              _stage(rng, 3, 8, 8, 2, -1, per_channel, rounding, clip=True),
              _stage(rng, 1, 8, 24, -1, 3, per_channel, rounding)]
    x = _i8(rng, (2, 7, 6, 16))
    res = _i8(rng, (2, 7, 6, 24))
    rp = _res_params(3, -2, 1, rounding, clip=True)
    want = np.asarray(j_chain(x, stages, residual=res, res_params=rp, interpret=True))
    got = qconv2d_flat_chain(torch.from_numpy(x), stages, residual=torch.from_numpy(res),
                             res_params=rp).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_channel,rounding", EPILOGUES)
def test_block_stack_plain_matches_reference(rng, per_channel, rounding):
    def block(izp, zadd, same_rhs):
        sts = [_stage(rng, 1, 16, 8, izp, 1, per_channel, rounding),
               _stage(rng, 3, 8, 8, 1, -2, per_channel, rounding),
               _stage(rng, 1, 8, 16, -2, 2, per_channel, rounding)]
        return sts, _res_params(2, izp, zadd, rounding, clip=not same_rhs, same_rhs=same_rhs)

    # a plain (no residual) block between two residual ones; the first
    # block's rhs has the output's qparams (the skipped requantize)
    blocks = [block(0, 0, True),
              ([_stage(rng, 3, 16, 16, 0, 2, per_channel, rounding)], None),
              block(2, -1, False)]
    x = _i8(rng, (1, 6, 7, 16))
    want = np.asarray(j_block_stack(x, blocks, interpret=True))
    got = qconv2d_flat_block_stack(torch.from_numpy(x), blocks).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_count_no_launch_on_cpu(rng):
    """On a CPU tensor the wrappers run the plain versions: no kernel is
    built, none is launched."""
    before = dict(_lib.LAUNCHES)
    x = torch.from_numpy(_i8(rng, (4, 32)))
    w = torch.from_numpy(_i8(rng, (32, 8)))
    v = channel_vector(1 << 30, 8, "cpu")
    s = channel_vector(-6, 8, "cpu")
    b = torch.zeros(8, dtype=torch.int32)
    assert torch.equal(qgemm_rq(x, w, b, v, s), qgemm_rq_plain(x, w, b, v, s))
    assert dict(_lib.LAUNCHES) == before


def test_parameter_layout_matches_params_cuh():
    """`_lib.PARAMS` names the int32 parameter array in the order of
    csrc/params.cuh's enum Param, which every C entry indexes; a name out of
    place hands a kernel another kernel's value."""
    import re

    text = (_lib.CSRC / "params.cuh").read_text()
    body = re.sub(r"//[^\n]*", "", text[text.index("enum Param {") + 12:text.index("P_COUNT")])
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names == ["P_" + p.upper() for p in _lib.PARAMS]
