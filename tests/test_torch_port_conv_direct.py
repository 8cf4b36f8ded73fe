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
from tachikoma_tpu_torch.ops.kernels import conv_direct
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


@pytest.mark.parametrize("cin,k,s,cc", [(3, 3, 1, 4), (3, 7, 2, 4), (8, 3, 1, 8), (16, 3, 1, 16),
                                         (64, 3, 1, 32), (512, 3, 1, 32), (64, 7, 1, 32),
                                         (64, 11, 1, 8), (40, 3, 1, 32)])
def test_k11_chunk_fits_shared_memory(cin, k, s, cc):
    assert conv_direct.direct_chunk(cin, k, k, (s, s)) == cc
    assert conv_direct.direct_smem(cc, k, k, (s, s)) <= conv_direct.SMEM_LIMIT


@pytest.mark.parametrize("out,k,s,tile", [(112, 3, 1, (8, 56)), (56, 3, 2, (8, 28)),
                                           (7, 3, 1, (7, 7)), (14, 3, 2, (8, 14)),
                                           (300, 5, 1, (8, 75))])
def test_k12_tile_fits_its_budget(out, k, s, tile):
    assert conv_direct.dw_tile(out, out, k, k, (s, s)) == tile
    assert conv_direct.dw_smem(tile, k, k, (s, s)) <= conv_direct.DW_BUDGET


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
