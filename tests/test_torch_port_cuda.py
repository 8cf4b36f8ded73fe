"""The port's CUDA kernels on the card: each equals its plain PyTorch version
(==) at main-path shapes of int8 ResNet-50 (b8 fused, b1 unfused for K4) and
MobileNetV2 (K5: b8 fused, b1 unfused) and at ragged shapes, on the same
inputs; K6 (float attention) is within rtol 2e-5, atol 2e-6 of its plain
version (tests/test_flash_attention.py's tolerance); the executors and the
trace emitter on the card equal the CPU path.  K1 equals its plain version
on both paths (tiled and skinny) at every tile and split, at ResNet-50's,
MobileNetV2's and VGG-16's calls (`-k k1_`); K4's GEMM mode likewise at the
b1 trace path's calls (`-k "k4_qgemm or k4_gemm"`).  K11 and K12 (the direct conv)
equal their plain versions at tests/test_torch_port_conv_direct.py's shapes,
at 56^2 c64 3x3 s1 and at MobileNetV2 b8's depthwise shapes; tune_conv, a
fused VGG-11 forward and tune_graph run on the card (`-k "direct or vgg or
graph_tune"`).

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports neither jax nor the JAX package, so it also runs where they are not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tachikoma_tpu_torch.ir.transforms import fuse_attention
from tachikoma_tpu_torch.models.transformer import bert, gpt2, vit
from tachikoma_tpu_torch.models.vision import lenet5, mobilenet_v2, resnet
from tachikoma_tpu_torch.ops.kernels import _lib
from tachikoma_tpu_torch.ops.kernels.conv import (qconv2d_flat, qconv_raw, qconv_raw_plain,
                                                  qconv_rq, qconv_rq_plain, qconv_rq_res,
                                                  qconv_rq_res_plain)
from tachikoma_tpu_torch.ops.kernels.depthwise import (qdwconv_raw, qdwconv_raw_plain,
                                                       qdwconv_rq, qdwconv_rq_plain)
from tachikoma_tpu_torch.ops.kernels import flash_attention as fa_mod
from tachikoma_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain
from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qgemm_raw, qgemm_raw_plain, qgemm_rq,
                                                         qgemm_rq_plain)
from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace.emitter import TraceEmitter
from tachikoma_tpu_torch.trace.format import TraceReader


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _rq(rng, n, per_channel, ratio):
    if per_channel:
        return plan_requantize(ratio * (0.5 + rng.random(n)), 1.0)
    return plan_requantize(ratio, 1.0)


def _res_params(lzp, rzp, ozp, rounding):
    return dict(lhs_scale=0.06, lhs_zero_point=lzp, rhs_scale=0.045, rhs_zero_point=rzp,
                output_scale=0.03, output_zero_point=ozp, rounding=rounding,
                a_min=-100, a_max=100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with -m cuda on the card")
    return torch.device("cuda")


def _dev(rng, shape, device):
    return torch.from_numpy(_i8(rng, shape)).to(device)


def _epilogue_args(rng, n, device, per_channel=True):
    mult, shift = _rq(rng, n, per_channel, 0.002)
    return (torch.from_numpy(rng.integers(-5000, 5000, n).astype(np.int32)).to(device),
            channel_vector(mult, n, device), channel_vector(shift, n, device))


# K1's calls: ResNet-50 b8 1x1 convs and classifier, VGG-16 b8's fc6, a b1
# classifier, MobileNetV2's K = 24 expand conv (8-byte copies), a ragged one
K1_CASES = [(25088, 64, 256), (1568, 1024, 256), (8, 2048, 1000), (37, 80, 13),
            (8, 25088, 4096), (1, 2048, 1000), (392, 2048, 512), (6272, 512, 128),
            (25088, 24, 144)]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", K1_CASES)
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
def test_k1_qgemm_rq_on_card(rng, cuda, mkn, rounding):
    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b, mult, shift = _epilogue_args(rng, n, cuda)
    kw = dict(rq_izp=3, out_zp=-2, rounding=rounding, qmin=-128, qmax=120)
    got = qgemm_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qgemm_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((8, 224, 224, 3), 7, 2, 3, 64, 0),      # stem
    ((8, 56, 56, 128), 3, 2, 1, 128, 0),     # strided 3x3
    ((8, 28, 28, 256), 3, 2, 1, 256, 5),
    ((8, 14, 14, 512), 3, 2, 1, 512, -7),
    ((2, 13, 11, 24), 3, 1, 1, 10, 4),       # ragged everything
])
def test_k2_qconv_rq_on_card(rng, cuda, case):
    shape, k, s, p, cout, izp = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=(p, p, p, p), izp=izp, out_zp=1)
    got = qconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((8, 56, 56, 64), 1, 256), ((8, 28, 28, 128), 1, 512),
    ((8, 14, 14, 256), 1, 1024), ((8, 7, 7, 512), 1, 2048),
    ((2, 9, 9, 32), 3, 32),                  # a 3x3 last stage
])
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
def test_k3_qconv_rq_res_on_card(rng, cuda, case, rounding):
    shape, k, cout = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    res = _dev(rng, shape[:3] + (cout,), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    rp = _res_params(2, -1, 3, rounding)
    p = k // 2
    kw = dict(padding=(p, p, p, p), izp=1, out_zp=2, rounding=rounding)
    got = qconv_rq_res(x, w, b, mult, shift, res, rp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_res_plain(x, w, b, mult, shift, res, rp, **kw))


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(rng, cuda):
    x, w = _dev(rng, (16, 32), cuda), _dev(rng, (32, 8), cuda)
    b, mult, shift = _epilogue_args(rng, 8, cuda)
    with pytest.raises(TypeError):
        qgemm_rq(x.to(torch.int32), w, b, mult, shift)
    with pytest.raises(ValueError):
        qgemm_rq(x, w.t().contiguous().t(), b, mult, shift)
    with pytest.raises(ValueError):
        qgemm_rq(x, w.cpu(), b, mult, shift)


# K4's GEMM calls: ResNet-50 b1's 56^2, 28^2 and 14^2 1x1 convs (the tiled
# path, split where its tiles leave the card idle), its 7^2 ones (M = 49) and
# the b1 classifiers (M = 1) on the skinny path, MobileNetV2's K = 24 (8-byte
# copies), K % 8 != 0 (byte copies), ragged M and N
K4_GEMM_CASES = [(37, 80, 128), (37, 200, 13), (70, 300, 256), (3136, 64, 256),
                 (196, 1024, 256), (1, 2048, 1000), (49, 512, 2048), (49, 2048, 512),
                 (784, 512, 128), (3136, 24, 144), (1, 1280, 1000), (100, 100, 40),
                 (12544, 16, 96), (196, 1024, 512)]


def _extreme_bias(rng, n, device):
    return torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, n, dtype=np.int64)
                            .astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", K4_GEMM_CASES)
def test_k4_qgemm_raw_on_card(rng, cuda, mkn):
    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b = _extreme_bias(rng, n, cuda)
    got = qgemm_raw(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, qgemm_raw_plain(x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(bm, bn, 64) for bm, bn in _lib.TILES])
@pytest.mark.parametrize("mkn", K4_GEMM_CASES)
def test_k4_gemm_tiles_on_card(rng, cuda, blocks, mkn):
    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b = _extreme_bias(rng, n, cuda)
    got = qgemm_raw(x, w, b, blocks=blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, qgemm_raw_plain(x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", K4_GEMM_CASES)
def test_k4_gemm_every_plan_on_card(rng, cuda, mkn):
    """Every launch K4's GEMM mode can make of the call (`gemm_plans`: the
    tiled path at each tile, unsplit and at `rq_split`'s split; at M <= 64
    the skinny path at several splits) and the tiled path at
    every split of K from 1 to 8, each == plain: the splits add into the
    zeroed output and split 0 alone adds the bias."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import gemm_plans

    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b = _extreme_bias(rng, n, cuda)
    want = qgemm_raw_plain(x, w, b)
    steps = -(-k // 64)
    plans = gemm_plans(m, k, n)
    for ks in range(1, min(8, steps) + 1):
        kper = -(-steps // ks)
        plans.append({"path": "tiled", "bm": 64, "bn": 64, "ks": -(-steps // kper), "kper": kper})
    for plan in plans:
        got = qgemm_raw(x, w, b, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


@pytest.mark.cuda
def test_k4_gemm_refuses_what_it_does_not_take(rng, cuda):
    """The skinny path refuses M > 64, a split that leaves a step out is
    refused, a tile that is not built raises in the wrapper and in the
    kernel's entry; an unaligned x (an odd offset) takes the byte copies on
    both paths and stays == plain."""
    x, w = _dev(rng, (80, 128), cuda), _dev(rng, (128, 32), cuda)
    b = _extreme_bias(rng, 32, cuda)
    with pytest.raises(ValueError, match="skinny path takes M"):
        qgemm_raw(x, w, b, plan={"path": "skinny", "ks": 1, "kper": 2})
    with pytest.raises(ValueError, match="does not cover"):
        qgemm_raw(x[:8], w, b, plan={"path": "skinny", "ks": 1, "kper": 1})
    with pytest.raises(ValueError, match="does not cover"):
        qgemm_raw(x, w, b, plan={"path": "tiled", "bm": 64, "bn": 64, "ks": 3, "kper": 1})
    with pytest.raises(ValueError, match="not a compiled tile"):
        qgemm_raw(x, w, b, blocks=(32, 64, 64))
    with pytest.raises(RuntimeError, match="tk_qgemm_raw"):
        qgemm_raw(x, w, b, plan={"path": "tiled", "bm": 32, "bn": 64, "ks": 1, "kper": 2})
    buf = _dev(rng, (80 * 136 + 1,), cuda)
    xu = buf[1:].view(80, 136)
    wu = _dev(rng, (136, 32), cuda)
    for m in (8, 80):  # the skinny path, the tiled one
        got = qgemm_raw(xu[:m], wu, b)
        torch.cuda.synchronize()
        assert torch.equal(got, qgemm_raw_plain(xu[:m], wu, b))


@pytest.mark.cuda
def test_k4_gemm_through_qconv2d_flat_and_qmatmul_int8(rng, cuda):
    """A raw 1x1 conv (stride 2, izp folded into the bias) launches K4's GEMM
    mode once a call and packs its 4-D weight once across calls; the entry
    `qmatmul_int8` without a multiplier serves a tile and the library route
    (`blocks="xla"`), each == the CPU path."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm

    x = _dev(rng, (1, 14, 14, 1024), cuda)
    w = _dev(rng, (1, 1, 1024, 512), cuda)
    b = _extreme_bias(rng, 512, cuda)
    kw = dict(strides=(2, 2), input_zero_point=-3)
    want = qconv2d_flat(x.cpu(), w.cpu(), b.cpu(), **kw)
    before = _lib.LAUNCHES["qgemm_raw"]
    got = qconv2d_flat(x, w, b, **kw)
    packed = len(mm._KMAJOR)
    again = qconv2d_flat(x, w, b, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qgemm_raw"] == before + 2 and len(mm._KMAJOR) == packed
    assert torch.equal(got.cpu(), want) and torch.equal(again.cpu(), want)
    x2, w2 = _dev(rng, (49, 512), cuda), _dev(rng, (512, 256), cuda)
    b2 = _extreme_bias(rng, 256, cuda)
    want = mm.qmatmul_int8(x2.cpu(), w2.cpu(), b2.cpu())
    for blocks in ((128, 128, 64), "xla", None):
        got = mm.qmatmul_int8(x2, w2, b2, blocks=blocks)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), blocks


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 9, 9, 16), 3, 1, (1, 1, 1, 1), 24, 3),
    ((2, 9, 9, 16), 3, 2, (1, 1, 1, 1), 24, -4),
    ((1, 15, 15, 3), 7, 2, (3, 3, 3, 3), 8, -5),        # stem, cin 3, izp != 0
    ((1, 6, 8, 8), 3, 1, (0, 1, 0, 1), 8, -2),
    ((1, 224, 224, 3), 7, 2, (3, 3, 3, 3), 64, 7),      # the b1 224^2 stem
    ((1, 56, 56, 128), 3, 2, (1, 1, 1, 1), 128, 0),
    ((1, 7, 7, 512), 3, 1, (1, 1, 1, 1), 512, -3),
])
def test_k4_qconv_raw_on_card(rng, cuda, case):
    shape, k, s, p, cout, izp = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b = torch.from_numpy(rng.integers(-5000, 5000, cout).astype(np.int32)).to(cuda)
    kw = dict(strides=(s, s), padding=p, izp=izp)
    got = qconv_raw(x, w, b, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, qconv_raw_plain(x, w, b, **kw))


DW_CASES = [
    # (x shape, k, stride, padding (t, l, b, r), izp)
    ((8, 112, 112, 32), 3, 1, (1, 1, 1, 1), 0),        # MobileNetV2 b8 224^2
    ((8, 112, 112, 96), 3, 2, (1, 1, 1, 1), 0),
    ((8, 56, 56, 144), 3, 2, (1, 1, 1, 1), 0),
    ((8, 14, 14, 576), 3, 2, (1, 1, 1, 1), 0),
    ((8, 7, 7, 960), 3, 1, (1, 1, 1, 1), 0),
    ((1, 28, 28, 192), 3, 1, (1, 1, 1, 1), 5),          # b1
    ((2, 9, 9, 13), 5, 2, (2, 2, 2, 2), -5),            # C % 4 != 0
    ((2, 8, 7, 24), 3, 1, (0, 1, 2, 0), 7),             # asymmetric pad
    ((1, 10, 10, 300), 7, 3, (3, 3, 3, 3), -128),       # 3 channel tiles
    # the other MobileNetV2 b8 shapes (17 calls, 10 shapes in all)
    ((8, 56, 56, 144), 3, 1, (1, 1, 1, 1), 0),
    ((8, 28, 28, 192), 3, 1, (1, 1, 1, 1), 0),
    ((8, 28, 28, 192), 3, 2, (1, 1, 1, 1), 0),
    ((8, 14, 14, 384), 3, 1, (1, 1, 1, 1), 0),
    ((8, 14, 14, 576), 3, 1, (1, 1, 1, 1), 0),
    # stride 2 with asymmetric padding, 5x5 and 7x7 at stride 1, a 16-byte
    # channel count off the window's 16-byte copies, a tiny image
    ((2, 11, 13, 20), 3, 2, (0, 1, 1, 0), -7),
    ((1, 12, 12, 40), 3, 2, (1, 0, 1, 0), 3),
    ((2, 9, 9, 16), 5, 1, (2, 2, 2, 2), 100),
    ((1, 9, 9, 32), 7, 1, (3, 3, 3, 3), 127),
    ((3, 5, 6, 8), 3, 1, (1, 1, 1, 1), 127),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES)
@pytest.mark.parametrize("rounding,qmin,qmax", [("UPWARD", 0, 24), ("TONEAREST", -128, 127)])
def test_k5_qdwconv_rq_on_card(rng, cuda, case, rounding, qmin, qmax):
    shape, k, s, p, izp = case
    c = shape[3]
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, 1, c), cuda)
    b, mult, shift = _epilogue_args(rng, c, cuda)
    kw = dict(strides=(s, s), padding=p, izp=izp, rq_izp=-3, out_zp=2, rounding=rounding,
              qmin=qmin, qmax=qmax)
    got = qdwconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qdwconv_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES)
def test_k5_qdwconv_raw_on_card(rng, cuda, case):
    shape, k, s, p, izp = case
    c = shape[3]
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, 1, c), cuda)
    b = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, c, dtype=np.int64)
                         .astype(np.int32)).to(cuda)
    kw = dict(strides=(s, s), padding=p, izp=izp)
    got = qdwconv_raw(x, w, b, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, qdwconv_raw_plain(x, w, b, **kw))


@pytest.mark.cuda
def test_k5_on_a_misaligned_view_and_through_qconv2d_flat(rng, cuda):
    """An input whose address is not 4-byte aligned takes the byte path; a
    strided view goes through qconv2d_flat's contiguous copy; each
    qconv2d_flat call with groups == C launches K5 once."""
    flat = _dev(rng, (1 + 2 * 9 * 9 * 16,), cuda)
    x = flat[1:].view(2, 9, 9, 16)
    assert x.data_ptr() % 4
    w = _dev(rng, (3, 3, 1, 16), cuda)
    b, mult, shift = _epilogue_args(rng, 16, cuda)
    kw = dict(strides=(2, 2), padding=(1, 1, 1, 1), izp=3)
    assert torch.equal(qdwconv_rq(x, w, b, mult, shift, **kw),
                       qdwconv_rq_plain(x, w, b, mult, shift, **kw))
    view = _dev(rng, (2, 9, 18, 16), cuda)[:, :, ::2]
    before = dict(_lib.LAUNCHES)
    got_rq = qconv2d_flat(view, w, b, mult.cpu().numpy(), shift.cpu().numpy(), strides=(2, 2),
                          padding=(1, 1, 1, 1), groups=16, input_zero_point=3)
    got_raw = qconv2d_flat(view, w, b, strides=(2, 2), padding=(1, 1, 1, 1), groups=16,
                           input_zero_point=3)
    assert _lib.LAUNCHES["qdwconv_rq"] == before.get("qdwconv_rq", 0) + 1
    assert _lib.LAUNCHES["qdwconv_raw"] == before.get("qdwconv_raw", 0) + 1
    vc = view.contiguous()
    assert torch.equal(got_rq, qdwconv_rq_plain(vc, w, b, mult, shift, **kw))
    assert torch.equal(got_raw, qdwconv_raw_plain(vc, w, b, **kw))


@pytest.mark.cuda
def test_a_second_library_copy_launches_above_48kb(rng, cuda, tmp_path, monkeypatch):
    """A second copy of K2's library, loaded under another file name into
    this process, raises its own kernels' shared-memory limit: the
    launchers' once-per-kernel statics are local to each library
    (-fno-gnu-unique), not one GNU-unique copy that the first library set.
    K2 takes more than 48 KB of dynamic shared memory; it launches from
    the port's library, then from the copy, then from the port's again,
    == plain each time."""
    import ctypes
    import shutil

    shape, k, s, p, cout = (8, 56, 56, 64), 3, 1, 1, 64
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=(p,) * 4)
    want = qconv_rq_plain(x, w, b, mult, shift, **kw)
    assert torch.equal(qconv_rq(x, w, b, mult, shift, **kw), want)
    src = "qconv_igemm_hopper.cu"
    copy = tmp_path / f"second-{_lib._library(src).name}"
    shutil.copy(_lib._library(src), copy)
    second = ctypes.CDLL(str(copy))
    for fn_name, n_ptr in _lib.SOURCES[src]:
        fn = getattr(second, fn_name)
        fn.argtypes = [ctypes.c_void_p] * (n_ptr + 2)
        fn.restype = ctypes.c_int
        assert fn is not _lib._entries[fn_name]
        monkeypatch.setitem(_lib._entries, fn_name, fn)
    got = qconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    monkeypatch.undo()
    assert torch.equal(qconv_rq(x, w, b, mult, shift, **kw), want)


@pytest.mark.cuda
def test_no_library_has_a_gnu_unique_symbol(cuda):
    """nm -D of every built library shows no STB_GNU_UNIQUE ('u') symbol."""
    import subprocess

    _lib.build()
    libs = sorted(_lib.BUILD_DIR.glob("*.so"))
    assert len(libs) >= len(_lib.SOURCES)
    for lib in libs:
        syms = subprocess.run(["nm", "-D", str(lib)], capture_output=True, text=True,
                              check=True).stdout.splitlines()
        assert not [ln for ln in syms if ln.split()[-2:-1] == ["u"]], lib.name


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [True, False])
def test_mobilenet_executor_on_card_equals_cpu(cuda, fuse):
    rng = np.random.default_rng(4)
    calib = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    q = quantize(mobilenet_v2(batch_size=2, image_size=32), [calib])
    names = computational_nodes(fuse_qnn(q) if fuse else q)
    got = TorchExecutor(q, capture=names, device="cuda", fuse=fuse).run(x)
    want = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            assert (a == b).all(), name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.fixture
def r18_unfused():
    rng = np.random.default_rng(5)
    calib = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    return quantize(resnet(18, batch_size=1, image_size=32), [calib]), x


@pytest.mark.cuda
def test_unfused_executor_on_card_equals_cpu(cuda, r18_unfused):
    q, x = r18_unfused
    names = computational_nodes(q)
    got = TorchExecutor(q, capture=names, device="cuda", fuse=False).run(x)
    want = TorchExecutor(q, capture=names, device="cpu", fuse=False).run(x)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            assert (a == b).all(), name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.cuda
def test_packed_fetch_and_trace_on_card_equal_the_cpu(cuda, r18_unfused, tmp_path):
    q, x = r18_unfused
    em = TraceEmitter(q, device="cuda")
    outs = em._executor.run_device(x)
    values = em._fetch_packed(outs)
    for name, o in zip(computational_nodes(q), outs):
        want = o.cpu().numpy()
        assert values[name].dtype == want.dtype and values[name].shape == want.shape
        assert (values[name] == want).all(), name
    em.emit_to(x, tmp_path / "card.bin")
    cpu = TraceEmitter(q, device="cpu").emit_bytes(x)
    card = TraceReader(io.BytesIO((tmp_path / "card.bin").read_bytes()))
    for a, b in zip(card, TraceReader(io.BytesIO(cpu))):
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), a.name
        else:
            np.testing.assert_allclose(a.output.to_array(), b.output.to_array(),
                                       rtol=1e-5, atol=1e-6)
    assert len(card) == 93


FA_RTOL, FA_ATOL = 2e-5, 2e-6
FA_CASES = [
    # (B, H, S, D, causal)
    (2, 2, 128, 64, False),        # tests/test_flash_attention.py's four shapes
    (1, 3, 256, 64, True),
    (2, 2, 200, 128, False),
    (1, 2, 130, 64, True),
    (2, 3, 1, 64, False),          # S on either side of one 64-key tile
    (2, 3, 1, 64, True),
    (1, 2, 65, 64, False),
    (1, 2, 65, 64, True),
    (1, 4, 96, 32, False),         # D = 32, 64, 128 and ragged D
    (1, 4, 96, 32, True),
    (1, 2, 70, 40, True),
    (1, 2, 33, 100, False),
    (2, 2, 77, 128, True),         # causal, S not a multiple of the tile
    (4, 12, 128, 64, False),       # BERT-base b4 s128
    (1, 12, 128, 64, True),        # GPT-2 small b1 s128
    (8, 12, 197, 64, False),       # ViT-B/16 b8 224^2
    # D above 128 (the output columns split across blocks; 320 reads Q and K
    # from global memory), S ragged
    *((2, 3, s, d, causal) for d in (32, 80, 160, 256, 320) for s in (130, 197)
      for causal in (False, True)),
]


def _f32(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES)
def test_k6_flash_attn_on_card(rng, cuda, case):
    b, h, s, d, causal = case
    q, k, v = (_f32(rng, (b, h, s, d), cuda) for _ in range(3))
    before = _lib.LAUNCHES["flash_attn"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["flash_attn"] == before + 1  # a CUDA tensor launched K6
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=FA_RTOL, atol=FA_ATOL)


@pytest.mark.cuda
def test_k6_on_permuted_views_and_scale(rng, cuda):
    """The graph hands K6 head-split transposes, (B, S, H, D) viewed as
    (B, H, S, D); K6 reads them in place through their strides (the wrapper
    copies none) and the result is the same."""
    q, k, v = (_f32(rng, (2, 50, 3, 64), cuda).permute(0, 2, 1, 3) for _ in range(3))
    assert not q.is_contiguous()
    copies = fa_mod.COPIES["flash_attn"]
    got = flash_attention(q, k, v, scale=0.3, causal=True)
    torch.cuda.synchronize()
    assert fa_mod.COPIES["flash_attn"] == copies
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), scale=0.3,
                                 causal=True)
    torch.testing.assert_close(got, want, rtol=FA_RTOL, atol=FA_ATOL)


@pytest.mark.cuda
def test_k6_refuses_what_it_does_not_take(rng, cuda):
    """D above 128 is taken now (no refusal); a wrong dtype or shape is
    refused."""
    q = _f32(rng, (1, 2, 8, 129), cuda)
    torch.testing.assert_close(flash_attention(q, q, q), flash_attention_plain(q, q, q),
                               rtol=FA_RTOL, atol=FA_ATOL)
    q = _f32(rng, (1, 2, 8, 64), cuda)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :4], q)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 160])
def test_k6_reads_head_split_views_in_place(rng, cuda, d):
    """q, k and v as the graph's head split hands them over, three
    (B, S, H, D) tensors (k and v slices of one (B, S, 2, H, D) projection)
    viewed as (B, H, S, D): K6 launches once, the wrapper copies none of
    them, and the result is within tolerance of the plain version; a view
    whose last dimension is strided is copied, and counted."""
    b, s, h = 2, 70, 3
    q = _f32(rng, (b, s, h, d), cuda).permute(0, 2, 1, 3)
    kv = _f32(rng, (b, s, 2, h, d), cuda)
    k, v = kv[:, :, 0].permute(0, 2, 1, 3), kv[:, :, 1].permute(0, 2, 1, 3)
    assert not any(t.is_contiguous() for t in (q, k, v))
    copies, launches = fa_mod.COPIES["flash_attn"], _lib.LAUNCHES["flash_attn"]
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_mod.COPIES["flash_attn"] == copies
    assert _lib.LAUNCHES["flash_attn"] == launches + 1
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=FA_RTOL, atol=FA_ATOL)
    strided = _f32(rng, (b, h, s, 2 * d), cuda)[..., ::2]
    got = flash_attention(strided, k, v)
    torch.cuda.synchronize()
    assert fa_mod.COPIES["flash_attn"] == copies + 1
    torch.testing.assert_close(got, flash_attention_plain(strided.contiguous(), k, v),
                               rtol=FA_RTOL, atol=FA_ATOL)


def _small_transformer(name):
    if name == "bert":
        return bert(batch_size=2, seq_len=32, hidden=64, layers=2, heads=4, ffn_dim=128,
                    vocab=100, seed=0), np.random.default_rng(1).integers(0, 100, (2, 32))
    if name == "gpt2":
        return gpt2(batch_size=1, seq_len=40, hidden=64, layers=2, heads=4, ffn_dim=128,
                    vocab=80, seed=1), np.random.default_rng(2).integers(0, 80, (1, 40))
    return vit(batch_size=2, image_size=32, patch=8, hidden=64, layers=2, heads=4, ffn_dim=128,
               num_classes=10, seed=2), \
        np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "gpt2", "vit"])
def test_fused_transformer_on_card_equals_cpu(cuda, name):
    torch.backends.cudnn.allow_tf32 = False
    g, x = _small_transformer(name)
    fused = fuse_attention(g)
    names = computational_nodes(fused)
    before = _lib.LAUNCHES["flash_attn"]
    got = TorchExecutor(fused, capture=names, device="cuda").run(x)
    assert _lib.LAUNCHES["flash_attn"] == before + 2
    want = TorchExecutor(fused, capture=names, device="cpu").run(x)
    for nm, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, nm
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=nm)


# ---------------------------------------------------------------------------
# the tuning path: K1-K3 at every compiled tile, the layouts K7-K10, the tuner
# ---------------------------------------------------------------------------

TILE_BLOCKS = [(bm, bn, 64) for bm, bn in _lib.TILES]
LAYOUT_CASES = [
    # (x shape, k, stride, padding (t, l, b, r), cout, izp)
    ((2, 13, 11, 3), 7, 2, (3, 3, 3, 3), 10, 4),       # stem-like, CIN 3, ragged COUT
    ((2, 9, 9, 40), 3, 1, (1, 1, 1, 1), 13, -5),       # CIN 40, COUT 13
    ((2, 14, 14, 128), 3, 2, (1, 0, 1, 2), 128, 0),    # asymmetric padding
    ((8, 56, 56, 128), 3, 2, (1, 1, 1, 1), 128, 0),    # ResNet-50 b8's three 3x3 s2
    ((8, 28, 28, 256), 3, 2, (1, 1, 1, 1), 256, 3),
    ((8, 14, 14, 512), 3, 2, (1, 1, 1, 1), 512, -7),
    ((8, 56, 56, 64), 3, 1, (1, 1, 1, 1), 64, 0),      # a chain stage
    ((1, 56, 56, 128), 3, 2, (1, 1, 1, 1), 128, 0),    # the three 3x3 s2 at b1
    ((1, 28, 28, 256), 3, 2, (1, 1, 1, 1), 256, 0),
    ((1, 14, 14, 512), 3, 2, (1, 1, 1, 1), 512, 0),
    ((1, 224, 224, 3), 7, 2, (3, 3, 3, 3), 64, 5),     # ResNet-50's stem, izp != 0
    ((1, 28, 28, 256), 3, 2, (1, 1, 1, 1), 256, -9),   # izp != 0 at the borders
]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["t", "s", "w", "r"])
@pytest.mark.parametrize("case", LAYOUT_CASES)
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
def test_layout_kernels_on_card(rng, cuda, layout, case, blocks):
    from tachikoma_tpu_torch.ops.kernels import conv_layouts

    shape, k, s, p, cout, izp = case
    if not conv_layouts.layout_fits(layout, blocks, shape, (k, k, shape[3], cout), (s, s), p):
        pytest.skip(f"layout {layout} at {blocks} does not fit shared memory for {shape}")
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=p, izp=izp, rq_izp=2, out_zp=-1, rounding="TONEAREST")
    fn = getattr(conv_layouts, f"qconv_rq_{layout}")
    plain = getattr(conv_layouts, f"qconv_rq_{layout}_plain")
    n0 = _lib.LAUNCHES[f"qconv_rq_{layout}"]
    got = fn(x, w, b, mult, shift, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[f"qconv_rq_{layout}"] == n0 + 1
    assert torch.equal(got, plain(x, w, b, mult, shift, **kw))
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["t", "s", "w", "r"])
def test_layouts_read_nhwc_and_repack_after_a_write(rng, cuda, layout, monkeypatch):
    """K7-K10 build no flat frame on the card (the polyphase relabeling is in
    the kernel); their packed weights are made once per weight tensor and
    again after an in-place write."""
    from tachikoma_tpu_torch.ops.kernels import conv_layouts

    def refuse(*a, **k):
        raise AssertionError("the flat frame was built on the card")

    shape, k, s, p, cout, izp = LAYOUT_CASES[4]
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=p, izp=izp)
    want = qconv_rq_plain(x, w, b, mult, shift, **kw)
    fn = getattr(conv_layouts, f"qconv_rq_{layout}")
    for name in ("flat_operands", "phase_image", "phase_weights", "_unflat"):
        monkeypatch.setattr(conv_layouts, name, refuse)
    assert torch.equal(fn(x, w, b, mult, shift, **kw), want)
    packed = conv_layouts.packed_weights(w)
    assert torch.equal(fn(x, w, b, mult, shift, **kw), want)
    assert conv_layouts.packed_weights(w) is packed
    w.neg_()
    assert conv_layouts.packed_weights(w) is not packed
    assert torch.equal(fn(x, w, b, mult, shift, **kw), qconv_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["s", "r"])
@pytest.mark.parametrize("kernel", [(2, 1), (1, 2)])
@pytest.mark.parametrize("blocks", [(64, 64, 64), (128, 128, 64)])
def test_wgmma_descriptor_at_an_odd_row_shift(rng, cuda, layout, kernel, blocks):
    """The descriptor probe of K8 and K10: one chunk (CIN 32, one K step), two
    taps, the weights of tap (0, 0) zero, so the whole sum comes from the
    other tap's descriptor at a row shift that is odd and not a multiple of
    8 (WPH = 13 for the 2x1 kernel, 1 for the 1x2), 16-byte but not 128-byte
    aligned; BM 128 adds the second warpgroup's 64 rows."""
    from tachikoma_tpu_torch.ops.kernels import conv_layouts

    kh, kw_ = kernel
    shape, cout = (2, 14, 13, 32), 64
    x = _dev(rng, shape, cuda)
    w = _dev(rng, (kh, kw_, 32, cout), cuda)
    w[0, 0] = 0
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(padding=(0, 0, kh - 1, kw_ - 1), izp=-3)
    g = conv_layouts.flat_geometry(shape, w.shape, (1, 1), kw["padding"])
    assert g.offs[1] in (13, 1) and g.offs[1] % 2 == 1 and g.cin_s == 32
    fn = getattr(conv_layouts, f"qconv_rq_{layout}")
    got = fn(x, w, b, mult, shift, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, getattr(conv_layouts, f"qconv_rq_{layout}_plain")(
        x, w, b, mult, shift, **kw))
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
@pytest.mark.parametrize("mkn", K1_CASES)
def test_k1_tiles_on_card(rng, cuda, blocks, mkn):
    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b, mult, shift = _epilogue_args(rng, n, cuda)
    got = qgemm_rq(x, w, b, mult, shift, out_zp=3, blocks=blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, qgemm_rq_plain(x, w, b, mult, shift, out_zp=3))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", K1_CASES)
def test_k1_every_plan_on_card(rng, cuda, mkn):
    """Every launch K1 can make of the call (`gemm_plans`: the tiled path at
    each tile, split and unsplit; at M <= 64 the skinny path at several
    splits), each == plain, with the 8-byte and byte copies of x."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import gemm_plans

    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b, mult, shift = _epilogue_args(rng, n, cuda)
    kw = dict(rq_izp=-2, out_zp=1, rounding="TONEAREST")
    want = qgemm_rq_plain(x, w, b, mult, shift, **kw)
    for plan in gemm_plans(m, k, n):
        got = qgemm_rq(x, w, b, mult, shift, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(rng, cuda):
    """The skinny path refuses M > 64 and a split that leaves a step out;
    an unaligned x (an odd offset) takes the byte copies and stays == plain."""
    x, w = _dev(rng, (80, 128), cuda), _dev(rng, (128, 32), cuda)
    b, mult, shift = _epilogue_args(rng, 32, cuda)
    with pytest.raises(ValueError, match="skinny path takes M"):
        qgemm_rq(x, w, b, mult, shift, plan={"path": "skinny", "ks": 1, "kper": 2})
    with pytest.raises(ValueError, match="does not cover"):
        qgemm_rq(x[:8], w, b, mult, shift, plan={"path": "skinny", "ks": 1, "kper": 1})
    buf = _dev(rng, (80 * 136 + 1,), cuda)
    xu = buf[1:].view(80, 136)
    wu = _dev(rng, (136, 32), cuda)
    for m in (8, 80):  # the skinny path, the tiled one
        got = qgemm_rq(xu[:m], wu, b, mult, shift)
        torch.cuda.synchronize()
        assert torch.equal(got, qgemm_rq_plain(xu[:m], wu, b, mult, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
@pytest.mark.parametrize("case", [LAYOUT_CASES[0], LAYOUT_CASES[1], LAYOUT_CASES[3]])
def test_k2_tiles_on_card(rng, cuda, blocks, case):
    shape, k, s, p, cout, izp = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=p, izp=izp, out_zp=1)
    got = qconv_rq(x, w, b, mult, shift, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
@pytest.mark.parametrize("case", [((8, 56, 56, 64), 1, 256), ((2, 9, 9, 40), 3, 40)])
def test_k3_tiles_on_card(rng, cuda, blocks, case):
    shape, k, cout = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    res = _dev(rng, shape[:3] + (cout,), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    rp = _res_params(2, -1, 3, "UPWARD")
    kw = dict(padding=(k // 2,) * 4, izp=1, out_zp=2)
    got = qconv_rq_res(x, w, b, mult, shift, res, rp, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_res_plain(x, w, b, mult, shift, res, rp, **kw))


def _skip_res_params(l_skip, r_skip, rounding):
    """Residual-add attrs whose lhs / rhs side is skipped (the output's
    qparams) or requantized."""
    return dict(lhs_scale=0.03 if l_skip else 0.06, lhs_zero_point=3 if l_skip else 2,
                rhs_scale=0.03 if r_skip else 0.045, rhs_zero_point=3 if r_skip else -1,
                output_scale=0.03, output_zero_point=3, rounding=rounding, a_min=-100,
                a_max=100)


K3_R50_CASES = [((8, 56, 56, 64), 1, 256), ((8, 28, 28, 128), 1, 512),
                ((8, 14, 14, 256), 1, 1024), ((8, 7, 7, 512), 1, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_R50_CASES)
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("l_skip,r_skip", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_k3_hopper_at_resnet50_shapes(rng, cuda, case, blocks, rounding, l_skip, r_skip):
    """K3 at ResNet-50 b8's four residual-stage shapes, every tile, both
    roundings, each side of the add skipped or not, izp != 0."""
    shape, k, cout = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    res = _dev(rng, shape[:3] + (cout,), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    rp = _skip_res_params(l_skip, r_skip, rounding)
    kw = dict(izp=-3, rq_izp=2, out_zp=-1, rounding=rounding, qmin=-120, qmax=127)
    got = qconv_rq_res(x, w, b, mult, shift, res, rp, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_res_plain(x, w, b, mult, shift, res, rp, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 9, 9, 24), 1, 0, 40),       # ragged CIN (byte gather) and COUT (no 16-byte rows)
    ((3, 5, 7, 40), 3, 1, 24),
    ((8, 7, 7, 512), 3, 1, 512),     # ResNet-18's last 3x3 stage
    ((2, 14, 14, 256), 3, 1, 256),
    ((1, 6, 5, 16), 5, 2, 80),       # 5x5, K not a multiple of 64
])
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
def test_k3_hopper_ragged_and_3x3(rng, cuda, case, blocks):
    shape, k, p, cout = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    res = _dev(rng, shape[:3] + (cout,), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    rp = _skip_res_params(False, False, "TONEAREST")
    kw = dict(padding=(p,) * 4, izp=5, out_zp=2, rounding="TONEAREST")
    got = qconv_rq_res(x, w, b, mult, shift, res, rp, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_res_plain(x, w, b, mult, shift, res, rp, **kw))


@pytest.mark.cuda
def test_k3_hopper_on_a_misaligned_residual(rng, cuda):
    """A residual 1 byte off 16-byte alignment takes the element-wise
    epilogue; == plain all the same."""
    shape, cout = (2, 9, 9, 64), 64
    x, w = _dev(rng, shape, cuda), _dev(rng, (1, 1, 64, cout), cuda)
    buf = _dev(rng, (2 * 9 * 9 * cout + 1,), cuda)
    res = buf[1:].view(2, 9, 9, cout)
    assert res.data_ptr() % 16 and res.is_contiguous()
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    rp = _skip_res_params(False, True, "UPWARD")
    got = qconv_rq_res(x, w, b, mult, shift, res, rp, izp=1)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_res_plain(x, w, b, mult, shift, res, rp, izp=1))


# ---------------------------------------------------------------------------
# K2 on the Hopper body: every call shape of ResNet-50 b8 and VGG-16 b8, the
# four tiles, the exact split of K before the requantize
# ---------------------------------------------------------------------------

# (x shape, k, stride, padding, cout)
K2_R50_CASES = [
    ((8, 224, 224, 3), 7, 2, 3, 64),        # the stem: byte gather, unsplit
    ((8, 56, 56, 64), 3, 1, 1, 64),
    ((8, 56, 56, 128), 3, 2, 1, 128),       # split 2 ways
    ((8, 28, 28, 128), 3, 1, 1, 128),
    ((8, 28, 28, 256), 3, 2, 1, 256),       # split 3 ways
    ((8, 14, 14, 256), 3, 1, 1, 256),
    ((8, 14, 14, 512), 3, 2, 1, 512),       # split 5 ways
    ((8, 7, 7, 512), 3, 1, 1, 512),
]
K2_VGG_CASES = [
    ((8, 224, 224, 3), 64), ((8, 224, 224, 64), 64), ((8, 112, 112, 64), 128),
    ((8, 112, 112, 128), 128), ((8, 56, 56, 128), 256), ((8, 56, 56, 256), 256),
    ((8, 28, 28, 256), 512), ((8, 28, 28, 512), 512), ((8, 14, 14, 512), 512),
]


def _k2_case(rng, cuda, shape, k, s, p, cout, rounding="UPWARD", izp=0, blocks=None):
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=(p,) * 4, izp=izp, rq_izp=-2, out_zp=1, rounding=rounding,
              qmin=-120, qmax=126)
    before = _lib.LAUNCHES["qconv_rq"]
    got = qconv_rq(x, w, b, mult, shift, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qconv_rq"] == before + 1
    want = qconv_rq_plain(x, w, b, mult, shift, **kw)
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_R50_CASES)
@pytest.mark.parametrize("rounding,izp", [("UPWARD", 0), ("TONEAREST", 7)])
def test_k2_hopper_at_resnet50_shapes(rng, cuda, case, rounding, izp):
    """K2 at ResNet-50 b8's eight distinct call shapes (17 calls), default
    tile, both roundings, izp 0 and 7."""
    _k2_case(rng, cuda, *case, rounding=rounding, izp=izp)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_VGG_CASES)
def test_k2_hopper_at_vgg16_shapes(rng, cuda, case):
    """K2 at VGG-16 b8's nine distinct conv shapes (13 calls)."""
    shape, cout = case
    _k2_case(rng, cuda, shape, 3, 1, 1, cout, izp=-3)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
@pytest.mark.parametrize("case", [K2_R50_CASES[1], K2_R50_CASES[7]])
def test_k2_hopper_tiles_at_56_and_7(rng, cuda, blocks, case):
    """Every tile at the 56^2 stage (unsplit) and the 7^2 stage (split)."""
    _k2_case(rng, cuda, *case, rounding="TONEAREST", izp=5, blocks=blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(1, 7), (2, 4), (3, 3), (4, 2), (7, 1)])
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
def test_k2_split_that_does_not_divide_k(rng, cuda, monkeypatch, split, rounding):
    """K = 3*3*48 = 432 bytes: 7 steps of 64, the last partly padding; each
    forced split (3 x 3 leaves the last split one step), izp != 0 and a bias
    near +-2^31, so that the complete sum wraps before the requantize: ==
    plain, and the split was launched with its workspace."""
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod

    monkeypatch.setattr(conv_mod, "rq_split", lambda *a, **k: split)
    shape, cout = (2, 10, 10, 48), 72
    x, w = _dev(rng, shape, cuda), _dev(rng, (3, 3, 48, cout), cuda)
    _, mult, shift = _epilogue_args(rng, cout, cuda)
    b = torch.from_numpy(np.where(np.arange(cout) % 2, 2 ** 31 - 1 - np.arange(cout),
                                  -2 ** 31 + np.arange(cout)).astype(np.int32)).to(cuda)
    kw = dict(padding=(1, 1, 1, 1), izp=3, out_zp=2, rounding=rounding)
    got = qconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))
    acc = conv_mod.conv_acc_plain(x, w, (1, 1), (1, 1, 1, 1), 3).to(torch.int64)
    full = acc + conv_mod.fold_input_zero_point(b, w, 3).to(torch.int64)
    assert ((full >= 2 ** 31) | (full < -2 ** 31)).any()  # the sums wrapped


@pytest.mark.cuda
def test_k2_refuses_a_split_that_misses_k(rng, cuda, monkeypatch):
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod

    x, w = _dev(rng, (1, 8, 8, 64), cuda), _dev(rng, (3, 3, 64, 64), cuda)
    b, mult, shift = _epilogue_args(rng, 64, cuda)
    for bad in ((2, 4), (3, 5)):  # 9 steps: 8 covered; a third split empty
        monkeypatch.setattr(conv_mod, "rq_split", lambda *a, _b=bad, **k: _b)
        with pytest.raises(RuntimeError, match="tk_qconv_rq"):
            qconv_rq(x, w, b, mult, shift, padding=(1, 1, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((2, 13, 11, 24), 3, 1, 1, 10),     # ragged CIN (byte gather) and COUT (element stores)
    ((3, 9, 7, 40), 5, 2, 2, 24),       # CIN 40, COUT 24, 5x5 s2
    ((2, 14, 14, 256), 3, 2, 1, 40),    # split, COUT not a multiple of 16
])
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
def test_k2_hopper_ragged(rng, cuda, case, blocks):
    _k2_case(rng, cuda, *case, rounding="TONEAREST", izp=-4, blocks=blocks)


@pytest.mark.cuda
def test_k2_through_qconv2d_flat_on_a_view(rng, cuda):
    """qconv2d_flat copies a non-contiguous view before K2; a 3x3 conv on it
    == the CPU path."""
    x = _dev(rng, (2, 12, 12, 64), cuda)[:, 1:11, 1:11, :]
    w = _i8(rng, (3, 3, 64, 48))
    m, s = plan_requantize(0.0004, 0.05)
    kw = dict(multiplier=m, shift=s, padding=(1, 1, 1, 1), input_zero_point=4)
    got = qconv2d_flat(x, w, **kw)
    want = qconv2d_flat(x.cpu(), w, **kw)
    assert torch.equal(got.cpu(), want)


# (x shape, k, stride, padding, cout): ResNet-50 b1 224^2's eight distinct
# conv-mode shapes and MobileNetV2 b1's stem
K4_TRACE_CASES = [
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_TRACE_CASES)
@pytest.mark.parametrize("izp", [0, -6])
def test_k4_conv_hopper_at_trace_shapes(rng, cuda, case, izp):
    shape, k, s, p, cout = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b = torch.from_numpy(rng.integers(-5000, 5000, cout).astype(np.int32)).to(cuda)
    kw = dict(strides=(s, s), padding=(p,) * 4, izp=izp)
    got = qconv_raw(x, w, b, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, qconv_raw_plain(x, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(1, 7), (3, 3), (4, 2), (7, 1)])
def test_k4_conv_split_that_does_not_divide_k(rng, cuda, monkeypatch, split):
    """K = 3*3*48 = 432 bytes: 7 steps of 64, the last partly padding; each
    forced split (3 x 3 leaves the last split one step) and a bias near
    +-2^31, so that the partial sums and the bias wrap, == plain."""
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod

    monkeypatch.setattr(conv_mod, "raw_split", lambda *a, **k: split)
    shape, cout = (2, 10, 10, 48), 72
    x, w = _dev(rng, shape, cuda), _dev(rng, (3, 3, 48, cout), cuda)
    b = torch.from_numpy(np.where(np.arange(cout) % 2, 2 ** 31 - 1 - np.arange(cout),
                                  -2 ** 31 + np.arange(cout)).astype(np.int32)).to(cuda)
    kw = dict(strides=(1, 1), padding=(1, 1, 1, 1), izp=3)
    got = qconv_raw(x, w, b, **kw)
    torch.cuda.synchronize()
    want = qconv_raw_plain(x, w, b, **kw)
    assert torch.equal(got, want)
    acc = conv_mod.conv_acc_plain(x, w, (1, 1), (1, 1, 1, 1), 3).to(torch.int64)
    full = acc + b.to(torch.int64)
    assert ((full >= 2 ** 31) | (full < -2 ** 31)).any()  # the sums wrapped


@pytest.mark.cuda
def test_k4_conv_refuses_a_split_that_misses_k(rng, cuda, monkeypatch):
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod

    x, w = _dev(rng, (1, 8, 8, 64), cuda), _dev(rng, (3, 3, 64, 64), cuda)
    b = torch.zeros(64, dtype=torch.int32, device=cuda)
    for bad in ((2, 4), (3, 5)):  # 9 steps: 8 covered; a third split empty
        monkeypatch.setattr(conv_mod, "raw_split", lambda *a, _b=bad, **k: _b)
        with pytest.raises(RuntimeError, match="tk_qconv_raw"):
            qconv_raw(x, w, b, padding=(1, 1, 1, 1))


# (x shape, k, stride, dilation, groups, cout): DeepLabV3-ResNet-50 b1 520^2's
# dilated calls (65^2 maps; layer3 d2, layer4 d2 and d4, the ASPP at 12, 24
# and 36) and ResNeXt-50 32x4d b8 224^2's grouped 3x3 calls (group widths 4,
# 8, 16 and 32, the first of stages 2-4 at stride 2)
K2_DILATED_CASES = [
    ((1, 65, 65, 256), 3, 1, 2, 1, 256),
    ((1, 65, 65, 512), 3, 1, 2, 1, 512),
    ((1, 65, 65, 512), 3, 1, 4, 1, 512),
    ((1, 65, 65, 2048), 3, 1, 12, 1, 256),
    ((1, 65, 65, 2048), 3, 1, 24, 1, 256),
    ((1, 65, 65, 2048), 3, 1, 36, 1, 256),
]
K2_GROUPED_CASES = [
    ((8, 56, 56, 128), 3, 1, 1, 32, 128),
    ((8, 56, 56, 256), 3, 2, 1, 32, 256),
    ((8, 28, 28, 256), 3, 1, 1, 32, 256),
    ((8, 28, 28, 512), 3, 2, 1, 32, 512),
    ((8, 14, 14, 512), 3, 1, 1, 32, 512),
    ((8, 14, 14, 1024), 3, 2, 1, 32, 1024),
    ((8, 7, 7, 1024), 3, 1, 1, 32, 1024),
]
# ragged geometry: groups 2 with CIN / G != COUT / G and a super-group of all
# the groups (the byte gather), groups with dilation, a 5x5 s2, groups 3
K2_GEOMETRY_RAGGED = [
    ((2, 9, 9, 12), 3, 1, 1, 2, 10),
    ((2, 11, 13, 64), 3, 1, 3, 8, 64),
    ((1, 17, 15, 96), 5, 2, 2, 4, 128),
    ((3, 10, 10, 48), 3, 2, 1, 3, 24),
    ((1, 20, 20, 32), 3, 1, 5, 1, 40),
]


def _geometry_case(rng, cuda, shape, k, s, d, g, cout, izp, blocks=None, raw=False):
    x = _dev(rng, shape, cuda)
    w = _dev(rng, (k, k, shape[3] // g, cout), cuda)
    kw = dict(strides=(s, s), padding=(d * (k // 2),) * 4, izp=izp, dilation=(d, d), groups=g)
    if raw:
        b = torch.from_numpy(rng.integers(-5000, 5000, cout).astype(np.int32)).to(cuda)
        before = _lib.LAUNCHES["qconv_raw"]
        got = qconv_raw(x, w, b, **kw)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["qconv_raw"] == before + 1
        want = qconv_raw_plain(x, w, b, **kw)
    else:
        b, mult, shift = _epilogue_args(rng, cout, cuda)
        kw.update(rq_izp=-2, out_zp=1, rounding="TONEAREST", qmin=-120, qmax=126)
        before = _lib.LAUNCHES["qconv_rq"]
        got = qconv_rq(x, w, b, mult, shift, blocks=blocks, **kw)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["qconv_rq"] == before + 1
        want = qconv_rq_plain(x, w, b, mult, shift, **kw)
    assert torch.equal(got, want), int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_DILATED_CASES + K2_GROUPED_CASES)
@pytest.mark.parametrize("izp", [0, -5])
def test_k2_dilated_and_grouped_on_card(rng, cuda, case, izp):
    """K2 at DeepLabV3 b1 520^2's dilated and ResNeXt-50 b8 224^2's grouped
    calls == plain."""
    _geometry_case(rng, cuda, *case, izp)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_DILATED_CASES + K2_GROUPED_CASES)
def test_k4_dilated_and_grouped_on_card(rng, cuda, case):
    """K4's conv mode at the same calls, at b1 (the unfused traces)."""
    shape = (1, *case[0][1:])
    _geometry_case(rng, cuda, shape, *case[1:], -3, raw=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_GEOMETRY_RAGGED)
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
def test_k2_geometry_ragged_on_card(rng, cuda, case, blocks):
    _geometry_case(rng, cuda, *case, 7, blocks=blocks)
    _geometry_case(rng, cuda, *case, 7, raw=True)


@pytest.mark.cuda
def test_dilated_and_grouped_convs_through_qconv2d_flat(rng, cuda):
    """tk.conv2d_rq's and qnn.conv2d's entry on the card == the CPU path, on
    K2 and K4's conv mode (no K7-K10 layout, no depthwise K5); a 1x1 conv's
    dilation is a no-op and stays on K1; a dilated depthwise conv raises."""
    m, s = plan_requantize(0.0004, 0.05)
    for xs, ws, kw, kernel in (
            ((1, 20, 20, 64), (3, 3, 64, 64), dict(dilation=(3, 3), padding=(3,) * 4,
                                                   layout="t"), "qconv_rq"),
            ((2, 12, 12, 64), (3, 3, 8, 64), dict(groups=8, padding=(1,) * 4), "qconv_rq"),
            ((2, 12, 12, 64), (1, 1, 64, 32), dict(dilation=(2, 2)), "qgemm_rq")):
        x, w = _dev(rng, xs, cuda), _i8(rng, ws)
        before = dict(_lib.LAUNCHES)
        got = qconv2d_flat(x, w, multiplier=m, shift=s, input_zero_point=3, **kw)
        assert _lib.LAUNCHES[kernel] == before.get(kernel, 0) + 1
        assert torch.equal(got.cpu(), qconv2d_flat(x.cpu(), w, multiplier=m, shift=s,
                                                   input_zero_point=3, **kw))
        kw.pop("layout", None)
        raw = qconv2d_flat(x, w, input_zero_point=3, **kw)
        assert torch.equal(raw.cpu(), qconv2d_flat(x.cpu(), w, input_zero_point=3, **kw))
    # a dilated depthwise conv runs on K5
    x, w = _dev(rng, (1, 9, 9, 16), cuda), _i8(rng, (3, 3, 1, 16))
    before = _lib.LAUNCHES["qdwconv_raw"]
    got = qconv2d_flat(x, w, groups=16, dilation=(2, 2), padding=(2,) * 4)
    assert _lib.LAUNCHES["qdwconv_raw"] == before + 1
    assert torch.equal(got.cpu(), qconv2d_flat(x.cpu(), w, groups=16, dilation=(2, 2),
                                               padding=(2,) * 4))


@pytest.mark.cuda
def test_tune_trial_with_a_wrong_answer_is_never_served(cuda, monkeypatch):
    """A trial whose output differs from the plain version is recorded as
    WRONG_ANSWER before any time is taken, and the database never serves it,
    however fast it would have been."""
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod
    from tachikoma_tpu_torch.tune.database import (NO_ERROR, WRONG_ANSWER, TuneDatabase,
                                                   apply_history_best)
    from tachikoma_tpu_torch.tune.tuner import conv_flat_task

    real = conv_mod.qconv_rq_s
    monkeypatch.setattr(conv_mod, "qconv_rq_s", lambda *a, **k: real(*a, **k) ^ 1)
    shape, wshape = (2, 14, 14, 64), (3, 3, 64, 64)
    workload, configs, measure, meta_fn, _ = conv_flat_task(shape, wshape, (2, 2), (1, 1, 1, 1),
                                                            1, device="cuda")
    db = TuneDatabase()
    from tachikoma_tpu_torch.tune.database import TuneRecord
    for cfg in configs[:5]:
        t, err, msg = measure(cfg)
        assert err == (WRONG_ANSWER if cfg.get("layout") == "s" else NO_ERROR), (cfg, msg)
        db.add(TuneRecord(workload, cfg, 1e-9 if err else t * 1e3, err, msg))
    assert db.best(workload).config.get("layout") != "s"
    monkeypatch.setattr(conv_mod, "qconv_rq_s", real)
    calls = []
    monkeypatch.setattr(conv_mod, "qconv_rq_s", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.zeros(shape, dtype=torch.int8, device=cuda)
    with apply_history_best(db):
        conv_mod.qconv2d_flat(x, torch.ones(wshape, dtype=torch.int8, device=cuda),
                              multiplier=1 << 30, shift=0, strides=(2, 2), padding=(1, 1, 1, 1))
    assert not calls


@pytest.mark.cuda
def test_tune_then_serve_resnet18_on_card(cuda, tmp_path):
    """`tune` on the card over a fused ResNet-18 at 32 px, then the forward
    under the database == the CPU path.  Every trial is verified == plain:
    none is a WRONG_ANSWER, and only the library route fails (cuBLASLt
    refuses torch._int_mm at the dense's M = 2, a RUNTIME_ERROR)."""
    from tachikoma_tpu_torch.tune.database import (NO_ERROR, RUNTIME_ERROR, TuneDatabase,
                                                   apply_history_best)
    from tachikoma_tpu_torch.tune.schedule import graph_tasks, schedule_tune

    rng = np.random.default_rng(0)
    q = quantize(resnet(18, batch_size=2, image_size=32, seed=0),
                 [rng.standard_normal((2, 32, 32, 3)).astype(np.float32)])
    fused = fuse_qnn(q)
    db = TuneDatabase(str(tmp_path / "db.jsonl"))
    rep = schedule_tune(graph_tasks(fused, device="cuda"), db, total_trials=40)
    assert rep["total_trials"] == 40
    bad = [(r.workload, r.config, r.error_msg[-200:]) for r in db.records
           if r.error_no != NO_ERROR
           and not (r.error_no == RUNTIME_ERROR and r.config == {"impl": "xla"})]
    assert not bad, bad
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    names = computational_nodes(fused)
    want = TorchExecutor(fused, capture=names, device="cpu").run(x)
    with apply_history_best(db):
        got = TorchExecutor(fused, capture=names, device="cuda").run(x)
    for nm, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, nm
        if a.dtype.kind in "iu":
            assert (a == b).all(), nm


# ---------------------------------------------------------------------------
# K11 qconv_direct, K12 qdwconv_direct, tune_conv, VGG and the graph tuner
# ---------------------------------------------------------------------------

# (x shape, w shape, strides, padding): the CPU tests' shapes
# (tests/test_torch_port_conv_direct.py) and the main path's larger ones
DIRECT_CASES = [
    ((1, 14, 14, 64), (3, 3, 64, 48), (1, 1), (1, 1, 1, 1)),
    ((2, 9, 9, 32), (3, 3, 32, 48), (2, 2), (1, 1, 1, 1)),
    ((1, 8, 8, 40), (3, 3, 40, 48), (1, 1), (0, 0, 0, 0)),
    ((2, 10, 10, 24), (3, 3, 24, 72), (1, 1), (1, 1, 1, 1)),
    ((1, 9, 9, 24), (1, 1, 24, 40), (2, 2), (0, 0, 0, 0)),
    ((2, 20, 20, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3)),
    ((1, 12, 12, 3), (3, 3, 3, 64), (1, 1), (1, 1, 1, 1)),
    ((8, 56, 56, 64), (3, 3, 64, 64), (1, 1), (1, 1, 1, 1)),
    ((2, 14, 14, 512), (3, 3, 512, 512), (1, 1), (1, 1, 1, 1)),
    ((2, 15, 15, 64), (11, 11, 64, 72), (1, 1), (5, 5, 5, 5)),
]
DW_DIRECT_CASES = [
    ((1, 12, 12, 128), 3, (1, 1), (1, 1, 1, 1)),
    ((1, 11, 11, 96), 3, (2, 2), (1, 1, 1, 1)),
    ((1, 9, 9, 48), 3, (1, 1), (1, 1, 1, 1)),
    ((2, 10, 10, 72), 3, (2, 2), (1, 1, 1, 1)),
    ((1, 9, 9, 30), 5, (1, 1), (2, 2, 2, 2)),
    ((8, 112, 112, 96), 3, (2, 2), (0, 1, 0, 1)),
    ((8, 112, 112, 32), 3, (1, 1), (1, 1, 1, 1)),
    # MobileNetV2 b8's other depthwise shapes (17 calls, 10 shapes), then a
    # 5x5 and a 7x7 kernel (weights in shared memory)
    ((8, 112, 112, 96), 3, (2, 2), (1, 1, 1, 1)),
    ((8, 56, 56, 144), 3, (1, 1), (1, 1, 1, 1)),
    ((8, 56, 56, 144), 3, (2, 2), (1, 1, 1, 1)),
    ((8, 28, 28, 192), 3, (1, 1), (1, 1, 1, 1)),
    ((8, 28, 28, 192), 3, (2, 2), (1, 1, 1, 1)),
    ((8, 14, 14, 384), 3, (1, 1), (1, 1, 1, 1)),
    ((8, 14, 14, 576), 3, (1, 1), (1, 1, 1, 1)),
    ((8, 14, 14, 576), 3, (2, 2), (1, 1, 1, 1)),
    ((8, 7, 7, 960), 3, (1, 1), (1, 1, 1, 1)),
    ((2, 17, 17, 64), 5, (1, 1), (2, 2, 2, 2)),
    ((2, 15, 15, 40), 7, (2, 2), (3, 3, 3, 3)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("izp,out_dtype,qmin,qmax,rounding",
                         [(0, torch.int8, -128, 127, "UPWARD"),
                          (-9, torch.uint8, 0, 255, "TONEAREST")])
@pytest.mark.parametrize("case", DIRECT_CASES)
def test_k11_qconv_direct_on_card(rng, cuda, case, izp, out_dtype, qmin, qmax, rounding):
    from tachikoma_tpu_torch.ops.kernels.conv_direct import qconv_direct, qconv_direct_plain

    shape, wshape, strides, padding = case
    x, w = _dev(rng, shape, cuda), _dev(rng, wshape, cuda)
    args = (x, w, *_epilogue_args(rng, wshape[3], cuda))
    kw = dict(strides=strides, padding=padding, izp=izp, out_zp=5, rounding=rounding, qmin=qmin,
              qmax=qmax, out_dtype=out_dtype)
    before = _lib.LAUNCHES["qconv_direct"]
    got = qconv_direct(*args, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qconv_direct"] == before + 1
    want = qconv_direct_plain(*args, **kw)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())


# (x shape, w shape, strides, padding): VGG-16's 3x3s at 224^2, 56^2 and
# 14^2, ResNet-50's 3x3 s2 and 7x7 s2 CIN-3 stem, a 1x1 s2, ragged COUT
K11_HOPPER_CASES = [
    ((2, 224, 224, 64), (3, 3, 64, 64), (1, 1), (1, 1, 1, 1)),
    ((2, 224, 224, 3), (3, 3, 3, 64), (1, 1), (1, 1, 1, 1)),
    ((8, 56, 56, 256), (3, 3, 256, 256), (1, 1), (1, 1, 1, 1)),
    ((8, 14, 14, 512), (3, 3, 512, 512), (1, 1), (1, 1, 1, 1)),
    ((8, 28, 28, 256), (3, 3, 256, 256), (2, 2), (1, 1, 1, 1)),
    ((8, 224, 224, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3)),
    ((8, 28, 28, 512), (1, 1, 512, 1024), (2, 2), (0, 0, 0, 0)),
    ((2, 17, 19, 96), (3, 3, 96, 40), (1, 1), (1, 1, 1, 1)),       # ragged COUT, 2 chunks
    ((2, 17, 19, 24), (5, 5, 24, 13), (3, 2), (2, 1, 2, 3)),       # strides 3 x 2, COUT 13
]


@pytest.mark.cuda
@pytest.mark.parametrize("izp,out_dtype,qmin,qmax,rounding",
                         [(0, torch.int8, -128, 127, "UPWARD"),
                          (-9, torch.uint8, 0, 255, "TONEAREST")])
@pytest.mark.parametrize("case", K11_HOPPER_CASES)
def test_k11_hopper_at_main_path_shapes(rng, cuda, case, izp, out_dtype, qmin, qmax, rounding):
    """K11's Hopper path (its own plan: BN 64 or 128, the weights resident or
    streamed) == plain, int8 and uint8 out, izp 0 and -9; the 7x7 CIN-3
    stem, which the wrapper sends to the narrow path, forced onto it."""
    from tachikoma_tpu_torch.ops.kernels import conv_direct as cd

    shape, wshape, strides, padding = case
    plan = cd.hopper_plan(shape, wshape, strides, padding)
    x, w = _dev(rng, shape, cuda), _dev(rng, wshape, cuda)
    args = (x, w, *_epilogue_args(rng, wshape[3], cuda))
    kw = dict(strides=strides, padding=padding, izp=izp, out_zp=5, rounding=rounding, qmin=qmin,
              qmax=qmax, out_dtype=out_dtype)
    before = _lib.LAUNCHES["qconv_direct"]
    got = cd.qconv_direct(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qconv_direct"] == before + 1
    want = cd.qconv_direct_plain(*args, **kw)
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [{"cc": 64, "bn": 64, "group": 1},
                                  {"cc": 64, "bn": 128, "group": 4},
                                  {"cc": 64, "bn": 64, "group": 9},
                                  {"cc": 16}, {"cc": 4}])
@pytest.mark.parametrize("case", [K11_HOPPER_CASES[3], K11_HOPPER_CASES[5],
                                  K11_HOPPER_CASES[7]])
def test_k11_forced_plans(rng, cuda, plan, case):
    """Each BN and taps a step of the Hopper path, and the narrow path, on
    the same calls == plain."""
    from tachikoma_tpu_torch.ops.kernels import conv_direct as cd

    shape, wshape, strides, padding = case
    if plan["cc"] == cd.KC:
        assert cd.direct_smem(plan["bn"], plan["group"], shape[3], *wshape[:2],
                              strides, plan.get("wres", 0)) <= cd.SMEM_LIMIT
    else:
        assert cd.narrow_smem(plan["cc"], *wshape[:2], strides) <= cd.SMEM_LIMIT
    x, w = _dev(rng, shape, cuda), _dev(rng, wshape, cuda)
    args = (x, w, *_epilogue_args(rng, wshape[3], cuda))
    kw = dict(strides=strides, padding=padding, izp=3, out_zp=-2, rounding="TONEAREST")
    got = cd.qconv_direct(*args, plan=plan, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, cd.qconv_direct_plain(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("case", [K11_HOPPER_CASES[0], K11_HOPPER_CASES[1], K11_HOPPER_CASES[2],
                                  K11_HOPPER_CASES[5], K11_HOPPER_CASES[7]])
def test_k11_resident_and_streamed_weights(rng, cuda, bn, case):
    """The same calls with the N tile's weights resident (where they fit)
    and streamed up to nine taps a step, the copies one to three steps
    ahead: == plain, one persistent block walking several M tiles."""
    from tachikoma_tpu_torch.ops.kernels import conv_direct as cd

    shape, wshape, strides, padding = case
    x, w = _dev(rng, shape, cuda), _dev(rng, wshape, cuda)
    args = (x, w, *_epilogue_args(rng, wshape[3], cuda))
    kw = dict(strides=strides, padding=padding, izp=-5, out_zp=3, rounding="UPWARD")
    want = cd.qconv_direct_plain(*args, **kw)
    def fits(group, wres, ahead):
        return cd.direct_smem(bn, group, shape[3], *wshape[:2], strides, wres,
                              ahead) <= cd.SMEM_LIMIT

    taps = wshape[0] * wshape[1]
    plans = [{"cc": 64, "bn": bn, "group": taps, "wres": 1, "ahead": ahead}
             for ahead in (1, 2, 3) if fits(taps, 1, ahead)]
    group = max(g for g in range(1, min(9, taps) + 1) if fits(g, 0, 1))
    plans += [{"cc": 64, "bn": bn, "group": group, "wres": 0, "ahead": ahead}
              for ahead in (1, 2, 3) if fits(group, 0, ahead)]
    for plan in plans:
        got = cd.qconv_direct(*args, plan=plan, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("izp,out_dtype,qmin,qmax,rounding",
                         [(0, torch.int8, -128, 127, "UPWARD"),
                          (77, torch.uint8, 0, 255, "TONEAREST")])
@pytest.mark.parametrize("case", DW_DIRECT_CASES)
def test_k12_qdwconv_direct_on_card(rng, cuda, case, izp, out_dtype, qmin, qmax, rounding):
    from tachikoma_tpu_torch.ops.kernels.conv_direct import (qdwconv_direct,
                                                             qdwconv_direct_plain)

    shape, k, strides, padding = case
    c = shape[3]
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, 1, c), cuda)
    args = (x, w, *_epilogue_args(rng, c, cuda))
    kw = dict(strides=strides, padding=padding, izp=izp, out_zp=-3, rounding=rounding,
              qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    before = _lib.LAUNCHES["qdwconv_direct"]
    got = qdwconv_direct(*args, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qdwconv_direct"] == before + 1
    want = qdwconv_direct_plain(*args, **kw)
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())


@pytest.mark.cuda
def test_qconv2d_direct_entry_on_a_view_and_refusals(rng, cuda):
    """qconv2d_int8 copies a non-contiguous view before K11 runs it; K11 and
    K12 refuse a CPU operand beside a CUDA one and a weight whose shape does
    not fit the image's channels."""
    from tachikoma_tpu_torch.ops.kernels.conv_direct import qconv2d_int8, qconv2d_int8_plain

    x = _dev(rng, (2, 12, 12, 64), cuda)[:, 1:11, 1:11, :]
    w = _i8(rng, (3, 3, 64, 32))
    m, s = plan_requantize(0.0004, 0.05)
    kw = dict(multiplier=m, shift=s, padding=(1, 1, 1, 1), input_zero_point=4)
    assert torch.equal(qconv2d_int8(x, w, **kw), qconv2d_int8_plain(x, w, **kw))
    from tachikoma_tpu_torch.ops.kernels.conv_direct import qconv_direct

    b = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="is on cpu"):
        qconv_direct(x.contiguous(), torch.from_numpy(w).to(cuda), b, b, b)
    b = b.to(cuda)
    with pytest.raises(ValueError, match="has shape"):     # CIN 64 against a 48-deep weight
        qconv_direct(x.contiguous(), torch.from_numpy(w[:, :, :48]).to(cuda), b, b, b)
    from tachikoma_tpu_torch.ops.kernels.conv_direct import qdwconv_direct

    with pytest.raises(ValueError, match="has shape"):     # a depthwise weight of 32 channels
        qdwconv_direct(x.contiguous(), torch.from_numpy(w[:, :, :1]).to(cuda), b, b, b)


@pytest.mark.cuda
def test_tune_conv_direct_on_card(cuda):
    """tune_conv on the card at a VGG, a ResNet and a MobileNetV2 shape: each
    trial == plain before it is timed, one record each, K11 / K12 launched."""
    from tachikoma_tpu_torch.tune.database import NO_ERROR, TuneDatabase
    from tachikoma_tpu_torch.tune.tuner import tune_conv

    db = TuneDatabase()
    before = dict(_lib.LAUNCHES)
    for shape, wshape, strides, padding, groups in [
            ((2, 28, 28, 256), (3, 3, 256, 256), (1, 1), (1, 1, 1, 1), 1),
            ((2, 56, 56, 64), (7, 7, 64, 64), (2, 2), (3, 3, 3, 3), 1),
            ((2, 56, 56, 144), (3, 3, 1, 144), (2, 2), (0, 1, 0, 1), 144)]:
        best = tune_conv(shape, wshape, strides, padding, groups, db, verbose=False)
        assert best is not None and best.error_no == NO_ERROR, db.records[-1].error_msg
        assert best.meta["tops"] > 0
    assert len(db) == 3
    for name in ("qconv_direct", "qdwconv_direct"):
        assert _lib.LAUNCHES[name] > before.get(name, 0)


@pytest.fixture(scope="module")
def vgg11_32():
    from tachikoma_tpu_torch.models.vision import vgg

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return quantize(vgg(11, batch_size=2, image_size=32, seed=0), [x]), x


@pytest.mark.cuda
def test_vgg_fused_forward_on_card_equals_cpu(cuda, vgg11_32):
    q, x = vgg11_32
    fused = fuse_qnn(q)
    names = computational_nodes(fused)
    got = TorchExecutor(fused, capture=names, device="cuda").run(x)
    want = TorchExecutor(fused, capture=names, device="cpu").run(x)
    for nm, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, nm
        if a.dtype.kind in "iu":
            assert (a == b).all(), nm
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8, err_msg=nm)


@pytest.mark.cuda
def test_graph_tune_vgg_on_card(cuda, vgg11_32):
    """tune_graph over VGG-11's three chains with a measurer that runs each
    variant on the card; every variant's integer outputs == the baseline's."""
    import time

    from tachikoma_tpu_torch.tune.database import TuneDatabase
    from tachikoma_tpu_torch.tune.graph_tuner import tune_graph

    q, x = vgg11_32
    names = computational_nodes(fuse_qnn(q))
    base = {}

    def measure(g):
        ex = TorchExecutor(g, capture=names, device="cuda")
        assert ex.graph is g            # run as handed over, not fused again
        outs = ex.run(x)
        for nm, a, b in zip(names, outs, base.setdefault("outs", outs)):
            assert a.dtype == b.dtype, nm
            if a.dtype.kind in "iu":
                assert (a == b).all(), nm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ex.run_device(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    db = TuneDatabase()
    res = tune_graph(q, measure, db=db, verbose=False)
    assert res.trials == 4 and len(db) == 4


# ---------------------------------------------------------------------------
# K1's batched mode (qbmm_rq, qbmm_raw): tk.bmm_rq and qnn.batch_matmul
# ---------------------------------------------------------------------------

def _heads(rng, b, s, h, d, device):
    """A head-split (B, H, S, D) view of a (B, S, H, D) int8 tensor."""
    return _dev(rng, (b, s, h, d), device).permute(0, 2, 1, 3)


def _bmm_case(rng, device, case):
    """(a, b, keyword arguments) of the attention products: scores q . k^T of
    head-split views, context softmax . v with the softmax's zero point; the
    decode step's (d-: q's row against the (B, H, S, D) caches, the softmax
    row against V; p-: 8 rows, a prompt's or a verify step's); the ring's
    (r-: contiguous chunks of S rows)."""
    kind, b, s, h, d = case
    if kind == "scores":
        return (_heads(rng, b, s, h, d, device), _heads(rng, b, s, h, d, device),
                dict(transpose_b=True))
    if kind == "context":
        return (_dev(rng, (b, h, s, s), device), _heads(rng, b, s, h, d, device),
                dict(lhs_zero_point=-128))
    cache = _dev(rng, (b, h, s, d), device)
    rows = 8 if kind.startswith("p-") else 1
    if kind in ("d-scores", "p-scores"):
        return _heads(rng, b, rows, h, d, device), cache, dict(transpose_b=True)
    if kind in ("d-context", "p-context"):
        return _dev(rng, (b, h, rows, s), device), cache, dict(lhs_zero_point=-128)
    if kind == "r-scores":
        return _dev(rng, (b, h, s, d), device), cache, dict(transpose_b=True)
    return _dev(rng, (b, h, s, s), device), cache, dict(lhs_zero_point=-128)  # r-context


BMM_CASES = [("scores", 4, 128, 12, 64), ("context", 4, 128, 12, 64),   # BERT-base b4 s128
             ("scores", 2, 197, 12, 64), ("context", 2, 197, 12, 64),   # ViT-B/16's S
             ("scores", 1, 197, 16, 64), ("context", 1, 197, 16, 64),   # ViT-L/16
             ("d-scores", 1, 128, 12, 64), ("d-context", 1, 128, 12, 64),  # the decode step
             ("p-scores", 1, 128, 12, 64), ("p-context", 1, 128, 12, 64),  # 8 rows at the cache
             ("r-scores", 1, 1024, 12, 64),                               # a ring chunk
             ("r-context", 1, 2048, 2, 64),                               # K 2048
             ("r-context", 1, 300, 2, 64),                                # K 300: a 44-byte tail
             ("scores", 2, 40, 3, 40), ("context", 2, 40, 3, 40),       # ragged D
             ("scores", 1, 33, 2, 72), ("context", 1, 33, 2, 72)]
# every path: the plan's own, the small path where M <= 16, and tiles at
# every BM and BN (K in the chunks bmm_kc gives: whole up to 256 bytes)
BMM_PLANS = [None, {"path": "small"},
             {"path": "tiles", "bm": 64, "bn": 64},
             {"path": "tiles", "bm": 128, "bn": 256},
             {"path": "tiles", "bm": 64, "bn": 256},
             {"path": "tiles", "bm": 128, "bn": 64}]


def _bmm_want(fn, a, b, *args, **kw):
    """The plain version on the CPU, or for the big calls on the card
    (float64 sums of integers below 2^53: exact in any order)."""
    if a.numel() + b.numel() > 1 << 22:
        return fn(a, b, *args, **kw).cpu()
    return fn(a.cpu(), b.cpu(), *(None if v is None else v.cpu() for v in args), **kw)


def _plan_id(plan):
    if plan is None or plan["path"] == "small":
        return "default" if plan is None else "small"
    return f"t{plan['bm']}x{plan['bn']}"


# the small path only where M <= 16 (the decode step's products, 8 rows)
BMM_CASE_PLANS = [(c, p) for c in BMM_CASES for p in BMM_PLANS
                  if p is None or p["path"] == "tiles" or c[0][:2] in ("d-", "p-")]


@pytest.mark.cuda
@pytest.mark.parametrize("case,plan", BMM_CASE_PLANS,
                         ids=["-".join(map(str, c)) + "-" + _plan_id(p) for c, p in BMM_CASE_PLANS])
def test_k1_qbmm_on_card(rng, cuda, case, plan):
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    a, b, kw = _bmm_case(rng, cuda, case)
    n = b.shape[-2] if kw.get("transpose_b") else b.shape[-1]
    mult, shift = plan_requantize(0.002, 1.0)
    m_t, s_t = channel_vector(mult, n, cuda), channel_vector(shift, n, cuda)
    before = _lib.LAUNCHES["qbmm_raw"], _lib.LAUNCHES["qbmm_rq"]
    raw = qbmm_raw(a, b, plan=plan, **kw)
    assert torch.equal(raw.cpu(), _bmm_want(qbmm_raw_plain, a, b, **kw))
    rq = qbmm_rq(a, b, None, m_t, s_t, out_zp=-3, qmin=-120, plan=plan, **kw)
    want = _bmm_want(qbmm_rq_plain, a, b, None, m_t, s_t, out_zp=-3, qmin=-120, **kw)
    assert torch.equal(rq.cpu(), want)
    assert (_lib.LAUNCHES["qbmm_raw"], _lib.LAUNCHES["qbmm_rq"]) == (before[0] + 1,
                                                                     before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("za,zb,ta,tb", [(0, 5, False, False), (-128, -7, False, True),
                                         (11, 3, True, True), (-128, 0, True, False),
                                         (0, -128, False, False), (-128, -128, False, True),
                                         (11, -128, True, True), (-128, -128, True, False)])
@pytest.mark.parametrize("m", [5, 48])
def test_k1_qbmm_zero_points_and_transposes_on_card(rng, cuda, za, zb, ta, tb, m):
    """Both zero points, -128 flipped into the operand (read as uint8) on
    either side or both, any other folded (the column and row terms); both
    transposes (A or B read with its rows contiguous); broadcast batch axes
    and a bias; the small path (M 5) and the tiles (M 48)."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    k, n = 80, 64
    a = _dev(rng, (2, 1) + ((k, m) if ta else (m, k)), cuda)
    b = _dev(rng, (1, 3) + ((n, k) if tb else (k, n)), cuda)
    kw = dict(lhs_zero_point=za, rhs_zero_point=zb, transpose_a=ta, transpose_b=tb)
    assert torch.equal(qbmm_raw(a, b, **kw).cpu(), qbmm_raw_plain(a.cpu(), b.cpu(), **kw))
    bias = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)).to(cuda)
    mult, shift = plan_requantize(0.0004 * (0.5 + rng.random(n)), 1.0)
    m_t, s_t = channel_vector(mult, n, cuda), channel_vector(shift, n, cuda)
    got = qbmm_rq(a, b, bias, m_t, s_t, rounding="TONEAREST", **kw)
    want = qbmm_rq_plain(a.cpu(), b.cpu(), bias.cpu(), m_t.cpu(), s_t.cpu(),
                         rounding="TONEAREST", **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("m", [1, 70])
def test_k1_qbmm_odd_base_pointer_on_card(rng, cuda, offset, side, m):
    """An operand whose data starts an odd number of bytes (or 8) past 16-byte
    alignment: staged by realigned loads on both paths, == plain."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    shapes = {"a": (2, 3, m, 96), "b": (2, 3, 96, 40)}
    a, b = _dev(rng, shapes["a"], cuda), _dev(rng, shapes["b"], cuda)
    t = a if side == "a" else b
    flat = torch.empty(t.numel() + offset, dtype=torch.int8, device=cuda)
    v = flat[offset:].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == offset % 16
    a, b = (v, b) if side == "a" else (a, v)
    for za, zb in ((0, 0), (-128, 3)):
        kw = dict(lhs_zero_point=za, rhs_zero_point=zb)
        assert torch.equal(qbmm_raw(a, b, **kw).cpu(), qbmm_raw_plain(a.cpu(), b.cpu(), **kw))
        mult, shift = plan_requantize(0.001, 1.0)
        m_t, s_t = channel_vector(mult, 40, cuda), channel_vector(shift, 40, cuda)
        assert torch.equal(qbmm_rq(a, b, None, m_t, s_t, **kw).cpu(),
                           qbmm_rq_plain(a.cpu(), b.cpu(), None, m_t.cpu(), s_t.cpu(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 197])
@pytest.mark.parametrize("m", [1, 12, 197])
def test_k1_qbmm_ragged_n_on_card(rng, cuda, n, m):
    """N = 8 and N = 197: the staged epilogue's ragged rows (a run of whole
    rows, or a row at a time past one tile), both epilogues, both paths."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    a, b = _dev(rng, (3, 2, m, 64), cuda), _dev(rng, (3, 2, 64, n), cuda)
    mult, shift = plan_requantize(0.002 * (0.5 + rng.random(n)), 1.0)
    m_t, s_t = channel_vector(mult, n, cuda), channel_vector(shift, n, cuda)
    plans = [None, {"path": "tiles", "bm": 64, "bn": 64}]
    for plan in plans + ([{"path": "small"}] if m <= 16 else []):
        assert torch.equal(qbmm_raw(a, b, plan=plan).cpu(), qbmm_raw_plain(a.cpu(), b.cpu()))
        assert torch.equal(qbmm_rq(a, b, None, m_t, s_t, out_zp=4, plan=plan).cpu(),
                           qbmm_rq_plain(a.cpu(), b.cpu(), None, m_t.cpu(), s_t.cpu(), out_zp=4))


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("m", [1, 96])
def test_k1_qbmm_requant_shifts_on_card(rng, cuda, rounding, m):
    """The requantize at per-column scales from 2^-24 to 2^5 (right shifts
    of 31 to 55 bits, left shifts of 1 to 5), extreme biases and a narrow
    clip, on the small path (M 1) and the tiles (M 96): == plain."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qbmm_rq, qbmm_rq_plain

    n = 160
    a, b = _dev(rng, (3, m, 100), cuda), _dev(rng, (3, 100, n), cuda)
    mult, shift = plan_requantize(2.0 ** rng.uniform(-24, 5, n), 1.0)
    assert shift.min() < -20 and shift.max() > 0
    m_t, s_t = channel_vector(mult, n, cuda), channel_vector(shift, n, cuda)
    bias = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)).to(cuda)
    kw = dict(lhs_zero_point=-128, rq_izp=7, out_zp=-5, rounding=rounding, qmin=-100, qmax=90)
    got = qbmm_rq(a, b, bias, m_t, s_t, **kw)
    want = qbmm_rq_plain(a.cpu(), b.cpu(), bias.cpu(), m_t.cpu(), s_t.cpu(), **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k1_qbmm_reads_each_calls_rhs(rng, cuda):
    """Two calls at one shape with different rhs values each give their own
    answer: the batched mode packs nothing."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qbmm_raw, qbmm_raw_plain

    for kind in ("scores", "context"):
        a, b1, kw = _bmm_case(rng, cuda, (kind, 4, 128, 12, 64))
        _, b2, _ = _bmm_case(rng, cuda, (kind, 4, 128, 12, 64))
        o1, o2 = qbmm_raw(a, b1, **kw), qbmm_raw(a, b2, **kw)
        assert torch.equal(o1.cpu(), qbmm_raw_plain(a.cpu(), b1.cpu(), **kw))
        assert torch.equal(o2.cpu(), qbmm_raw_plain(a.cpu(), b2.cpu(), **kw))
        b1.copy_(b2)  # written in place: read anew
        assert torch.equal(qbmm_raw(a, b1, **kw).cpu(), o2.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "gpt2", "vit"])
def test_int8_transformer_on_card_equals_cpu(cuda, name):
    """A small int8 transformer (TRANSFORMER_INT8), fused and unfused: every
    integer node on the card == the CPU path, tk.bmm_rq through qbmm_rq and
    qnn.batch_matmul through qbmm_raw."""
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8

    kw = {"bert": dict(batch_size=2, seq_len=32, hidden=64, layers=2, heads=4, ffn_dim=128,
                       vocab=100, seed=3),
          "gpt2": dict(batch_size=1, seq_len=24, hidden=48, layers=2, heads=4, ffn_dim=96,
                       vocab=80, seed=4),
          "vit": dict(batch_size=2, image_size=32, patch=8, hidden=64, layers=2, heads=4,
                      ffn_dim=128, num_classes=10, seed=5)}[name]
    g = {"bert": bert, "gpt2": gpt2, "vit": vit}[name](**kw)
    inp = g.inputs[0]
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 60, inp.shape).astype(inp.dtype) if inp.dtype.startswith("int")
         else rng.standard_normal(inp.shape).astype(np.float32))
    q = quantize(g, [x], TRANSFORMER_INT8)
    for graph, key in ((fuse_qnn(q), "qbmm_rq"), (q, "qbmm_raw")):
        names = computational_nodes(graph)
        before = _lib.LAUNCHES[key]
        got = TorchExecutor(graph, capture=names, device="cuda", fuse=False).run(x)
        assert _lib.LAUNCHES[key] - before == 2 * kw["layers"]
        want = TorchExecutor(graph, capture=names, device="cpu", fuse=False).run(x)
        for nm, a, b in zip(names, got, want):
            assert a.dtype == b.dtype, nm
            if a.dtype.kind in "iu":
                assert (a == b).all(), nm
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=nm)


@pytest.mark.cuda
@pytest.mark.parametrize("scores_scale", [0.01, 1.0])
def test_qnn_attention_on_card_equals_cpu(rng, cuda, scores_scale):
    """qnn.attention's two products on K1's batched mode (the second as a
    product of u - 128 with zero point -128 plus the u == 256 term; 1.0
    makes rows with u == 256) == its CPU path."""
    from tachikoma_tpu_torch import GraphBuilder, infer_types

    b = GraphBuilder("attn")
    q, k, v = (b.var(n, (2, 3, 16, 32), "int8") for n in "qkv")
    g = infer_types(b.build(b.call("qnn.attention", q, k, v, scores_scale=scores_scale,
                                   v_scale=0.02, output_scale=0.05, name="y")))
    x = {n: _i8(rng, (2, 3, 16, 32)) for n in "qkv"}
    before = _lib.LAUNCHES["qbmm_raw"]
    got = TorchExecutor(g, device="cuda", fuse=False).run(x)[0]
    assert _lib.LAUNCHES["qbmm_raw"] - before == 3
    want = TorchExecutor(g, device="cpu", fuse=False).run(x)[0]
    assert got.dtype == want.dtype and (got == want).all()


# ---------------------------------------------------------------------------
# the decode step (models/decoding.py): K1, K4 and K1's batched mode at M = 1,
# dynamic_update_slice, the step captured in a CUDA graph
# ---------------------------------------------------------------------------

# GPT-2 small's decode step at b1 (and b2): attn_o, ffn1, ffn2 on K1's skinny
# path, the merged Q/K/V on K4's GEMM mode
DECODE_GEMM_CASES = [(m, k, n) for m in (1, 2)
                     for k, n in ((768, 768), (768, 3072), (3072, 768), (768, 2304))]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", DECODE_GEMM_CASES, ids=["x".join(map(str, c))
                                                        for c in DECODE_GEMM_CASES])
def test_k1_and_k4_at_decode_shapes(rng, cuda, mkn):
    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b, mult, shift = _epilogue_args(rng, n, cuda)
    kw = dict(rq_izp=0, out_zp=5, rounding="UPWARD", qmin=-128, qmax=127)
    got = qgemm_rq(x, w, b, mult, shift, **kw)
    bias = _extreme_bias(rng, n, cuda)
    raw = qgemm_raw(x, w, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, qgemm_rq_plain(x, w, b, mult, shift, **kw))
    assert raw.shape == (m, n) and torch.equal(raw, qgemm_raw_plain(x, w, bias))


# (kind, B, H, cache length, head width): the step's scores q . K^T over the
# whole cache, (1, 64) x (128, 64)^T a head, and context p . V with the
# softmax's zero point, (1, 128) x (128, 64), V the cache itself
DECODE_BMM_CASES = [(kind, b, 12, 128, 64) for kind in ("scores", "context") for b in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_BMM_CASES,
                         ids=["-".join(map(str, c)) for c in DECODE_BMM_CASES])
def test_k1_qbmm_at_decode_shapes(rng, cuda, case):
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    kind, b, h, s, d = case
    cache = _dev(rng, (b, h, s, d), cuda)
    if kind == "scores":
        a, kw, n = _heads(rng, b, 1, h, d, cuda), dict(transpose_b=True), s
    else:
        a, kw, n = _dev(rng, (b, h, 1, s), cuda), dict(lhs_zero_point=-128), d
    mult, shift = plan_requantize(0.002, 1.0)
    m_t, s_t = channel_vector(mult, n, cuda), channel_vector(shift, n, cuda)
    raw = qbmm_raw(a, cache, **kw)
    assert raw.shape == (b, h, 1, n)
    assert torch.equal(raw.cpu(), qbmm_raw_plain(a.cpu(), cache.cpu(), **kw))
    rq = qbmm_rq(a, cache, None, m_t, s_t, out_zp=-3, **kw)
    want = qbmm_rq_plain(a.cpu(), cache.cpu(), None, m_t.cpu(), s_t.cpu(), out_zp=-3, **kw)
    assert torch.equal(rq.cpu(), want)


def _graph_replay(fn):
    """fn() captured in a CUDA graph after one warm run on a side stream;
    returns (graph, the captured output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.cuda
def test_dynamic_update_slice_on_card_reads_its_start_on_the_device(rng, cuda):
    """dynamic_update_slice on the card == the oracle at every start, the
    start read on the device: one captured graph replayed with the start
    tensor rewritten between replays writes each position."""
    from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph

    b = GraphBuilder("dus")
    cache, row = b.var("cache", (2, 3, 12, 4), "float32"), b.var("row", (2, 3, 1, 4), "float32")
    pos, zero = b.var("pos", (), "int32"), b.const(np.int32(0))
    g = infer_types(b.build(b.call("dynamic_update_slice", cache, row, zero, zero, pos, zero,
                                   name="y")))
    c = rng.standard_normal((2, 3, 12, 4)).astype(np.float32)
    r = rng.standard_normal((2, 3, 1, 4)).astype(np.float32)
    ex = TorchExecutor(g, device="cuda")
    feeds = {"cache": torch.from_numpy(c).cuda(), "row": torch.from_numpy(r).cuda(),
             "pos": torch.tensor(0, dtype=torch.int32, device="cuda")}
    graph, out = _graph_replay(lambda: ex.run_device(feeds)[0])
    for p in (0, 5, 11, 40):
        feeds["pos"].fill_(p)
        graph.replay()
        want = run_graph(g, {"cache": c, "row": r, "pos": np.int32(p)})[0]
        assert (out.cpu().numpy() == want).all(), p
        assert (ex.run(feeds)[0] == want).all(), p


def _tiny_decoder_models():
    from tachikoma_tpu_torch.models.decoding import gpt2_decode_step

    dims = dict(hidden=32, layers=2, heads=4, ffn_dim=64, vocab=50)
    full = gpt2(batch_size=2, seq_len=12, seed=7, **dims)
    return full, gpt2_decode_step(full, batch_size=2, max_len=12, **dims)


def _step_feeds(step, prompt, steps):
    from tachikoma_tpu_torch import run_graph

    caches = {n.name: np.zeros(n.shape, np.float32) for n in step.inputs if n.name[0] in "kv"}
    feeds = []
    for p in range(steps):
        f = {"token": prompt[:, p:p + 1], "pos": np.int32(p), **caches}
        feeds.append(dict(f))
        outs = run_graph(step, f)
        for i in range(2):
            caches[f"k{i}"], caches[f"v{i}"] = outs[1 + i], outs[3 + i]
    return feeds


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["float", "int8"])
def test_decode_step_captured_in_a_cuda_graph_equals_eager(cuda, form):
    """One decode step captured in a CUDA graph after a warm eager step and
    replayed at two positions == the eager step on the card, and its integer
    nodes == the CPU path (the int8 step through K1, K4 and qbmm_rq)."""
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8

    _, step = _tiny_decoder_models()
    prompt = np.random.default_rng(2).integers(0, 50, (2, 6)).astype(np.int32)
    feeds = _step_feeds(step, prompt, 6)
    if form == "int8":
        step = fuse_qnn(quantize(step, feeds[:4], TRANSFORMER_INT8))
        assert {"qnn.dense", "tk.dense_rq", "tk.bmm_rq"} <= {n.op for n in step.nodes}
    names = computational_nodes(step)
    ex = TorchExecutor(step, capture=names, device="cuda")
    static = {k: torch.as_tensor(np.asarray(v)).cuda() for k, v in feeds[4].items()}
    graph, outs = _graph_replay(lambda: ex.run_device(static))
    for f in (feeds[4], feeds[5]):
        for k, v in f.items():
            static[k].copy_(torch.as_tensor(np.asarray(v)))
        graph.replay()
        got = [o.cpu().numpy() for o in outs]
        eager = ex.run(f)
        cpu = TorchExecutor(step, capture=names, device="cpu").run(f)
        for nm, a, e, c in zip(names, got, eager, cpu):
            assert a.dtype == e.dtype == c.dtype, nm
            if a.dtype.kind in "iub":
                assert (a == e).all() and (a == c).all(), nm
            else:
                np.testing.assert_array_equal(a, e, err_msg=nm)
                np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4, err_msg=nm)


@pytest.mark.cuda
def test_generate_ondevice_on_card_equals_generate(cuda):
    """generate_ondevice replays a captured step (n_new - 1 replays) and
    gives generate's greedy tokens, on the card and against the CPU; its
    sampling is deterministic at a seed."""
    from tachikoma_tpu_torch.models.decoding import GreedyDecoder

    full, step = _tiny_decoder_models()
    prompt = np.random.default_rng(3).integers(0, 50, (2, 5)).astype(np.int32)
    dec = GreedyDecoder(step, layers=2).attach_prefill(fuse_attention(full))
    host, _ = dec.generate(prompt, 6)
    cpu, _ = GreedyDecoder(step, layers=2, device="cpu").attach_prefill(full).generate(prompt, 6)
    np.testing.assert_array_equal(host, cpu)
    got = dec.generate_ondevice(prompt, 6)
    assert dec.cuda_graph is not None and dec.replays == 5
    np.testing.assert_array_equal(got, host)
    a = dec.generate_ondevice(prompt, 6, temperature=0.8, top_k=10, seed=3)
    b = dec.generate_ondevice(prompt, 6, temperature=0.8, top_k=10, seed=3)
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < 50).all()


# ---------------------------------------------------------------------------
# the rest of the vision zoo: its new kernel shapes and its float ops
# ---------------------------------------------------------------------------

# K2 at shapes no earlier path gave it: LeNet-5's 5x5 convs (CIN 1 -> 6 pad 2:
# COUT % 16 != 0, the output stored element by element; CIN 6 -> 16), DQN's
# 8x8 s4 at CIN 4 (the narrow-CIN gather, K = 256), 4x4 s2 at CIN 32 and
# 3x3 at 9^2, Inception's 3x3 s2 valid stem at 299^2, SSD-lite's extra 3x3 s2
# convs on 5^2 and 3^2 maps
ZOO_K2_CASES = [
    ((1, 28, 28, 1), 5, 1, 2, 6, -3),
    ((1, 14, 14, 6), 5, 1, 0, 16, 4),
    ((1, 84, 84, 4), 8, 4, 0, 32, 0),
    ((1, 20, 20, 32), 4, 2, 0, 64, 7),
    ((1, 9, 9, 64), 3, 1, 0, 64, -5),
    ((8, 299, 299, 3), 3, 2, 0, 32, 0),
    ((1, 5, 5, 128), 3, 2, 1, 256, 0),
    ((1, 3, 3, 128), 3, 2, 1, 256, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZOO_K2_CASES)
def test_k2_at_the_vision_zoo_shapes_on_card(rng, cuda, case):
    shape, k, s, p, cout, izp = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    kw = dict(strides=(s, s), padding=(p, p, p, p), izp=izp, out_zp=1)
    got = qconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))


# K5 at SSD-lite's head depthwise convs (3x3 pad 1): 20^2 x 96, 10^2 x 160,
# and the extra stages' maps, 5^2 to 1^2 at C 256 (most of a window padding)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 20, 20, 96), (1, 10, 10, 160), (1, 5, 5, 256),
                                   (1, 3, 3, 256), (1, 2, 2, 256), (1, 1, 1, 256)])
def test_k5_on_tiny_maps_on_card(rng, cuda, shape):
    c = shape[3]
    x, w = _dev(rng, shape, cuda), _dev(rng, (3, 3, 1, c), cuda)
    b, mult, shift = _epilogue_args(rng, c, cuda)
    kw = dict(strides=(1, 1), padding=(1, 1, 1, 1), izp=-4, rq_izp=-3, out_zp=2,
              rounding="UPWARD", qmin=0, qmax=127)
    got = qdwconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qdwconv_rq_plain(x, w, b, mult, shift, **kw))


# K1 at SSD-lite's 1x1 heads (N = 126 and 24 = 6 anchors x 21 classes, x 4)
# and at M = 1 (the LSTM's two denses a step, DQN's and the MLP's heads)
@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(400, 96, 126), (400, 96, 24), (25, 256, 126), (9, 256, 24),
                                 (1, 64, 512), (1, 128, 512), (1, 3136, 512), (1, 784, 128)])
def test_k1_at_the_vision_zoo_shapes_on_card(rng, cuda, mkn):
    m, k, n = mkn
    x, w = _dev(rng, (m, k), cuda), _dev(rng, (k, n), cuda)
    b, mult, shift = _epilogue_args(rng, n, cuda)
    kw = dict(rq_izp=3, out_zp=-2, rounding="UPWARD", qmin=-128, qmax=127)
    got = qgemm_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qgemm_rq_plain(x, w, b, mult, shift, **kw))


def _one_node(op, attrs, *inputs):
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    node = Node("n", op, tuple(f"x{i}" for i in range(len(inputs))), attrs)
    impl = get_op(op)
    return impl, node


@pytest.mark.cuda
def test_batch_norm_on_card_is_the_cpus_bit_for_bit(rng, cuda):
    x = (rng.standard_normal((2, 16, 16, 64)) * np.exp(rng.uniform(-6, 6, (2, 16, 16, 64)))
         ).astype(np.float32)
    params = [np.abs(rng.standard_normal(64)).astype(np.float32) + 0.5,
              rng.standard_normal(64).astype(np.float32) * 0.1,
              rng.standard_normal(64).astype(np.float32) * 0.1,
              np.abs(rng.standard_normal(64)).astype(np.float32) + 1e-4]
    impl, node = _one_node("nn.batch_norm", {}, x, *params)
    cpu = impl.torch_impl(torch.from_numpy(x), *map(torch.from_numpy, params), node=node)
    card = impl.torch_impl(torch.from_numpy(x).to(cuda),
                           *(torch.from_numpy(p).to(cuda) for p in params), node=node)
    assert card.cpu().numpy().tobytes() == cpu.numpy().tobytes()
    assert cpu.numpy().tobytes() == impl.np_impl(x, *params, node=node).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,thr", [(3204, 100, 0.05), (500, 20, -1.0), (64, 64, 0.5)])
def test_nms_on_card_equals_the_oracle(rng, cuda, n, k, thr):
    lo = rng.random((2, n, 2)).astype(np.float32) * 0.8
    boxes = np.concatenate([lo, lo + (0.05 + rng.random((2, n, 2)) * 0.3)], -1).astype(np.float32)
    scores = (1 / 21 + rng.standard_normal((2, n)) * 0.01).astype(np.float32)
    m = n // 7
    scores[:, 1:7 * m:7] = scores[:, 0:7 * m:7]  # ties
    impl, node = _one_node("vision.non_max_suppression",
                           dict(max_output_size=k, iou_threshold=0.5, score_threshold=thr),
                           boxes, scores)
    got = impl.torch_impl(torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda),
                          node=node)
    np.testing.assert_array_equal(got.cpu().numpy(), impl.np_impl(boxes, scores, node=node))


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("lenet5", {}), ("dqn", {}), ("squeezenet", {"image_size": 64}),
    ("inception_v3_stem", {"image_size": 75}),
    ("densenet", {"image_size": 32, "blocks": (2, 2, 2, 2), "growth": 8}),
    ("lstm", {"seq_len": 4}), ("ssd_lite", {"image_size": 64}),
    ("dcgan_generator", {}), ("resnet_3d", {"frames": 2, "image_size": 8})])
def test_vision_zoo_executor_on_card_equals_cpu(cuda, name, kw, monkeypatch):
    """The small zoo graphs, fused, on the card against the CPU path, with
    TF32 allowed for cuDNN and matmuls (the port's float products turn it
    off): every integer node == the CPU path, or, where a float op computed
    in another order on the card reaches it, == its own op's CPU impl on the
    card's inputs (runtime/crosscheck.py); float nodes within rtol 1e-4,
    atol 1e-4 of the same."""
    from tachikoma_tpu_torch.models import vision
    from tachikoma_tpu_torch.runtime.crosscheck import hold_node_level

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rng = np.random.default_rng(9)
    g = getattr(vision, name)(**kw)
    feeds = [{n.name: rng.standard_normal(n.shape).astype(np.float32) for n in g.inputs}
             for _ in range(2)]
    fused = fuse_qnn(quantize(g, [feeds[0]]))
    names = computational_nodes(fused)

    def host(v):
        return [t.cpu().numpy() for t in v] if isinstance(v, list) else v.cpu().numpy()

    card = [host(v) for v in TorchExecutor(fused, capture=names, device="cuda").run_device(feeds[1])]
    cpu = [host(v) for v in TorchExecutor(fused, capture=names, device="cpu").run_device(feeds[1])]
    counts, _ = hold_node_level(fused, names, card, cpu, feeds[1], 1e-4, 1e-4)
    assert counts["int"] + counts["cone_int"] > 0


# ---------------------------------------------------------------------------
# W8A16 on the card: qgemm_wide / qconv_wide (csrc/qconv_wide_hopper.cu) and
# K5's int16 mode qdwconv_wide, the wide requantize, and the exporter's TFLite
# MobileNetV2 at b16 on K1 / K2 / K5 (`-k "w8a16 or tflite"`)
# ---------------------------------------------------------------------------

W8A16_CONVS = [
    # (x shape, weight shape, strides, padding, groups): ResNet-50's 7x7 s2 stem,
    # a 3x3 s2 and s1 at its widths, 1x1 s1 / s2, MobileNetV2-like depthwise
    # (TFLite's bottom-right SAME at s2), the 16x8 fixture's groups-8 conv; CIN
    # 12 and 20 (not a multiple of 8: element loads), CIN 24 (a 16-element
    # segment across two taps), the b1 trace's 7^2 3x3 (K split over the grid)
    ((1, 224, 224, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3), 1),
    ((2, 28, 28, 128), (3, 3, 128, 128), (2, 2), (1, 1, 1, 1), 1),
    ((1, 14, 14, 256), (3, 3, 256, 256), (1, 1), (1, 1, 1, 1), 1),
    ((2, 28, 28, 256), (1, 1, 256, 512), (2, 2), (0, 0, 0, 0), 1),
    ((1, 7, 7, 512), (1, 1, 512, 2048), (1, 1), (0, 0, 0, 0), 1),
    ((2, 56, 56, 144), (3, 3, 1, 144), (2, 2), (0, 0, 1, 1), 144),
    ((1, 16, 16, 8), (3, 3, 1, 8), (1, 1), (1, 1, 1, 1), 8),
    ((2, 13, 13, 12), (3, 3, 12, 40), (1, 1), (1, 1, 1, 1), 1),
    ((3, 10, 10, 20), (1, 1, 20, 24), (1, 1), (0, 0, 0, 0), 1),
    ((2, 9, 9, 24), (3, 3, 24, 72), (2, 2), (0, 1, 1, 0), 1),
    ((1, 7, 7, 512), (3, 3, 512, 512), (1, 1), (1, 1, 1, 1), 1),
]
W8A16_ZPS = [0, -32768, 32767, 256, -3841]
K4_K5 = ("qgemm_raw", "qconv_raw", "qdwconv_raw")


def _i16(rng, shape):
    x = rng.integers(-2 ** 15, 2 ** 15, shape).astype(np.int16)
    flat = x.reshape(-1)
    flat[: flat.size // 8] = -2 ** 15
    flat[flat.size // 8: flat.size // 4] = 2 ** 15 - 1
    rng.shuffle(flat)
    return x


def _wide_kernel(xs, ws, strides, padding, groups) -> str:
    """The kernel `wide.wide_conv` launches for an int16 conv."""
    if groups > 1:
        return "qdwconv_wide" if groups == xs[3] == ws[3] and ws[2] == 1 else "qconv_wide"
    one = ws[:2] == (1, 1) and tuple(strides) == (1, 1) and not any(padding)
    return "qgemm_wide" if one else "qconv_wide"


@pytest.mark.cuda
@pytest.mark.parametrize("izp", W8A16_ZPS)
@pytest.mark.parametrize("case", W8A16_CONVS, ids=[f"conv{i}" for i in range(len(W8A16_CONVS))])
def test_w8a16_conv_planes_on_card_equal_plain(rng, cuda, case, izp):
    """Each int16 conv runs on its own kernel, counted under its name, with
    no K4 / K5 launch, == the float64 plain version and the CPU path."""
    from tachikoma_tpu_torch.ops.kernels import wide

    xs, ws, strides, padding, groups = case
    x = torch.from_numpy(_i16(rng, xs)).to(cuda)
    w = _dev(rng, ws, cuda)
    kw = dict(strides=strides, padding=padding, groups=groups, izp=izp)
    name = _wide_kernel(*case)
    before = dict(_lib.LAUNCHES)
    got = wide.wide_conv(x, w, **kw)
    want = wide.wide_conv_plain(x, w, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[name] == before.get(name, 0) + 1
    assert all(_lib.LAUNCHES[k] == before.get(k, 0) for k in K4_K5)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    cpu = wide.wide_conv(x.cpu(), w.cpu(), **kw)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("izp", W8A16_ZPS)
@pytest.mark.parametrize("mkn", [(8, 2048, 1000), (1, 2048, 1000), (16, 1280, 10),
                                 (100, 576, 96), (3136, 64, 256), (1, 70, 10), (49, 4608, 512)])
def test_w8a16_dense_planes_on_card_equal_plain(rng, cuda, mkn, izp):
    from tachikoma_tpu_torch.ops.kernels import wide

    m, k, n = mkn
    x = torch.from_numpy(_i16(rng, (m, k))).to(cuda)
    w = _dev(rng, (k, n), cuda)
    before = _lib.LAUNCHES["qgemm_wide"]
    got = wide.wide_dense(x, w, izp=izp)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qgemm_wide"] == before + 1
    assert torch.equal(got, wide.wide_dense_plain(x, w, izp=izp))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(1, 2048, 1000), (49, 4608, 512), (8, 147, 64), (300, 72, 200)])
def test_w8a16_gemm_at_every_plan_on_card(rng, cuda, mkn):
    """`qgemm_wide` at every tile and split of K (`wide_plans`: the split
    path's 64-bit atomics at M 1 and 49) == plain."""
    from tachikoma_tpu_torch.ops.kernels import wide

    m, k, n = mkn
    x = torch.from_numpy(_i16(rng, (m, k))).to(cuda)
    w = _dev(rng, (k, n), cuda)
    want = wide.qgemm_wide_plain(x, w, izp=-77)
    for plan in wide.wide_plans(k):
        got = wide.qgemm_wide(x, w, izp=-77, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


@pytest.mark.cuda
def test_w8a16_conv_at_every_plan_on_card(rng, cuda):
    """`qconv_wide` at every tile and split of K on the b1 trace's 7^2 3x3
    call and a CIN-3 stem == plain."""
    from tachikoma_tpu_torch.ops.kernels import wide

    for xs, ws, strides, padding in (((1, 7, 7, 512), (3, 3, 512, 512), (1, 1), (1, 1, 1, 1)),
                                     ((1, 30, 30, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3))):
        x = torch.from_numpy(_i16(rng, xs)).to(cuda)
        w = _dev(rng, ws, cuda)
        kw = dict(strides=strides, padding=padding, izp=12345)
        want = wide.qconv_wide_plain(x, w, **kw)
        for plan in wide.wide_plans(ws[0] * ws[1] * ws[2]):
            got = wide.qconv_wide(x, w, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (xs, plan)


@pytest.mark.cuda
def test_w8a16_planes_exact_near_the_k_bound_and_raise_past_it(cuda):
    """At K = K_BOUND the worst case fills the lo plane's int32 sum to
    -2^31 + 128 * 255 ... (x = -1: lo 255, w = -128) and, beside it, x - izp
    = -65535 on every term; unsplit and split; one term more raises."""
    from tachikoma_tpu_torch.ops.kernels import wide

    k = wide.K_BOUND
    w = torch.full((k, 2), -128, dtype=torch.int8, device=cuda)
    steps = -(-k // 64)
    for xv, izp in ((-1, 0), (-2 ** 15, 2 ** 15 - 1), (255, -256)):
        for m, plan in ((1, None), (128, None), (64, dict(bm=64, bn=64, ks=1, kper=steps))):
            x = torch.full((m, k), xv, dtype=torch.int16, device=cuda)
            got = wide.qgemm_wide(x, w, izp=izp, plan=plan)
            torch.cuda.synchronize()
            assert bool((got == (xv - izp) * -128 * k).all()), (xv, izp, m, plan)
    x = torch.zeros((1, 3, 3, 7400), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="above 65793"):
        wide.wide_conv(x, torch.zeros((3, 3, 7400, 4), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="above 65793"):
        wide.wide_dense(torch.zeros((1, k + 1), dtype=torch.int16, device=cuda),
                        torch.zeros((k + 1, 4), dtype=torch.int8, device=cuda))


@pytest.mark.cuda
def test_w8a16_depthwise_exact_at_its_tap_bound_and_raise_past_it(cuda):
    """K5's int16 mode at DW_TAP_BOUND = 256 taps (16 x 16), every term
    (x - izp) w = 65535 * 128: the int32 sum at 2^31 - 32768; 257 taps
    raise."""
    from tachikoma_tpu_torch.ops.kernels import wide

    taps = wide.DW_TAP_BOUND
    assert taps == 256
    x = torch.full((2, 16, 16, 24), -2 ** 15, dtype=torch.int16, device=cuda)
    w = torch.full((16, 16, 1, 24), -128, dtype=torch.int8, device=cuda)
    before = _lib.LAUNCHES["qdwconv_wide"]
    got = wide.wide_conv(x, w, groups=24, izp=2 ** 15 - 1)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qdwconv_wide"] == before + 1
    assert got.shape == (2, 1, 1, 24) and bool((got == 65535 * 128 * taps).all())
    assert torch.equal(got, wide.wide_conv_plain(x, w, groups=24, izp=2 ** 15 - 1))
    with pytest.raises(ValueError, match="K 257 is above 256"):
        wide.wide_conv(torch.zeros((1, 1, 257, 8), dtype=torch.int16, device=cuda),
                       torch.zeros((1, 257, 1, 8), dtype=torch.int8, device=cuda), groups=8)


@pytest.mark.cuda
def test_w8a16_int16_products_launch_no_k4_k5(rng, cuda):
    """A W8A16 ResNet-18 b2 32^2 forward on the card: every int16 product on
    qgemm_wide / qconv_wide, no K4 / K5 launch, == the CPU path."""
    from tachikoma_tpu_torch.quantize.config import W8A16

    g = resnet(18, batch_size=2, image_size=32, seed=0)
    calib = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    q = quantize(g, [calib], W8A16)
    names = computational_nodes(q)
    wide_names = ("qgemm_wide", "qconv_wide", "qdwconv_wide")
    for k in K4_K5 + wide_names:
        _lib.LAUNCHES[k] = 0
    card = TorchExecutor(q, capture=names, device="cuda").run(calib)
    assert all(_lib.LAUNCHES[k] == 0 for k in K4_K5)
    n_products = sum(q[n].op in ("qnn.conv2d", "qnn.dense") for n in names)
    assert _lib.LAUNCHES["qgemm_wide"] + _lib.LAUNCHES["qconv_wide"] == n_products
    assert _lib.LAUNCHES["qgemm_wide"] > 0 and _lib.LAUNCHES["qconv_wide"] > 0
    cpu = TorchExecutor(q, capture=names, device="cpu").run(calib)
    for nm, a, b in zip(names, card, cpu):
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=nm)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_w8a16_wide_requantize_on_card_equals_cpu(rng, cuda, per_channel, rounding):
    from tachikoma_tpu_torch.ops import fixed_point as fp

    x = rng.integers(-2 ** 45, 2 ** 45, (4, 7, 7, 64)).astype(np.int64)
    x.reshape(-1)[:4] = [2 ** 45, -(2 ** 45), 0, -1]
    scale = rng.uniform(1e-8, 3e-6, 64).astype(np.float32) if per_channel else 1.7e-6
    args = (scale, -3, 0.0021, 5)
    kw = dict(axis=3, rounding=rounding, out_dtype="int16")
    got = fp.requantize(torch.from_numpy(x).to(cuda), *args, **kw)
    want = fp.requantize(torch.from_numpy(x), *args, **kw)
    assert got.dtype == torch.int16 and torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), fp.requantize_np(x, *args, **kw))
    ms = rng.integers(1 << 30, (1 << 31) - 1, 64)
    shifts = rng.integers(-40, 2, 64)
    got = fp.q_multiply_shift_wide_per_axis(torch.from_numpy(x).to(cuda), ms, shifts, 3, rounding)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  fp.q_multiply_shift_wide_per_axis_np(x, ms, shifts, 3, rounding))


# ---------------------------------------------------------------------------
# W8A16 beyond the plain CNN: int16 x int16 batched products into int64 on
# qbmm_wide (csrc/qbmm_wide_hopper.cu), qconv_wide dilated and grouped, and
# qdwconv_wide dilated (`-k "w8a16_bmm or w8a16_geometry or w8a16_families"`)
# ---------------------------------------------------------------------------

# (B, S, H, D) of the attention's q / k / v views: BERT-base b4 s128, ViT-B/16
# b1 224^2 (S 197: 394-byte rows), GPT-2 small b1 s128, a ragged one
W8A16_ATTENTION = [(4, 128, 12, 64), (1, 197, 12, 64), (1, 128, 12, 64), (2, 37, 3, 40)]


def _qkv16(rng, b, s, h, d, device):
    """q, k, v as a fused projection's head-split views: (B, H, S, D), each
    a strided view of one (B, S, 3, H, D) int16 tensor."""
    qkv = torch.from_numpy(_i16(rng, (b, s, 3, h, d))).to(device)
    return tuple(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("zps", [(0, 0), (-300, 12345), (-32768, 32767)])
@pytest.mark.parametrize("shape", W8A16_ATTENTION, ids=["bert", "vit", "gpt2", "ragged"])
def test_w8a16_bmm_on_card_equals_plain(rng, cuda, shape, zps):
    """The scores q . k^T (k read in place, transpose_b) and the context p .
    v (p contiguous, v N-major), each one qbmm_wide launch == the float64
    plain version, no operand copied but ViT's (none: its 197-element rows
    are read by element loads)."""
    from tachikoma_tpu_torch.ops.kernels import wide

    b, s, h, d = shape
    q, k, v = _qkv16(rng, b, s, h, d, cuda)
    p = torch.from_numpy(_i16(rng, (b, h, s, s))).to(cuda)
    za, zb = zps
    for a_, b_, tb in ((q, k, True), (p, v, False)):
        kw = dict(lhs_zero_point=za, rhs_zero_point=zb, transpose_b=tb)
        before = _lib.LAUNCHES["qbmm_wide"]
        got = wide.qbmm_wide(a_, b_, **kw)
        torch.cuda.synchronize()
        assert _lib.LAUNCHES["qbmm_wide"] == before + 1
        want = wide.qbmm_wide_plain(a_, b_, **kw)
        assert got.dtype == torch.int64 and got.shape == want.shape
        assert torch.equal(got, want), (shape, zps, tb)
        assert torch.equal(got.cpu(), wide.qbmm_wide(a_.cpu(), b_.cpu(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((3, 5, 13), (3, 13, 7), False, False, "int16", "int16"),
    ((2, 9, 70), (2, 9, 65), True, False, "int16", "int16"),
    ((70, 9), (4, 65, 70), True, True, "int16", "int16"),
    ((2, 1, 100, 64), (1, 3, 64, 129), False, False, "int16", "int16"),
    ((2, 33, 200), (2, 200, 33), False, False, "int8", "int16"),
    ((2, 33, 200), (2, 31, 200), False, True, "uint8", "int8"),
], ids=["odd", "transpose_a", "both", "broadcast", "int8_int16", "uint8_int8"])
def test_w8a16_bmm_layouts_on_card_equal_plain(rng, cuda, case):
    """Transposes, broadcast batch axes, ragged tiles and int8 / uint8
    operands (widened by the wrapper) == plain."""
    from tachikoma_tpu_torch.ops.kernels import wide

    ash, bsh, ta, tb, adt, bdt = case
    lo = {"int8": (-128, 128), "uint8": (0, 256), "int16": (-2 ** 15, 2 ** 15)}
    a = torch.from_numpy(rng.integers(*lo[adt], ash).astype(adt)).to(cuda)
    b = torch.from_numpy(rng.integers(*lo[bdt], bsh).astype(bdt)).to(cuda)
    for za, zb in ((0, 0), (17, -5), (-128 if adt == "int8" else 128, 0)):
        kw = dict(lhs_zero_point=za, rhs_zero_point=zb, transpose_a=ta, transpose_b=tb)
        got = wide.qbmm_wide(a, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, wide.qbmm_wide_plain(a, b, **kw)), (case, za, zb)


@pytest.mark.cuda
def test_w8a16_bmm_exact_at_the_k_bound_and_raise_past_it(cuda):
    """At K = BMM_K_BOUND with a = b = -128 * 256 + 255 (hi -128, lo 255)
    the middle int32 sum reaches -2^31 + 32,767 and the lo sum 2^31 -
    8,421,247: the result is exact; with zero points 255 and -3 too; one k
    more raises."""
    from tachikoma_tpu_torch.ops.kernels import wide

    k = wide.BMM_K_BOUND
    val = -128 * 256 + 255
    a = torch.full((2, 3, k), val, dtype=torch.int16, device=cuda)
    b = torch.full((2, k, 5), val, dtype=torch.int16, device=cuda)
    for za, zb in ((0, 0), (255, -3)):
        got = wide.qbmm_wide(a, b, lhs_zero_point=za, rhs_zero_point=zb)
        torch.cuda.synchronize()
        assert bool((got == k * (val - za) * (val - zb)).all()), (za, zb)
    with pytest.raises(ValueError, match="above 32896"):
        wide.qbmm_wide(torch.zeros((1, 1, k + 1), dtype=torch.int16, device=cuda),
                       torch.zeros((1, k + 1, 1), dtype=torch.int16, device=cuda))


W8A16_GEOMETRY = [
    # (x shape, weight shape, strides, padding, dilation, groups):
    # DeepLabV3-ResNet-50 b1 520^2 at output stride 8 (65^2 maps): layer3's d2
    # 3x3 at 256, layer4's d4 at 512, the ASPP's 2048 -> 256 at d12 / d36;
    # ResNeXt-50 32x4d's grouped 3x3 (32 groups of 4 / 16 / 32 channels, s2
    # on the first of a stage); the atrous depthwise calls of DeepLab-
    # MobileNetV2 (384 at d2, 960 at d4); a ragged dilated grouped conv
    ((1, 65, 65, 256), (3, 3, 256, 256), (1, 1), (2,) * 4, (2, 2), 1),
    ((1, 65, 65, 512), (3, 3, 512, 512), (1, 1), (4,) * 4, (4, 4), 1),
    ((1, 65, 65, 2048), (3, 3, 2048, 256), (1, 1), (12,) * 4, (12, 12), 1),
    ((1, 65, 65, 2048), (3, 3, 2048, 256), (1, 1), (36,) * 4, (36, 36), 1),
    ((2, 56, 56, 128), (3, 3, 4, 128), (1, 1), (1,) * 4, (1, 1), 32),
    ((2, 56, 56, 512), (3, 3, 16, 512), (2, 2), (1,) * 4, (1, 1), 32),
    ((2, 14, 14, 1024), (3, 3, 32, 1024), (1, 1), (1,) * 4, (1, 1), 32),
    ((1, 65, 65, 384), (3, 3, 1, 384), (1, 1), (2,) * 4, (2, 2), 384),
    ((1, 65, 65, 960), (3, 3, 1, 960), (1, 1), (4,) * 4, (4, 4), 960),
    ((2, 19, 23, 24), (3, 3, 6, 64), (2, 1), (3, 2, 3, 2), (3, 2), 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("izp", [0, -32768, 1234])
@pytest.mark.parametrize("case", W8A16_GEOMETRY,
                         ids=[f"geometry{i}" for i in range(len(W8A16_GEOMETRY))])
def test_w8a16_geometry_on_card_equals_plain(rng, cuda, case, izp):
    """A dilated or grouped int16 conv runs on qconv_wide (a grouped one as
    super-groups on block-diagonal weights), a dilated depthwise one on
    qdwconv_wide; one launch, no K4 / K5 launch, == the float64 plain
    version and the CPU path."""
    from tachikoma_tpu_torch.ops.kernels import wide

    xs, ws, strides, padding, dilation, groups = case
    x = torch.from_numpy(_i16(rng, xs)).to(cuda)
    w = _dev(rng, ws, cuda)
    kw = dict(strides=strides, padding=padding, dilation=dilation, groups=groups, izp=izp)
    name = _wide_kernel(xs, ws, strides, padding, groups)
    before = dict(_lib.LAUNCHES)
    got = wide.wide_conv(x, w, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES[name] == before.get(name, 0) + 1
    assert all(_lib.LAUNCHES[k] == before.get(k, 0) for k in K4_K5)
    assert got.dtype == torch.int64 and torch.equal(got, wide.wide_conv_plain(x, w, **kw))
    if izp == 0 and xs[0] * xs[1] * xs[2] * ws[3] < 2 ** 18:  # the CPU path, where it is quick
        assert torch.equal(got.cpu(), wide.wide_conv(x.cpu(), w.cpu(), **kw))


@pytest.mark.cuda
def test_w8a16_geometry_at_every_plan_on_card(rng, cuda):
    """`qconv_wide` dilated and grouped at every tile and split of K that
    keeps a tile in one super-group == plain; a 128-column tile on a
    64-column super-group raises."""
    from tachikoma_tpu_torch.ops.kernels import wide

    for xs, ws, padding, dilation, groups in (
            ((1, 9, 9, 512), (3, 3, 512, 128), (2,) * 4, (2, 2), 1),
            ((1, 14, 14, 256), (3, 3, 8, 256), (1,) * 4, (1, 1), 32)):
        x = torch.from_numpy(_i16(rng, xs)).to(cuda)
        w = _dev(rng, ws, cuda)
        kw = dict(padding=padding, dilation=dilation, groups=groups, izp=-99)
        want = wide.qconv_wide_plain(x, w, **kw)
        span = 64 // (ws[3] // groups) if groups > 1 else 1
        for plan in wide.wide_plans(9 * ws[2] * span):
            if groups > 1 and plan["bn"] != wide.GROUPED_BN:
                with pytest.raises(ValueError, match="whole 128-column tiles"):
                    wide.qconv_wide(x, w, plan=plan, **kw)
                continue
            got = wide.qconv_wide(x, w, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (xs, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["bert", "vit"])
def test_w8a16_families_forward_on_card(rng, cuda, model):
    """A tiny W8A16 BERT and ViT on the card: every qnn.batch_matmul on
    qbmm_wide, every other product on qgemm_wide / qconv_wide, no K1 / K4
    launch; every node held to the CPU path as runtime/crosscheck.py holds
    a float op's cone (the card's softmax and tanh round in their own way),
    floats within the card's rtol 1e-4, atol 1e-4."""
    from tachikoma_tpu_torch.quantize.config import W8A16
    from tachikoma_tpu_torch.runtime.crosscheck import hold_node_level

    if model == "bert":
        g = bert(batch_size=2, seq_len=32, hidden=64, layers=2, heads=4, ffn_dim=128,
                 vocab=100, seed=3)
        mk = lambda: rng.integers(0, 100, (2, 32)).astype(np.int32)  # noqa: E731
    else:
        g = vit(batch_size=2, image_size=32, patch=8, hidden=64, layers=2, heads=4,
                ffn_dim=128, num_classes=10, seed=5)
        mk = lambda: rng.standard_normal((2, 32, 32, 3)).astype(np.float32)  # noqa: E731
    q = quantize(g, [mk()], W8A16)
    x = mk()
    names = computational_nodes(q)
    kernels = ("qbmm_wide", "qgemm_wide", "qconv_wide", "qbmm_raw", "qgemm_raw", "qconv_raw")
    for k in kernels:
        _lib.LAUNCHES[k] = 0
    card = TorchExecutor(q, capture=names, device="cuda").run(x)
    ops = [q[n].op for n in names]
    assert _lib.LAUNCHES["qbmm_wide"] == ops.count("qnn.batch_matmul") == 4
    assert (_lib.LAUNCHES["qgemm_wide"] + _lib.LAUNCHES["qconv_wide"]
            == ops.count("qnn.dense") + ops.count("qnn.conv2d"))
    assert not any(_lib.LAUNCHES[k] for k in ("qbmm_raw", "qgemm_raw", "qconv_raw"))
    cpu = TorchExecutor(q, capture=names, device="cpu").run(x)
    counts, _ = hold_node_level(q, names, card, cpu, {q.inputs[0].name: x}, 1e-4, 1e-4)
    assert counts["int"] > 10


def _fixture(name):
    import os

    return os.path.join(os.path.dirname(__file__), "fixtures", name)


@pytest.mark.cuda
def test_tflite_mobilenet_b16_fused_on_card_equals_cpu(cuda):
    """The exporter's int8 MobileNetV2 at b16 (every conv at a nonzero
    input zero point): K1, K2 and K5 launched, every node == the CPU path,
    within one quantum of the interpreter, top-1 16 of 16."""
    from tachikoma_tpu_torch.frontend import from_tflite

    batch = np.load(_fixture("mobilenet_v2_int8_batch.npz"))
    xs, ys = batch["x"], batch["y"]
    path = _fixture("mobilenet_v2_int8.tflite")
    name = from_tflite(path).inputs[0].name
    g = fuse_qnn(from_tflite(path, {name: xs.shape}, integer_lut=False))
    names = computational_nodes(g)
    for k in ("qgemm_rq", "qconv_rq", "qdwconv_rq"):
        _lib.LAUNCHES[k] = 0
    card = TorchExecutor(g, capture=names, device="cuda").run(xs)
    assert (_lib.LAUNCHES["qgemm_rq"], _lib.LAUNCHES["qconv_rq"],
            _lib.LAUNCHES["qdwconv_rq"]) == (35, 1, 17)
    cpu = TorchExecutor(g, capture=names, device="cpu").run(xs)
    for nm, a, b in zip(names, card, cpu):
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=nm)
    out = card[names.index(g.outputs[0])]
    assert np.abs(out.astype(np.int32) - ys.astype(np.int32)).max() <= 1
    assert (out.argmax(-1) == ys.argmax(-1)).sum() == 16


@pytest.mark.cuda
def test_tflite_16x8_on_card_equals_cpu(cuda):
    from tachikoma_tpu_torch.frontend import from_tflite

    io_ = np.load(_fixture("small_cnn_16x8_io.npz"))
    g = from_tflite(_fixture("small_cnn_16x8.tflite"))
    names = computational_nodes(g)
    wide_names = ("qgemm_wide", "qconv_wide", "qdwconv_wide")
    for k in K4_K5 + wide_names:
        _lib.LAUNCHES[k] = 0
    card = TorchExecutor(g, capture=names, device="cuda").run(io_["x"])
    # 4 qnn.conv2d (the CIN-3 3x3 and the 3x3 s2, a 1x1, a depthwise) + 1 qnn.dense
    assert [_lib.LAUNCHES[k] for k in wide_names] == [2, 2, 1]
    assert all(_lib.LAUNCHES[k] == 0 for k in K4_K5)
    cpu = TorchExecutor(g, capture=names, device="cpu").run(io_["x"])
    for nm, a, b in zip(names, card, cpu):
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=nm)
    assert np.abs(card[names.index(g.outputs[0])] - io_["y"]).max() <= 1.0 / (1 << 15) + 1e-9


# ---------------------------------------------------------------------------
# the ONNX import path on the card: the importer's 53 ops against their CPU
# torch impls, the six exporters' fixtures and ResNet-50 as torch.onnx.export
# writes it, fused on K1-K3 (`-k onnx`)
# ---------------------------------------------------------------------------

from onnx_op_cases import CASES as ONNX_OP_CASES  # noqa: E402  (tests/, no jax)

ONNX_FIXTURES = ("paddle_route", "oneflow_route", "caffe_route", "coreml_route",
                 "darknet_route", "mxnet_lenet")
OP_RTOL, OP_ATOL = 1e-5, 1e-6      # a float op on the card against its CPU torch impl


def op_on_card_and_cpu(op, inputs, attrs, device):
    """The op's torch impl on the card and on the CPU, on the same inputs;
    each result a list of host arrays."""
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    impl = get_op(op).torch_impl
    node = Node("y", op, tuple(f"x{i}" for i in range(len(inputs))), attrs)

    def listed(v):
        return [t.cpu().numpy() for t in (v if isinstance(v, list) else [v])]

    card = listed(impl(*(torch.from_numpy(x).to(device) for x in inputs), node=node))
    return card, listed(impl(*map(torch.from_numpy, inputs), node=node))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ONNX_OP_CASES, ids=[c[0] for c in ONNX_OP_CASES])
def test_onnx_op_on_card_equals_cpu(cuda, case):
    """Integers, indices, bools and the exact float ops (tol EXACT) ==; the
    float ops that round or sum in another order within rtol 1e-5, atol
    1e-6."""
    _, op, inputs, attrs, tol, _, _, _ = case
    card, cpu = op_on_card_and_cpu(op, inputs, attrs, cuda)
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype and a.shape == b.shape
        if tol is True or b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.cuda
def test_onnx_index_out_of_range_raises_on_card(cuda):
    """An index out of range raises on the host, as numpy's does, and never
    reaches a device-side assert (the context stays usable)."""
    card, _ = op_on_card_and_cpu("gather", [np.zeros((3, 2), np.float32),
                                            np.array([[1, 0]], np.int64)], {"axis": 0}, cuda)
    with pytest.raises(IndexError):
        op_on_card_and_cpu("gather", [np.zeros((3, 2), np.float32),
                                      np.array([[3, 0]], np.int64)], {"axis": 0}, cuda)
    with pytest.raises(IndexError):
        op_on_card_and_cpu("scatter_nd", [np.zeros((3, 2), np.int32), np.array([[-4]], np.int64),
                                          np.ones((1, 2), np.int32)], {}, cuda)
    assert torch.zeros(1, device=cuda).item() == 0


@contextlib.contextmanager
def _recorded(calls, names=("qgemm_rq", "qconv_rq", "qconv_rq_res")):
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod
    from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm_mod

    mods = {"qgemm_rq": mm_mod, "qconv_rq": conv_mod, "qconv_rq_res": conv_mod}
    saved = [(mods[n], n, getattr(mods[n], n)) for n in names]
    for mod, n, fn in saved:
        setattr(mod, n, lambda *a, _fn=fn, _n=n, **k: (calls.append((_n, a, k)), _fn(*a, **k))[1])
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


@pytest.mark.cuda
def test_onnx_resnet50_b2_64_fused_on_card_equals_cpu(cuda):
    """ResNet-50 written as torch.onnx.export writes it, imported, quantized
    and fused (14 tk.conv2d_rq, 1 tk.conv2d_chain, 4 tk.conv2d_block_stack,
    1 tk.dense_rq): every K1, K2 and K3 call of a forward == its plain
    version, every integer node == the CPU path."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.models.onnx_resnet import resnet50_onnx
    from tachikoma_tpu_torch.ops.kernels.conv import qconv_rq_plain, qconv_rq_res_plain
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qgemm_rq_plain

    rng = np.random.default_rng(0)
    g = from_onnx(resnet50_onnx(2, 64))
    xs = [rng.standard_normal((2, 3, 64, 64)).astype(np.float32) for _ in range(2)]
    fused = fuse_qnn(quantize(g, [xs[0]]))
    ops = [n.op for n in fused.nodes]
    assert [ops.count(o) for o in ("tk.conv2d_rq", "tk.conv2d_chain", "tk.conv2d_block_stack",
                                   "tk.dense_rq")] == [14, 1, 4, 1]
    names = computational_nodes(fused)
    calls = []
    for k in ("qgemm_rq", "qconv_rq", "qconv_rq_res"):
        _lib.LAUNCHES[k] = 0
    with _recorded(calls):
        card = TorchExecutor(fused, capture=names, device="cuda").run(xs[1])
    assert all(_lib.LAUNCHES[k] > 0 for k in ("qgemm_rq", "qconv_rq", "qconv_rq_res"))
    plain = {"qgemm_rq": qgemm_rq_plain, "qconv_rq": qconv_rq_plain,
             "qconv_rq_res": qconv_rq_res_plain}
    for name, a, k in calls:
        assert torch.equal(_kernel(name)(*a, **k), plain[name](*a, **k)), name
    cpu = TorchExecutor(fused, capture=names, device="cpu").run(xs[1])
    for nm, a, b in zip(names, card, cpu):
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=nm)


def _kernel(name):
    from tachikoma_tpu_torch.ops.kernels import conv as conv_mod
    from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm_mod

    return getattr(mm_mod if name == "qgemm_rq" else conv_mod, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONNX_FIXTURES)
def test_onnx_fixture_on_card_equals_cpu(cuda, name):
    """Float: within rtol 1e-4, atol 1e-4 of the exporter's expected output
    (tests/test_frontend_onnx_routes.py:40) and of the CPU path.  Int8 and
    fused: every integer node == the CPU path, or, where a float op of
    runtime/crosscheck.py FLOAT_SOURCES reaches it, == its own op's CPU impl
    on the card's inputs."""
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.runtime.crosscheck import hold_node_level

    io_ = np.load(_fixture(f"{name}_io.npz"))
    x, expected = io_["x"], io_["expected"]
    g = from_onnx(_fixture(f"{name}.onnx"))
    card = TorchExecutor(g, device="cuda").run([x])[0]
    np.testing.assert_allclose(card, expected, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card, TorchExecutor(g, device="cpu").run([x])[0], rtol=1e-4,
                               atol=1e-4)
    fused = fuse_qnn(quantize(g, [x]))
    names = computational_nodes(fused)
    on_card = TorchExecutor(fused, capture=names, device="cuda").run([x])
    on_cpu = TorchExecutor(fused, capture=names, device="cpu").run([x])
    counts, _ = hold_node_level(fused, names, on_card, on_cpu, {fused.inputs[0].name: x},
                                1e-4, 1e-4)
    assert counts["int"] + counts["cone_int"] > 0


# ---------------------------------------------------------------------------
# the PyTorch import path and FQ2I: the torch.ao models of
# tests/test_torch_quantized.py (tests/torch_import_cases.py), the torch.ao
# ResNet-50 of models/torch_resnet.py, the zero points torch's quint8 gives
# K2 and K3 (the stem's input zero point, the residual add's own scale and
# zero point -128), the float module through from_torch, FQ2I'd QDQ models
# ---------------------------------------------------------------------------

from torch_import_cases import QDQ_CASES, TORCH_AO_CASES, torch_ao_case  # noqa: E402

RQ_KERNELS = ("qgemm_rq", "qconv_rq", "qconv_rq_res")


def _fused_on_card_equals_cpu(fused, x):
    """Every K1/K2/K3 call of one forward == plain (their launches counted),
    every node held against the CPU path (runtime/crosscheck.py's rule);
    returns the kernels that launched."""
    from tachikoma_tpu_torch.runtime.crosscheck import hold_node_level

    names = computational_nodes(fused)
    calls = []
    for k in RQ_KERNELS:
        _lib.LAUNCHES[k] = 0
    with _recorded(calls):
        card = TorchExecutor(fused, capture=names, device="cuda").run(x)
    launched = {k for k in RQ_KERNELS if _lib.LAUNCHES[k] > 0}
    assert launched == {name for name, _, _ in calls}
    plain = {"qgemm_rq": qgemm_rq_plain, "qconv_rq": qconv_rq_plain,
             "qconv_rq_res": qconv_rq_res_plain}
    for name, a, k in calls:
        assert torch.equal(_kernel(name)(*a, **k), plain[name](*a, **k)), name
    cpu = TorchExecutor(fused, capture=names, device="cpu").run(x)
    hold_node_level(fused, names, card, cpu, {fused.inputs[0].name: x}, 1e-4, 1e-4)
    return launched


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TORCH_AO_CASES))
def test_torch_ao_model_fused_on_card_equals_cpu(cuda, case):
    from tachikoma_tpu_torch.frontend.torch_quantized import import_torch_quantized

    mq, shape = torch_ao_case(case)
    fused = fuse_qnn(import_torch_quantized(mq, {"x": shape}))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    assert _fused_on_card_equals_cpu(fused, x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (8, 224, 224, 3)])
@pytest.mark.parametrize("izp", [-63, -65, -128])
def test_k2_stem_7x7_s2_at_torch_zero_points(rng, cuda, shape, izp):
    """torch.ao ResNet-50's stem: 7x7 s2 pad 3 at input zero point -63 (the
    b2 224^2 calibration's, -65 at 32^2): the taps outside the image are the
    zero point, not 0; output zero point -128 (quint8's 0)."""
    x, w = _dev(rng, shape, cuda), _dev(rng, (7, 7, 3, 64), cuda)
    b, mult, shift = _epilogue_args(rng, 64, cuda)
    kw = dict(strides=(2, 2), padding=(3, 3, 3, 3), izp=izp, out_zp=-128, rounding="UPWARD")
    got = qconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_plain(x, w, b, mult, shift, **kw))
    # the border: every tap outside the image at the zero point sums to 0
    xz = torch.full_like(x, izp)
    assert torch.equal(qconv_rq(xz, w, b, mult, shift, **kw),
                       qconv_rq_plain(xz, w, b, mult, shift, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_R50_CASES)
@pytest.mark.parametrize("blocks", TILE_BLOCKS)
def test_k3_at_torch_add_relu_params(rng, cuda, case, blocks):
    """A block stack's residual add as torch's quantized::add_relu gives it:
    its own output scale, every zero point in quint8's domain shifted by
    -128 (the branch's -58-ish, the shortcut's and the output's -128) and
    the ReLU a clip at the output zero point."""
    shape, k, cout = case
    x, w = _dev(rng, shape, cuda), _dev(rng, (k, k, shape[3], cout), cuda)
    res = _dev(rng, shape[:3] + (cout,), cuda)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    rp = dict(lhs_scale=0.2522, lhs_zero_point=-58, rhs_scale=0.3336, rhs_zero_point=-128,
              output_scale=0.3548, output_zero_point=-128, rounding="UPWARD", a_min=-128,
              a_max=127)
    kw = dict(izp=-128, rq_izp=0, out_zp=-58, rounding="UPWARD")
    got = qconv_rq_res(x, w, b, mult, shift, res, rp, blocks=blocks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qconv_rq_res_plain(x, w, b, mult, shift, res, rp, **kw))


@pytest.fixture(scope="module")
def torch_r50():
    from tachikoma_tpu_torch.models.torch_resnet import quantize_fx, resnet50_torch

    m = resnet50_torch()
    return m, quantize_fx(m, (2, 3, 64, 64))


@pytest.mark.cuda
def test_torch_ao_resnet50_b2_64_fused_on_card_equals_cpu(cuda, torch_r50):
    """The torch.ao-quantized ResNet-50 fused to native's form (14 / 1 / 4 /
    1) at its own zero points: every K1/K2/K3 call == plain, every node ==
    the CPU path (the int8 max pool's padding and the int8 mean included)."""
    from tachikoma_tpu_torch.frontend.torch_quantized import import_torch_quantized

    _, mq = torch_r50
    fused = fuse_qnn(import_torch_quantized(mq, {"x": (2, 3, 64, 64)}))
    ops = [n.op for n in fused.nodes]
    assert [ops.count(o) for o in ("tk.conv2d_rq", "tk.conv2d_chain", "tk.conv2d_block_stack",
                                   "tk.dense_rq")] == [14, 1, 4, 1]
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    assert _fused_on_card_equals_cpu(fused, x) == set(RQ_KERNELS)


@pytest.mark.cuda
def test_torch_ao_resnet50_b1_64_unfused_on_card_equals_cpu(cuda, torch_r50):
    """Unfused (the trace path's graph): K4 at every qnn.conv2d / qnn.dense
    == plain, every integer node == the CPU path."""
    from tachikoma_tpu_torch.frontend.torch_quantized import import_torch_quantized

    _, mq = torch_r50
    g = import_torch_quantized(mq, {"x": (1, 3, 64, 64)})
    x = np.random.default_rng(3).standard_normal((1, 3, 64, 64)).astype(np.float32)
    names = computational_nodes(g)
    card = TorchExecutor(g, capture=names, device="cuda").run(x)
    cpu = TorchExecutor(g, capture=names, device="cpu").run(x)
    for nm, a, b in zip(names, card, cpu):
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=nm)


@pytest.mark.cuda
def test_torch_float_resnet50_on_card_equals_torch_eager(cuda, torch_r50):
    """from_torch of the float module: the card within rtol 1e-4 and atol
    2.5e-3 (chip_smoke.py R50_FLOAT_ATOL: float32's error at the pooled
    features' scale of 10^3) of torch eager on the card (TF32 off) and of the
    CPU path."""
    from tachikoma_tpu_torch.frontend import from_torch

    m, _ = torch_r50
    g = from_torch(m, {"x": (2, 3, 64, 64)})
    x = np.random.default_rng(4).standard_normal((2, 3, 64, 64)).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = m.to(cuda)(torch.from_numpy(x).to(cuda)).cpu().numpy()
    finally:
        m.cpu()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    got = TorchExecutor(g, device="cuda").run(x)[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.5e-3)
    np.testing.assert_allclose(got, TorchExecutor(g, device="cpu").run(x)[0], rtol=1e-4,
                               atol=2.5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(QDQ_CASES))
def test_fq2i_qdq_model_on_card_equals_cpu(cuda, case):
    from tachikoma_tpu_torch.frontend import from_onnx
    from tachikoma_tpu_torch.quantize.fq2i import fq2i

    model, shape = QDQ_CASES[case](np.random.default_rng(0))
    fused = fuse_qnn(fq2i(from_onnx(model)))
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    assert _fused_on_card_equals_cpu(fused, x) == {"qgemm_rq" if case == "qlinear_matmul"
                                                    else "qconv_rq"}


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.5, 3.0)])
def test_upsampling_and_silu_on_card_equals_cpu(cuda, scale):
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    x = np.random.default_rng(6).standard_normal((2, 5, 7, 16)).astype(np.float32)
    node = Node("y", "nn.upsampling", ("x",), {"scale_h": scale[0], "scale_w": scale[1]})
    for v in (x, (x * 40).astype(np.int8)):
        impl = get_op("nn.upsampling").torch_impl
        got = impl(torch.from_numpy(v).to(cuda), node=node).cpu()
        assert torch.equal(got, impl(torch.from_numpy(v), node=node))
    silu = get_op("nn.silu").torch_impl
    node = Node("y", "nn.silu", ("x",), {})
    np.testing.assert_allclose(silu(torch.from_numpy(x).to(cuda), node=node).cpu().numpy(),
                               silu(torch.from_numpy(x), node=node).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_eval_topk_on_card_equals_cpu(cuda, torch_r50):
    """accuracy.eval_topk's "torch" backend on the card gives the CPU's
    agreements (integer logits ==, the float graph's argmax on 8 images)."""
    from tachikoma_tpu_torch.frontend import from_torch
    from tachikoma_tpu_torch.frontend.torch_quantized import import_torch_quantized
    from tachikoma_tpu_torch.quantize.accuracy import eval_topk
    from tachikoma_tpu_torch.quantize.dataset import Dataset, synthetic_images

    m, mq = torch_r50
    gf = from_torch(m, {"x": (2, 3, 64, 64)})
    gq = fuse_qnn(import_torch_quantized(mq, {"x": (2, 3, 64, 64)}))
    ds = synthetic_images(8, (64, 64, 3), seed=0)
    ds = Dataset(np.ascontiguousarray(ds.data.transpose(0, 3, 1, 2)), None, ds.name)
    card = eval_topk(gf, gq, ds, device="cuda")
    assert card.row() == eval_topk(gf, gq, ds, device="cpu").row()
    assert card.n == 8


# ---------------------------------------------------------------------------
# the segmented, bucketed and placed executors on the card
# ---------------------------------------------------------------------------

def _tied_gpt2():
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8_SCAN

    g = gpt2(batch_size=1, seq_len=16, hidden=64, layers=6, heads=4, ffn_dim=128, vocab=96,
             seed=1)
    x = np.random.default_rng(0).integers(0, 96, (1, 16)).astype(np.int32)
    return fuse_qnn(quantize(g, [x], TRANSFORMER_INT8_SCAN)), x


@pytest.mark.cuda
def test_segmented_scan_on_card_equals_cpu(cuda):
    """A tied int8 GPT-2 scanned over its stacked layers on the card == the
    CPU path and the whole-graph executor (==), twice, on two inputs: K1's
    K-major packing is made once per layer view and never again; the scan
    member's weights are not copied besides the stacks."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.runtime.segmented import SegmentedExecutor

    f, x = _tied_gpt2()
    ex = SegmentedExecutor(f, min_ops=16, max_ops=120, device="cuda")
    assert ex.scan_runs == [(1, 5, 0)] and ex.n_programs == 3
    cpu = SegmentedExecutor(f, min_ops=16, max_ops=120, device="cpu")
    whole = TorchExecutor(f, device="cuda")
    whole.run(x)  # packs its own weights K-major before the count below
    for step, xs in enumerate((x, (x + 7) % 96)):
        before = _lib.LAUNCHES["qgemm_rq"], _lib.LAUNCHES["qbmm_rq"]
        got = ex.run(xs)
        assert _lib.LAUNCHES["qgemm_rq"] > before[0] and _lib.LAUNCHES["qbmm_rq"] > before[1]
        if step == 0:
            packed = len(matmul_int8._KMAJOR)
        else:
            assert len(matmul_int8._KMAJOR) == packed, "a run packed a weight again"
        for a, b, c in zip(got, cpu.run(xs), whole.run(xs)):
            assert a.dtype == b.dtype
            if a.dtype.kind in "iu":
                assert (a == b).all() and (a == c).all()
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
                np.testing.assert_array_equal(a, c)
    layers = ex._scans[1]["layers"]
    assert all(p.data_ptr() == st[k].data_ptr()
               for k in range(5) for p, st in zip(layers[k], ex._scans[1]["stacks"]))


@pytest.mark.cuda
def test_bucketed_on_card_equals_cpu(cuda):
    from tachikoma_tpu_torch.runtime.bucketed import BucketedExecutor

    g = resnet(18, batch_size=1, image_size=32, seed=0)
    rng = np.random.default_rng(2)
    q = quantize(g, [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)])
    card = BucketedExecutor(q, buckets=(2, 4), fuse=True, device="cuda")
    cpu = BucketedExecutor(q, buckets=(2, 4), fuse=True, device="cpu")
    for batch in (1, 3, 4, 5):
        x = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
        got = card.run(x)[0]
        assert got.shape[0] == batch
        # the float softmax head: the card's and the CPU's round apart
        np.testing.assert_allclose(got, cpu.run(x)[0], rtol=1e-5, atol=1e-8)
        exact = TorchExecutor(card._graph_for(batch), fuse=True, device="cuda").run(x)[0]
        assert (got == exact).all()
    assert card.compiled_buckets == [2, 4, 5]


@pytest.mark.cuda
def test_placement_cuda_and_cpu_equals_one_device(cuda):
    """The CPU-offload layout: the embedding lookups on the host, the rest
    on cuda:0; outputs == the single-device executor on the card."""
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
    from tachikoma_tpu_torch.runtime.placement import HeterogeneousExecutor, embeddings_on_host

    g = bert(batch_size=2, seq_len=16, hidden=32, layers=2, heads=4, ffn_dim=64, vocab=100,
             seed=0)
    x = np.random.default_rng(3).integers(0, 100, (2, 16)).astype(np.int32)
    q = fuse_qnn(quantize(g, [x], TRANSFORMER_INT8))
    hx = HeterogeneousExecutor(embeddings_on_host(q), devices=("cuda:0", "cpu"))
    got = hx.run(x)
    assert hx.transfers == 1 and [d for d, _ in hx.segments] == [1, 0]
    for a, b in zip(got, TorchExecutor(q, device="cuda").run(x)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# dynamic shapes, control flow and quantization-aware training on the card
# ---------------------------------------------------------------------------

from runtime_cases import CASES as DYN_CASES  # noqa: E402  (tests/, no jax)
from runtime_cases import (cond_heads, one_hot_labels, while_blocks,  # noqa: E402
                           with_cross_entropy, with_topk_head)


def _same_as_cpu(got, want, what, float_tol=(1e-5, 1e-8)):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, *float_tol, err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def r18_topk_head():
    from tachikoma_tpu_torch.ir.graph import Graph, Node

    rng = np.random.default_rng(0)
    q = quantize(resnet(18, batch_size=2, image_size=32, seed=0),
                 [rng.standard_normal((2, 32, 32, 3)).astype(np.float32)])
    return fuse_qnn(with_topk_head(q, Node, Graph)), rng.standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


@pytest.mark.cuda
def test_dynamic_head_on_card_equals_cpu(cuda, r18_topk_head):
    """A dyn.topk head on fused int8 ResNet-18's logits: k = 1, 5, 10, 5 make
    three specializations and a hit; K1-K3 launch; every output == the CPU
    path's; the hit packs no weight and builds nothing."""
    from tachikoma_tpu_torch.ops.kernels import matmul_int8
    from tachikoma_tpu_torch.runtime.dynshape import DynShapeExecutor

    fused, x = r18_topk_head
    ex, cpu = DynShapeExecutor(fused, device="cuda"), DynShapeExecutor(fused, device="cpu")
    names = ("qgemm_rq", "qconv_rq", "qconv_rq_res")
    for name in names:
        _lib.LAUNCHES[name] = 0
    for i, k in enumerate((1, 5, 10, 5)):
        if i == 3:
            packed, built = len(matmul_int8._KMAJOR), len(ex.miss_seconds)
        feeds = {"data": x, "k": np.array([k], np.int32)}
        got = ex.run(feeds)
        _same_as_cpu(got, cpu.run(feeds), f"k={k}")
        assert got[1].shape == (2, k)
    assert (ex.misses, ex.hits) == (3, 1)
    assert len(matmul_int8._KMAJOR) == packed and len(ex.miss_seconds) == built
    assert all(_lib.LAUNCHES[name] > 0 for name in names)
    assert all(e._params is not ex._params and
               all(e._params[k] is ex._params[k] for k in ex._params)
               for e in ex._cache.values())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cond", "while"])
def test_control_flow_on_card_equals_cpu_with_k4_plain(cuda, which, monkeypatch):
    """tk.cond between two int8 heads and tk.while_loop over an int8 block:
    == the CPU path on both flags and n = 0, 1, 4; every K4 call a branch or
    a body makes == its plain version; one host read per cond, n + 1 per
    loop; a branch's weight packed once over the calls."""
    from tachikoma_tpu_torch import Graph, GraphBuilder, infer_types
    from tachikoma_tpu_torch.ops import control
    from tachikoma_tpu_torch.ops.kernels import matmul_int8

    pkg = (GraphBuilder, Graph, infer_types)
    rng = np.random.default_rng(4)
    x = _i8(rng, (4, 64))
    if which == "cond":
        g = cond_heads(*pkg, batch=4, features=64, classes=40)
        runs = [({"flag": np.asarray(f), "features": x}, 1) for f in (True, False, True)]
    else:
        g = while_blocks(*pkg, batch=4, features=64)
        runs = [({"i0": np.int32(0), "n": np.int32(n), "features": x}, n + 1) for n in (0, 1, 4)]
    held = []
    real = matmul_int8.qgemm_raw

    def checked(*a, **k):
        out = real(*a, **k)
        assert torch.equal(out, matmul_int8.qgemm_raw_plain(*a, **k))
        held.append(out.shape)
        return out

    monkeypatch.setattr(matmul_int8, "qgemm_raw", checked)
    ex, cpu = TorchExecutor(g, device="cuda"), TorchExecutor(g, device="cpu")
    packed = []
    for _ in range(2):  # the second pass packs nothing
        for feeds, reads in runs:
            control.HOST_READS.clear()
            got = ex.run(feeds)
            assert sum(control.HOST_READS.values()) == reads
            _same_as_cpu(got, cpu.run(feeds), str(feeds.get("flag", feeds.get("n"))))
        packed.append(len(matmul_int8._KMAJOR))
    assert held and packed[0] == packed[1]


@pytest.mark.cuda
@pytest.mark.parametrize("cid,build,feeds", DYN_CASES, ids=[c[0] for c in DYN_CASES])
def test_dyn_op_on_card_equals_cpu(cuda, cid, build, feeds):
    from tachikoma_tpu_torch import GraphBuilder
    from tachikoma_tpu_torch.runtime.dynshape import DynShapeExecutor

    g = build(GraphBuilder)
    _same_as_cpu(DynShapeExecutor(g, device="cuda").run(dict(feeds)),
                 DynShapeExecutor(g, device="cpu").run(dict(feeds)), cid, float_tol=(0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("attrs", [dict(scale=0.1, zero_point=0, out_dtype="int8"),
                                   dict(scale=[0.02, 0.2, 1.0], zero_point=[0, 5, -7],
                                        out_dtype="int8", axis=0)], ids=["tensor", "axis"])
def test_simulated_quantize_on_card_equals_cpu(cuda, attrs):
    """The fake-quant pair's values == the CPU's, and its straight-through
    gradient (1/scale inside, 0 where the clip saturates) == the CPU's."""
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    dq_attrs = {k: v for k, v in attrs.items() if k != "out_dtype"}
    sq = Node("s", "qnn.simulated_quantize", ("x",), attrs)
    dq = Node("d", "qnn.simulated_dequantize", ("s",), dq_attrs)
    x = np.random.default_rng(5).standard_normal((3, 6)).astype(np.float32) * 40
    outs, grads = [], []
    for dev in ("cuda", "cpu"):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        q = get_op("qnn.simulated_quantize").torch_impl(xt, node=sq)
        out = get_op("qnn.simulated_dequantize").torch_impl(q, node=dq)
        out.sum().backward()
        outs.append((q.detach().cpu().numpy(), out.detach().cpu().numpy()))
        grads.append(xt.grad.cpu().numpy())
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grads[0], grads[1])
    assert (grads[0] == 0).any() and (grads[0] != 0).any()


@pytest.mark.cuda
def test_gradients_on_card_match_cpu_and_remat(cuda):
    """ResNet-18 b2 32² with a cross-entropy loss: value_and_grad_fn on the
    card gives the CPU's loss within 1e-4 and each gradient within 1e-3
    norm-wise (cuDNN's fp32 sums in another order).  With fake-quant pairs
    (qat_prepare) a rounding tipped by such a sum moves an activation by a
    quantum, so there the card is held against itself: remat=True's loss
    and gradients == remat=False's within 1e-5 norm-wise."""
    from tachikoma_tpu_torch.ir.graph import Graph, Node
    from tachikoma_tpu_torch.quantize.qat import qat_prepare
    from tachikoma_tpu_torch.runtime.autodiff import value_and_grad_fn

    rng = np.random.default_rng(6)
    feeds = {"data": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             "labels": one_hot_labels(2, 1000)}
    g = with_cross_entropy(resnet(18, batch_size=2, image_size=32, seed=0), Node, Graph)

    def step(graph, device, remat=False):
        fn, train, _ = value_and_grad_fn(graph, remat=remat, device=device)
        loss, grads = fn(train, feeds)
        return float(loss), {k: v.cpu().double() for k, v in grads.items()}

    def normwise(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    (closs, cgrads), (loss, grads) = step(g, "cpu"), step(g, "cuda")
    assert abs(loss - closs) <= 1e-4 * abs(closs)
    worst = max((normwise(grads[k], cgrads[k]), k) for k in cgrads)
    assert worst[0] <= 1e-3, worst
    qat_g = qat_prepare(g, [feeds])
    (loss, grads), (rloss, rgrads) = step(qat_g, "cuda"), step(qat_g, "cuda", remat=True)
    worst = max((normwise(rgrads[k], grads[k]), k) for k in grads)
    assert rloss == loss and worst[0] <= 1e-5, (rloss, loss, worst)


# ---------------------------------------------------------------------------
# the TensorFlow and Keras import path: the six ops it brought against their
# CPU torch impls, and Keras's ResNet-50 as models/keras_resnet.py writes it,
# read by the in-tree codec and fused on K1 and K2 (`-k keras or tf_op`)
# ---------------------------------------------------------------------------

from tf_op_cases import CASES as TF_OP_CASES  # noqa: E402  (tests/, no jax)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TF_OP_CASES, ids=[c[0] for c in TF_OP_CASES])
def test_tf_op_on_card_equals_cpu(cuda, case):
    """rsqrt, floor_divide, floor_mod, all, any and stack: == the CPU torch
    impl (a zero's sign too), an integer divided by zero included."""
    _, op, inputs, attrs, _, _, _, _ = case
    card, cpu = op_on_card_and_cpu(op, inputs, attrs, cuda)
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        if b.dtype.kind == "f":
            seen = ~np.isnan(b)
            np.testing.assert_array_equal(np.signbit(a)[seen], np.signbit(b)[seen])


@pytest.mark.cuda
def test_keras_resnet50_b2_64_fused_on_card_equals_cpu(cuda, tmp_path):
    """Keras's ResNet-50 written as a frozen GraphDef, read back from a .pb
    by the codec, quantized and fused (53 tk.conv2d_rq, 1 tk.dense_rq: its
    batch norms stay qnn.mul / qnn.add, so no chain forms): every K1 and K2
    call of a forward == its plain version, every integer node == the CPU
    path."""
    from tachikoma_tpu_torch.frontend import from_tf_graphdef
    from tachikoma_tpu_torch.models.keras_resnet import resnet50_keras
    from tachikoma_tpu_torch.ops.kernels.conv import qconv_rq_plain
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qgemm_rq_plain

    rng = np.random.default_rng(0)
    path = tmp_path / "r50.pb"
    path.write_bytes(resnet50_keras(2, 64))
    g = from_tf_graphdef(str(path))
    xs = [rng.standard_normal((2, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    fused = fuse_qnn(quantize(g, [xs[0]]))
    ops = [n.op for n in fused.nodes]
    assert [ops.count(o) for o in ("tk.conv2d_rq", "tk.conv2d_chain", "tk.dense_rq")] == \
        [53, 0, 1]
    names = computational_nodes(fused)
    calls = []
    for k in ("qgemm_rq", "qconv_rq"):
        _lib.LAUNCHES[k] = 0
    with _recorded(calls):
        card = TorchExecutor(fused, capture=names, device="cuda").run(xs[1])
    assert _lib.LAUNCHES["qgemm_rq"] == 37 and _lib.LAUNCHES["qconv_rq"] == 17
    plain = {"qgemm_rq": qgemm_rq_plain, "qconv_rq": qconv_rq_plain}
    for name, a, k in calls:
        assert torch.equal(_kernel(name)(*a, **k), plain[name](*a, **k)), name
    cpu = TorchExecutor(fused, capture=names, device="cpu").run(xs[1])
    for nm, a, b in zip(names, card, cpu):
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=nm)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=nm)


# -- parallel/* on the card: ranks on cuda:0 over gloo (phase 26 at small shapes)

from parallel_cases import (EXPERTS, MESHES, RINGS, SCALES, _key,  # noqa: E402  (tests/, no jax)
                            integer_nodes, moe_case, nccl_world_of_one, parallel_round,
                            ring_case)


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Four rank processes on cuda:0 over gloo running parallel_round on int8
    LeNet-5 b8 and ResNet-18 b4 32^2: (graphs, inputs, the ranks' results)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with -m cuda on the card")
    from tachikoma_tpu_torch.parallel.gather import launch
    from tachikoma_tpu_torch.runtime.artifact import save_artifact

    _lib.build()  # here, before any rank starts: four ranks building at once would race
    tmp = tmp_path_factory.mktemp("card_parallel")
    graphs, feeds, artifacts = {}, {}, {}
    for name, build, shape in (("lenet5", lambda: lenet5(batch_size=8), (8, 28, 28, 1)),
                               ("resnet18", lambda: resnet(18, batch_size=4, image_size=32),
                                (4, 32, 32, 3))):
        rng = np.random.default_rng(0)
        data = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        graphs[name], feeds[name] = quantize(build(), data), data[0]
        artifacts[name] = str(tmp / f"{name}.tkmod")
        save_artifact(artifacts[name], graphs[name])
    ranks = launch(4, parallel_round, (artifacts, feeds, moe_case(), ring_case(), "cuda:0"),
                   init_method=f"file://{tmp / 'store'}", timeout=600)
    return graphs, feeds, ranks


@pytest.mark.cuda
@pytest.mark.parametrize("axes", MESHES, ids=_key)
@pytest.mark.parametrize("model", ["lenet5", "resnet18"])
def test_sharded_executor_on_card_equals_single_card(card_ranks, model, axes):
    """ShardedExecutor over 4 ranks on one card: every integer node == the
    single card's TorchExecutor, the float output within rtol 1e-5, atol
    1e-7 (tests/test_shard.py:43), every rank the same global values; the
    sharded trace == the single card's trace bytes."""
    graphs, feeds, ranks = card_ranks
    q, x = graphs[model], feeds[model]
    names = integer_nodes(q) + list(q.outputs)
    want = TorchExecutor(q, capture=names, device="cuda").run(x)
    got = ranks[0]["captures"][(model, _key(axes))]
    for name, w in zip(names, want):
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-7, err_msg=name)
    assert len({r["digests"][(model, _key(axes))] for r in ranks}) == 1
    if model == "lenet5":
        from tachikoma_tpu_torch.trace.emitter import TraceEmitter

        single = TraceEmitter(q, backend="torch", device="cuda").emit_bytes(x)
        assert ranks[0]["traces"][(model, _key(axes))] == single


@pytest.mark.cuda
@pytest.mark.parametrize("ep", EXPERTS)
def test_moe_on_card_equals_reference(card_ranks, ep):
    from tachikoma_tpu_torch.parallel.moe import moe_dense_int8_reference

    _, _, ranks = card_ranks
    want = moe_dense_int8_reference(*moe_case())
    for r in ranks[:ep]:
        np.testing.assert_array_equal(r["moe"][ep], want)
        np.testing.assert_array_equal(r["moe_kept"][ep][0], want)
        np.testing.assert_array_equal(r["moe_kept"][ep][1], want[::-1])


@pytest.mark.cuda
@pytest.mark.parametrize("sp", RINGS)
def test_ring_attention_on_card_equals_oracle(card_ranks, sp):
    """K1's batched raw mode on each rank's chunks; K and V rotate through
    the host (gloo), which the helper counts."""
    from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph

    _, _, ranks = card_ranks
    q, k, v = ring_case()
    b = GraphBuilder()
    qn, kn, vn = (b.var(n, q.shape, "int8") for n in "qkv")
    g = infer_types(b.build(b.call("qnn.attention", qn, kn, vn, **SCALES)))
    want = run_graph(g, {"q": q, "k": k, "v": v})[0]
    for r in ranks[:sp]:
        got, stats = r["ring"][sp]
        np.testing.assert_array_equal(got, want)
        assert stats["send_recv"]["host_bytes"] == 2 * stats["send_recv"]["bytes"] > 0


@pytest.mark.cuda
def test_retry_and_meshes_on_card(card_ranks):
    _, _, ranks = card_ranks
    assert ranks[0]["retried"][0] == ranks[0]["traces"][("lenet5", "dp2,tp2")]
    assert [r["member"] for r in ranks] == [True, True, False, False]
    assert [r["non_member_raises"] for r in ranks] == [False, False, True, True]


@pytest.mark.cuda
def test_nccl_world_of_one_on_card(cuda, tmp_path):
    from tachikoma_tpu_torch.parallel.gather import launch

    [(ok, stats)] = launch(1, nccl_world_of_one, init_method=f"file://{tmp_path / 'store'}",
                           timeout=300)
    assert ok and stats["all_reduce"]["host_bytes"] == stats["all_gather"]["host_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("num_stages,micro", [(2, 4), (3, 2)])
def test_pipeline_on_card_equals_single_card(cuda, num_stages, micro):
    """Stages on streams of one card, an event between stages per
    microbatch: the output == the single card's; every stage's span is
    recorded."""
    from tachikoma_tpu_torch.parallel.pipeline import PipelineExecutor

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    q = quantize(resnet(18, batch_size=4, image_size=32), [x])
    pe = PipelineExecutor(q, num_stages, devices=["cuda:0"] * num_stages)
    got = pe.run(x, num_microbatches=micro)
    want = TorchExecutor(q, device="cuda").run(x)
    np.testing.assert_array_equal(got[0], want[0])
    spans = pe.intervals()
    assert len(spans) == len(pe.stages) * micro
    assert all(end >= start for _, _, start, end in spans)


# ---------------------------------------------------------------------------
# legacy uint8 models: uint8 data, a weight zero point, uint8 outputs, K5 with
# dilation (K1, K2, K4, K5)
# ---------------------------------------------------------------------------

def _u8(rng, shape, device):
    return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(device)


def _data(rng, shape, device, dtype):
    return _u8(rng, shape, device) if dtype == "uint8" else _dev(rng, shape, device)


def _kzp(rng, n, device, kind):
    """None, one zero point for every column (as a vector) or one a column,
    in the int8 range the kernels take (uint8 weights' less 128)."""
    if kind == "none":
        return None
    v = np.full(n, 15) if kind == "scalar" else rng.integers(-128, 128, n)
    return channel_vector(v, n, device)


# (M, K, N): the uint8 MobileNetV2 b8 224^2's 1x1 calls (K = 24: 8-byte
# copies; the head; the classifier at M = 8, skinny), a split of K (M 392,
# K 2048), M <= 64 at b1 (49 rows, the classifier at M = 1), a ragged call
LEGACY_GEMM_CASES = [(25088, 24, 144), (3136, 320, 1280), (8, 1280, 1001), (392, 2048, 512),
                     (49, 960, 160), (1, 1280, 1001), (37, 70, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", LEGACY_GEMM_CASES)
@pytest.mark.parametrize("dtype,kzp", [("uint8", "scalar"), ("uint8", "channel"),
                                       ("int8", "channel"), ("uint8", "none")])
def test_k1_k4_gemm_legacy_every_plan_on_card(rng, cuda, mkn, dtype, kzp):
    """K1 (uint8 and int8 out) and K4's GEMM mode with uint8 or int8 data and
    a weight zero point == plain at every launch they can make of the call
    (`gemm_plans`: each tile unsplit and split, the skinny path at M <= 64
    at several splits): each split takes its own steps' row sums off."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import gemm_plans

    m, k, n = mkn
    x, w = _data(rng, (m, k), cuda, dtype), _dev(rng, (k, n), cuda)
    z = _kzp(rng, n, cuda, kzp)
    b, mult, shift = _epilogue_args(rng, n, cuda)
    raw_want = qgemm_raw_plain(x, w, b, kzp=z)
    rq = dict(rq_izp=3, out_zp=100, rounding="TONEAREST", qmin=0, qmax=255, kzp=z,
              out_dtype="uint8")
    rq_want = qgemm_rq_plain(x, w, b, mult, shift, **rq)
    i8 = dict(rq, out_zp=-5, qmin=-128, qmax=127, out_dtype="int8")
    i8_want = qgemm_rq_plain(x, w, b, mult, shift, **i8)
    for plan in gemm_plans(m, k, n):
        got = qgemm_raw(x, w, b, plan=plan, kzp=z)
        torch.cuda.synchronize()
        assert torch.equal(got, raw_want), ("raw", plan)
        got = qgemm_rq(x, w, b, mult, shift, plan=plan, **rq)
        assert got.dtype == torch.uint8 and torch.equal(got, rq_want), ("rq", plan)
        assert torch.equal(qgemm_rq(x, w, b, mult, shift, plan=plan, **i8), i8_want), plan


# (x shape, k, stride, dilation, padding, cout): the uint8 MobileNetV2 b8
# 224^2 stem (CIN 3, SAME: (0, 0, 1, 1), byte gather), 3x3 at CIN 64 (16-byte
# copies) unsplit and at 7^2 x 512 (a split of K), dilated, a ragged one
LEGACY_CONV_CASES = [((8, 224, 224, 3), 3, 2, 1, (0, 0, 1, 1), 32),
                     ((2, 28, 28, 64), 3, 1, 1, (1, 1, 1, 1), 64),
                     ((1, 7, 7, 512), 3, 1, 1, (1, 1, 1, 1), 512),
                     ((1, 33, 33, 64), 3, 1, 4, (4, 4, 4, 4), 128),
                     ((2, 11, 9, 20), 5, 2, 1, (2, 1, 2, 1), 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEGACY_CONV_CASES)
@pytest.mark.parametrize("dtype,kzp", [("uint8", "scalar"), ("uint8", "channel"),
                                       ("int8", "channel"), ("uint8", "none")])
def test_k2_k4_conv_legacy_on_card(rng, cuda, case, dtype, kzp):
    """K2 (uint8 out, every tile) and K4's conv mode with uint8 or int8 data,
    the padding filled with izp, and a weight zero point == plain."""
    shape, k, s, d, pad, cout = case
    x, w = _data(rng, shape, cuda, dtype), _dev(rng, (k, k, shape[3], cout), cuda)
    z = _kzp(rng, cout, cuda, kzp)
    izp = 128 if dtype == "uint8" else -7
    kw = dict(strides=(s, s), padding=pad, izp=izp, dilation=(d, d), kzp=z)
    b, mult, shift = _epilogue_args(rng, cout, cuda)
    raw_want = qconv_raw_plain(x, w, b, **kw)
    before = _lib.LAUNCHES["qconv_raw"]
    got = qconv_raw(x, w, b, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["qconv_raw"] == before + 1 and torch.equal(got, raw_want)
    kw.update(rq_izp=-2, out_zp=60, rounding="UPWARD", qmin=0, qmax=255, out_dtype="uint8")
    want = qconv_rq_plain(x, w, b, mult, shift, **kw)
    for blocks in [None] + TILE_BLOCKS:
        got = qconv_rq(x, w, b, mult, shift, blocks=blocks, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and torch.equal(got, want), blocks


# DeepLab-MobileNetV2 (slim's mobilenet_v2 at output stride 8, b1 513^2)'s
# atrous depthwise calls: 65^2 maps, 384 and 576 channels at dilation 2, 960
# at 4; then MobileNetV2's undilated 3x3 s2, a 5x5 at dilation 3 and stride
# 2, C off 16 (byte copies)
LEGACY_DW_CASES = [((1, 65, 65, 384), 3, 1, 2), ((1, 65, 65, 576), 3, 1, 2),
                   ((1, 65, 65, 960), 3, 1, 4), ((8, 112, 112, 96), 3, 2, 1),
                   ((2, 23, 19, 40), 5, 2, 3), ((1, 14, 14, 24), 3, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEGACY_DW_CASES)
@pytest.mark.parametrize("dtype,kzp", [("uint8", "channel"), ("int8", "channel"),
                                       ("uint8", "none"), ("int8", "none")])
def test_k5_legacy_and_dilated_on_card(rng, cuda, case, dtype, kzp):
    """K5's both modes with uint8 or int8 data, a weight zero point, a
    dilation and (rq) a uint8 output == plain."""
    shape, k, s, d = case
    c = shape[3]
    x, w = _data(rng, shape, cuda, dtype), _dev(rng, (k, k, 1, c), cuda)
    z = _kzp(rng, c, cuda, kzp)
    p = d * (k // 2)
    kw = dict(strides=(s, s), padding=(p, p, p, p), izp=200 if dtype == "uint8" else -3,
              dilation=(d, d), kzp=z)
    b, mult, shift = _epilogue_args(rng, c, cuda)
    before = dict(_lib.LAUNCHES)
    got = qdwconv_raw(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, qdwconv_raw_plain(x, w, b, **kw))
    kw.update(rq_izp=1, out_zp=7, rounding="TONEAREST", qmin=0, qmax=255, out_dtype="uint8")
    got = qdwconv_rq(x, w, b, mult, shift, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and torch.equal(got, qdwconv_rq_plain(x, w, b, mult, shift,
                                                                          **kw))
    assert _lib.LAUNCHES["qdwconv_raw"] == before.get("qdwconv_raw", 0) + 1
    assert _lib.LAUNCHES["qdwconv_rq"] == before.get("qdwconv_rq", 0) + 1


@pytest.mark.cuda
def test_legacy_uint8_weights_through_the_entries_on_card(rng, cuda):
    """uint8 weights with their zero point through qconv2d_flat and
    qmatmul_int8 on the card == the CPU path, on K1, K2, K5 and K4; K3 and
    the K7-K10 layouts take no uint8 data (a layout is ignored, K3 raises)."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qmatmul_int8

    m, s = plan_requantize(0.0004, 0.05)
    rq = dict(multiplier=m, shift=s, out_zp=90, out_dtype="uint8", qmin=0, qmax=255)
    for xs, ws, kw, kernel in (
            ((2, 16, 16, 8), (3, 3, 8, 32), dict(padding=(1,) * 4, layout="t"), "qconv_rq"),
            ((2, 16, 16, 32), (1, 1, 32, 16), {}, "qgemm_rq"),
            ((2, 16, 16, 32), (3, 3, 1, 32), dict(groups=32, padding=(2,) * 4,
                                                  dilation=(2, 2)), "qdwconv_rq")):
        x, w = _u8(rng, xs, cuda), rng.integers(0, 256, ws).astype(np.uint8)
        kw = dict(kw, input_zero_point=128, kernel_zero_point=141)
        before = dict(_lib.LAUNCHES)
        got = qconv2d_flat(x, w, **rq, **kw)
        assert _lib.LAUNCHES[kernel] == before.get(kernel, 0) + 1
        assert torch.equal(got.cpu(), qconv2d_flat(x.cpu(), w, **rq, **kw))
        kw.pop("layout", None)
        raw = qconv2d_flat(x, w, **kw)
        assert torch.equal(raw.cpu(), qconv2d_flat(x.cpu(), w, **kw))
    x, w = _u8(rng, (8, 1280), cuda), rng.integers(0, 256, (1280, 1001)).astype(np.uint8)
    kz = rng.integers(0, 256, 1001)
    for mult in (m, None):
        args = dict(multiplier=mult, shift=s if mult is not None else None,
                    input_zero_point=3, kernel_zero_point=kz)
        if mult is not None:
            args.update(out_dtype="uint8", qmin=0, qmax=255)
        got = qmatmul_int8(x, w, **args)
        assert torch.equal(got.cpu(), qmatmul_int8(x.cpu(), w, **args))
    with pytest.raises(NotImplementedError, match="item 2"):
        qconv_rq_res(_u8(rng, (1, 8, 8, 16), cuda), _dev(rng, (3, 3, 16, 16), cuda),
                     *_epilogue_args(rng, 16, cuda), _dev(rng, (1, 8, 8, 16), cuda),
                     _res_params(0, 0, 0, "UPWARD"), padding=(1,) * 4)
