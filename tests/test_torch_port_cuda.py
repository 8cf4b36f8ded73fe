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
from tachikoma_tpu_torch.models.vision import mobilenet_v2, resnet
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
    head-split views, context softmax . v with the softmax's zero point."""
    kind, b, s, h, d = case
    if kind == "scores":
        return (_heads(rng, b, s, h, d, device), _heads(rng, b, s, h, d, device),
                dict(transpose_b=True))
    return (_dev(rng, (b, h, s, s), device), _heads(rng, b, s, h, d, device),
            dict(lhs_zero_point=-128))


BMM_CASES = [("scores", 4, 128, 12, 64), ("context", 4, 128, 12, 64),   # BERT-base b4 s128
             ("scores", 2, 197, 12, 64), ("context", 2, 197, 12, 64),   # ViT-B/16's S
             ("scores", 2, 40, 3, 40), ("context", 2, 40, 3, 40),       # ragged D
             ("scores", 1, 33, 2, 72), ("context", 1, 33, 2, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BMM_CASES, ids=["-".join(map(str, c)) for c in BMM_CASES])
@pytest.mark.parametrize("tile", [None, (64, 64), (128, 128)])
def test_k1_qbmm_on_card(rng, cuda, case, tile):
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    a, b, kw = _bmm_case(rng, cuda, case)
    plan = None if tile is None else {"bm": tile[0], "bn": tile[1]}
    n = b.shape[-2] if kw.get("transpose_b") else b.shape[-1]
    mult, shift = plan_requantize(0.002, 1.0)
    m_t, s_t = channel_vector(mult, n, cuda), channel_vector(shift, n, cuda)
    before = _lib.LAUNCHES["qbmm_raw"], _lib.LAUNCHES["qbmm_rq"]
    raw = qbmm_raw(a, b, plan=plan, **kw)
    assert torch.equal(raw.cpu(), qbmm_raw_plain(a.cpu(), b.cpu(), **kw))
    rq = qbmm_rq(a, b, None, m_t, s_t, out_zp=-3, qmin=-120, plan=plan, **kw)
    want = qbmm_rq_plain(a.cpu(), b.cpu(), None, m_t.cpu(), s_t.cpu(), out_zp=-3, qmin=-120, **kw)
    assert torch.equal(rq.cpu(), want)
    assert (_lib.LAUNCHES["qbmm_raw"], _lib.LAUNCHES["qbmm_rq"]) == (before[0] + 1,
                                                                     before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("za,zb,ta,tb", [(0, 5, False, False), (-128, -7, False, True),
                                         (11, 3, True, True), (-128, 0, True, False)])
def test_k1_qbmm_zero_points_and_transposes_on_card(rng, cuda, za, zb, ta, tb):
    """Both zero points folded (the column and row terms), both transposes
    (A or B read rows-contiguous or a byte a load), broadcast batch axes and
    a bias."""
    from tachikoma_tpu_torch.ops.kernels.matmul_int8 import (qbmm_raw, qbmm_raw_plain, qbmm_rq,
                                                             qbmm_rq_plain)

    m, k, n = 48, 80, 64
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
# W8A16 on the card: K4 / K5 over two byte planes, the wide requantize, and
# the exporter's TFLite MobileNetV2 at b16 on K1 / K2 / K5 (`-k "w8a16 or tflite"`)
# ---------------------------------------------------------------------------

W8A16_CONVS = [
    # (x shape, weight shape, strides, padding, groups): ResNet-50's 7x7 s2 stem,
    # a 3x3 s2 and s1 at its widths, 1x1 s1 / s2, MobileNetV2-like depthwise
    # (TFLite's bottom-right SAME at s2), the 16x8 fixture's groups-8 conv
    ((1, 224, 224, 3), (7, 7, 3, 64), (2, 2), (3, 3, 3, 3), 1),
    ((2, 28, 28, 128), (3, 3, 128, 128), (2, 2), (1, 1, 1, 1), 1),
    ((1, 14, 14, 256), (3, 3, 256, 256), (1, 1), (1, 1, 1, 1), 1),
    ((2, 28, 28, 256), (1, 1, 256, 512), (2, 2), (0, 0, 0, 0), 1),
    ((1, 7, 7, 512), (1, 1, 512, 2048), (1, 1), (0, 0, 0, 0), 1),
    ((2, 56, 56, 144), (3, 3, 1, 144), (2, 2), (0, 0, 1, 1), 144),
    ((1, 16, 16, 8), (3, 3, 1, 8), (1, 1), (1, 1, 1, 1), 8),
]
W8A16_ZPS = [0, -32768, 32767, 256, -3841]


def _i16(rng, shape):
    x = rng.integers(-2 ** 15, 2 ** 15, shape).astype(np.int16)
    flat = x.reshape(-1)
    flat[: flat.size // 8] = -2 ** 15
    flat[flat.size // 8: flat.size // 4] = 2 ** 15 - 1
    rng.shuffle(flat)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("izp", W8A16_ZPS)
@pytest.mark.parametrize("case", W8A16_CONVS, ids=[f"conv{i}" for i in range(len(W8A16_CONVS))])
def test_w8a16_conv_planes_on_card_equal_plain(rng, cuda, case, izp):
    from tachikoma_tpu_torch.ops.kernels import wide

    xs, ws, strides, padding, groups = case
    x = torch.from_numpy(_i16(rng, xs)).to(cuda)
    w = _dev(rng, ws, cuda)
    kw = dict(strides=strides, padding=padding, groups=groups, izp=izp)
    before = _lib.LAUNCHES["wide_planes"]
    got = wide.wide_conv(x, w, **kw)
    want = wide.wide_conv_plain(x, w, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["wide_planes"] == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)
    cpu = wide.wide_conv(x.cpu(), w.cpu(), **kw)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("izp", W8A16_ZPS)
@pytest.mark.parametrize("mkn", [(8, 2048, 1000), (1, 2048, 1000), (16, 1280, 10),
                                 (100, 576, 96), (3136, 64, 256)])
def test_w8a16_dense_planes_on_card_equal_plain(rng, cuda, mkn, izp):
    from tachikoma_tpu_torch.ops.kernels import wide

    m, k, n = mkn
    x = torch.from_numpy(_i16(rng, (m, k))).to(cuda)
    w = _dev(rng, (k, n), cuda)
    got = wide.wide_dense(x, w, izp=izp)
    torch.cuda.synchronize()
    assert torch.equal(got, wide.wide_dense_plain(x, w, izp=izp))


@pytest.mark.cuda
def test_w8a16_planes_exact_near_the_k_bound_and_raise_past_it(cuda):
    """At K = K_BOUND the worst case fills each plane's int32 sum to
    2^31 - 127 (K4's GEMM mode on both paths); one term more raises."""
    from tachikoma_tpu_torch.ops.kernels import wide

    k = wide.K_BOUND
    for m in (1, 128):
        x = torch.full((m, k), -2 ** 15, dtype=torch.int16, device=cuda)
        w = torch.full((k, 2), -128, dtype=torch.int8, device=cuda)
        got = wide.wide_dense(x, w, izp=2 ** 15 - 1)
        torch.cuda.synchronize()
        assert bool((got == (-2 ** 16 + 1) * -128 * k).all())
    x = torch.zeros((1, 3, 3, 7400), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="above 65793"):
        wide.wide_conv(x, torch.zeros((3, 3, 7400, 4), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="above 65793"):
        wide.wide_dense(torch.zeros((1, k + 1), dtype=torch.int16, device=cuda),
                        torch.zeros((k + 1, 4), dtype=torch.int8, device=cuda))


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
    _lib.LAUNCHES["wide_planes"] = 0
    card = TorchExecutor(g, capture=names, device="cuda").run(io_["x"])
    assert _lib.LAUNCHES["wide_planes"] == 5  # 4 qnn.conv2d + 1 qnn.dense
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
