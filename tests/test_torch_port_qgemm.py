"""K1 (qgemm_rq) on the CPU: the launch plan at every call of int8
ResNet-50, MobileNetV2 and VGG-16 b8 224^2 (which path, a split that covers
every K step once, a skinny grid that fills the card), the skinny path's
swap of operands emulated in torch against the plain version and the JAX
package's `qmatmul_int8` (interpret mode on the CPU, as
tests/test_pallas_matmul.py runs it), and the K-major weight packing and
its cache.  Integers are compared with ==.  The kernel itself runs on the
card (tests/test_torch_port_cuda.py -k k1)."""

import numpy as np
import pytest
import torch

from tachikoma_tpu.ops.pallas.matmul_int8 import qmatmul_int8 as j_qmatmul_int8
from tachikoma_tpu.ops.pallas.qms32 import plan_requantize as j_plan_requantize
from tachikoma_tpu_torch.ops.kernels import conv
from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm
from tachikoma_tpu_torch.ops.kernels.requantize import epilogue_plain

SMS = 132
# (M, K, N, calls) of K1 in one b8 224^2 forward (chip_smoke.py phases 4,
# 9b, 16a.2): ResNet-50's first 1x1 of each bottleneck, the strided stages'
# first-block last 1x1 and downsample, the classifier; MobileNetV2's expand
# and project 1x1s, last 1x1 and classifier; VGG-16's dense layers
K1_CALLS = {
    "ResNet-50": [(25088, 64, 64, 1), (25088, 64, 256, 1), (25088, 256, 64, 2),
                  (25088, 256, 128, 1), (6272, 128, 512, 1), (6272, 256, 512, 1),
                  (6272, 512, 128, 3), (6272, 512, 256, 1), (1568, 256, 1024, 1),
                  (1568, 512, 1024, 1), (1568, 1024, 256, 5), (1568, 1024, 512, 1),
                  (392, 512, 2048, 1), (392, 1024, 2048, 1), (392, 2048, 512, 2),
                  (8, 2048, 1000, 1)],
    "MobileNetV2": [(100352, 32, 16, 1), (100352, 16, 96, 1), (25088, 96, 24, 1),
                    (25088, 24, 144, 2), (25088, 144, 24, 1), (6272, 144, 32, 1),
                    (6272, 32, 192, 3), (6272, 192, 32, 2), (1568, 192, 64, 1),
                    (1568, 64, 384, 4), (1568, 384, 64, 3), (1568, 384, 96, 1),
                    (1568, 96, 576, 3), (1568, 576, 96, 2), (392, 576, 160, 1),
                    (392, 160, 960, 3), (392, 960, 160, 2), (392, 960, 320, 1),
                    (392, 320, 1280, 1), (8, 1280, 1000, 1)],
    "VGG-16": [(8, 25088, 4096, 1), (8, 4096, 4096, 1), (8, 4096, 1000, 1)],
}
CALLS = [(model, c) for model, calls in K1_CALLS.items() for c in calls]


def _covers(ks, kper, steps):
    covered = np.zeros(steps, np.int64)
    for z in range(ks):
        lo, hi = z * kper, min((z + 1) * kper, steps)
        assert lo < hi, f"split {z} of {ks} is empty"
        covered[lo:hi] += 1
    return (covered == 1).all()


@pytest.mark.parametrize("model,call", CALLS, ids=[f"{m}-{c[0]}x{c[1]}x{c[2]}" for m, c in CALLS])
def test_k1_plan_at_model_shapes(model, call):
    """The dense layers (M = 8) take the skinny path, whose blocks fill the
    132 SMs; the 1x1 convs the tiled one at a compiled tile; every split
    covers each K step once."""
    m, k, n, _ = call
    plan = mm.gemm_plan(m, k, n, sms=SMS)
    steps = -(-k // mm.KSTEP)
    assert _covers(plan["ks"], plan["kper"], steps)
    assert mm.split_covers(plan["ks"], plan["kper"], steps)
    if m <= mm.SKINNY_M:
        assert plan["path"] == "skinny" and m == 8
        blocks = -(-n // mm.SKINNY_BN) * plan["ks"]
        assert blocks >= SMS, f"{blocks} blocks leave SMs idle"
        assert plan["kper"] >= mm.SKINNY_MIN_STEPS
    else:
        assert plan["path"] == "tiled"
        assert (plan["bm"], plan["bn"]) in ((64, 64), (64, 128), (128, 64), (128, 128))
        tiles = -(-m // plan["bm"]) * -(-n // plan["bn"])
        if 2 * tiles >= SMS:  # the tiles fill half the card: unsplit
            assert plan["ks"] == 1
        else:
            assert (plan["ks"], plan["kper"]) == mm.rq_split(m, n, k, (plan["bm"], plan["bn"]),
                                                             SMS)


def test_k1_tile_and_record_reach_the_tiled_path_alone():
    """A tile (the tuner's `blocks`) sets the tiled path's (BM, BN); the
    skinny path reads none; `gemm_plans` offers every compiled tile and,
    at M <= 64, skinny splits, each covering K."""
    assert mm.gemm_plan(392, 2048, 512, (128, 64, 64), SMS)["bm"] == 128
    assert mm.gemm_plan(8, 2048, 1000, (128, 128, 64), SMS) == mm.gemm_plan(8, 2048, 1000,
                                                                              sms=SMS)
    for m, k, n in ((8, 25088, 4096), (37, 80, 13), (392, 2048, 512)):
        plans = mm.gemm_plans(m, k, n, SMS)
        tiles = {(p["bm"], p["bn"]) for p in plans if p["path"] == "tiled"}
        assert tiles == {(64, 64), (64, 128), (128, 64), (128, 128)}
        assert any(p["path"] == "skinny" for p in plans) == (m <= mm.SKINNY_M)
        assert all(mm.split_covers(p["ks"], p["kper"], -(-k // 64)) for p in plans)


def _skinny_emulated(x, wk, k, ks, kper):
    """The int32 sums of K1's skinny path, formed as the kernel forms them:
    out^T (N, M) = W^T (N, K) x^T (K, M) from the packed weight `wk` (steps,
    N, 64), each split z adding its steps [z*kper, (z+1)*kper) into a zeroed
    workspace; returns the (M, N) accumulator (int32 sums wrap alike in any
    order)."""
    m = x.shape[0]
    steps, n, _ = wk.shape
    xp = torch.zeros((m, steps * mm.KSTEP), dtype=torch.int64)
    xp[:, :k] = x.to(torch.int64)
    xs = xp.reshape(m, steps, mm.KSTEP)
    ws = torch.zeros((n, m), dtype=torch.int64)
    for z in range(ks):
        for s in range(z * kper, min((z + 1) * kper, steps)):
            ws += wk[s].to(torch.int64) @ xs[:, s].t()
    return ws.t().to(torch.int32).contiguous()


@pytest.mark.parametrize("mkn,ks", [((8, 512, 200), None), ((8, 512, 200), 3), ((1, 1280, 96), None),
                                    ((37, 80, 13), None), ((37, 80, 13), 2), ((64, 200, 70), 4),
                                    ((16, 136, 64), None)])
def test_k1_skinny_swap_emulated_equals_plain_and_jax(rng, mkn, ks):
    """The skinny path's sums, out^T = W^T x^T from the packed weight, each
    split adding its steps into a workspace, then the epilogue, == K1's
    plain version == the JAX package's qmatmul_int8."""
    m, k, n = mkn
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    b = rng.integers(-5000, 5000, n).astype(np.int32)
    mult, shift = j_plan_requantize(0.0004 + np.abs(rng.standard_normal(n)) * 0.0005, 0.07)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    args = (torch.from_numpy(b), torch.from_numpy(mult.astype(np.int32)),
            torch.from_numpy(shift.astype(np.int32)))
    kw = dict(rq_izp=0, out_zp=3, rounding="TONEAREST", qmin=-128, qmax=127)
    plan = mm.gemm_plan(m, k, n, sms=SMS)
    steps = -(-k // mm.KSTEP)
    if ks is not None:
        kper = -(-steps // ks)
        plan = {"path": "skinny", "ks": -(-steps // kper), "kper": kper}
    assert plan["path"] == "skinny"
    acc = _skinny_emulated(tx, mm.kmajor_weights(tw), k, plan["ks"], plan["kper"])
    got = epilogue_plain(acc, *args, **kw)
    assert torch.equal(got, mm.qgemm_rq_plain(tx, tw, *args, **kw))
    want = np.asarray(j_qmatmul_int8(x, w, bias=b, multiplier=mult, shift=shift, out_zp=3,
                                     rounding="TONEAREST"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kn", [(24, 144), (2048, 1000), (80, 13), (25088 // 64, 70)])
def test_k1_kmajor_packing_of_a_gemm_weight(rng, kn):
    """A (K, N) weight packs as (steps, N, 64): row (s, n) is column n at K
    64 s .. 64 s + 63, zeros past K, the same bytes as its (1, 1, K, N)
    conv form; a second call returns the cached tensor."""
    k, n = kn
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    wk = mm.kmajor_weights(w)
    steps = -(-k // 64)
    assert wk.shape == (steps, n, 64) and wk.dtype == torch.int8
    flat = wk.transpose(0, 1).reshape(n, steps * 64)
    assert torch.equal(flat[:, :k], w.t()) and not flat[:, k:].any()
    assert torch.equal(conv.kmajor_weights(w.reshape(1, 1, k, n).clone()), wk)
    assert mm.kmajor_weights(w) is wk


def test_k1_conv1x1_packs_its_stable_weight_once(rng, monkeypatch):
    """_conv1x1_matmul hands K1 a (CIN, COUT) view made per call and its 4-D
    weight as `w_src`: across two calls on one weight the cache returns the
    same packed tensor, so no call repacks."""
    seen = []
    real = mm.qgemm_rq

    def spy(x, w, *a, w_src=None, **k):
        seen.append((w_src, mm.kmajor_weights(w_src)))
        return real(x, w, *a, w_src=w_src, **k)

    monkeypatch.setattr(mm, "qgemm_rq", spy)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 6, 6, 40)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (1, 1, 40, 24)).astype(np.int8))
    outs = [conv.qconv2d_flat(x, w, None, 0.001, -3) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    (src0, wk0), (src1, wk1) = seen
    assert src0 is w and src1 is w and wk0 is wk1
    assert wk0.shape == (1, 24, 64)
