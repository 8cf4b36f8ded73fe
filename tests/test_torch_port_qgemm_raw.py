"""K4's GEMM mode (qgemm_raw) on the CPU: the launch plan at every call of
the unfused int8 ResNet-50 and MobileNetV2 b1 224^2 forwards (which path, a
compiled tile, a split that covers every K step once), the sums of both
paths' splits emulated in torch from the packed weight (each split adding
into a zeroed output, the bias with split 0) against the plain version and
the JAX package's `qmatmul_int8` without a multiplier (interpret mode on the
CPU, as tests/test_pallas_matmul.py runs it), the packing of a 1x1 conv's
stable weight, and the tuning record read as the JAX package reads it.
Integers are compared with ==.  The kernel itself runs on the card
(tests/test_torch_port_cuda.py -k "k4_qgemm or k4_gemm")."""

import numpy as np
import pytest
import torch

from tachikoma_tpu.ops.pallas.matmul_int8 import default_blocks as j_default_blocks
from tachikoma_tpu.ops.pallas.matmul_int8 import qmatmul_int8 as j_qmatmul_int8
from tachikoma_tpu.tune.tuner import matmul_workload as j_matmul_workload
from tachikoma_tpu_torch.ops.kernels import conv
from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm
from tachikoma_tpu_torch.tune import database as p_db
from tachikoma_tpu_torch.tune import tuner as p_tuner

SMS = 132
# (M, K, N, calls) of K4's GEMM mode in one unfused b1 224^2 forward
# (chip_smoke.py phases 7 and 10a): every 1x1 conv and the classifier
K4_CALLS = {
    "ResNet-50": [(3136, 64, 64, 1), (3136, 64, 256, 4), (3136, 256, 64, 2),
                  (3136, 256, 128, 1), (784, 128, 512, 4), (784, 256, 512, 1),
                  (784, 512, 128, 3), (784, 512, 256, 1), (196, 256, 1024, 6),
                  (196, 512, 1024, 1), (196, 1024, 256, 5), (196, 1024, 512, 1),
                  (49, 512, 2048, 3), (49, 1024, 2048, 1), (49, 2048, 512, 2),
                  (1, 2048, 1000, 1)],
    "MobileNetV2": [(12544, 32, 16, 1), (12544, 16, 96, 1), (3136, 96, 24, 1),
                    (3136, 24, 144, 2), (3136, 144, 24, 1), (784, 144, 32, 1),
                    (784, 32, 192, 3), (784, 192, 32, 2), (196, 192, 64, 1),
                    (196, 64, 384, 4), (196, 384, 64, 3), (196, 384, 96, 1),
                    (196, 96, 576, 3), (196, 576, 96, 2), (49, 576, 160, 1),
                    (49, 160, 960, 3), (49, 960, 160, 2), (49, 960, 320, 1),
                    (49, 320, 1280, 1), (1, 1280, 1000, 1)],
}
CALLS = [(model, c) for model, calls in K4_CALLS.items() for c in calls]


def _covers(ks, kper, steps):
    covered = np.zeros(steps, np.int64)
    for z in range(ks):
        lo, hi = z * kper, min((z + 1) * kper, steps)
        assert lo < hi, f"split {z} of {ks} is empty"
        covered[lo:hi] += 1
    return (covered == 1).all()


def test_k4_call_lists_of_the_b1_forwards():
    """37 calls at ResNet-50 b1 (30 on the tiled path, six M = 49 calls and
    the classifier on the skinny one), 35 at MobileNetV2 b1 (26 and 9)."""
    for model, total, skinny in (("ResNet-50", 37, 7), ("MobileNetV2", 35, 9)):
        calls = K4_CALLS[model]
        assert sum(c[3] for c in calls) == total
        assert sum(c[3] for c in calls if c[0] <= mm.SKINNY_M) == skinny


@pytest.mark.parametrize("model,call", CALLS, ids=[f"{m}-{c[0]}x{c[1]}x{c[2]}" for m, c in CALLS])
def test_k4_plan_at_b1_calls(model, call):
    """M <= 64 takes the skinny path at K1's split; M above it the tiled
    path at `rq_tile`'s compiled tile, unsplit where the tiles fill at least
    half the SMs, else split as `rq_split` says; every split covers each K
    step once."""
    m, k, n, _ = call
    plan = mm.gemm_plan(m, k, n, sms=SMS)
    steps = -(-k // mm.KSTEP)
    assert _covers(plan["ks"], plan["kper"], steps)
    assert mm.split_covers(plan["ks"], plan["kper"], steps)
    if m <= mm.SKINNY_M:
        assert plan["path"] == "skinny" and (plan["ks"] == 1 or plan["kper"] >= 2)
        assert (plan["ks"], plan["kper"]) == mm.skinny_split(k, n, SMS)
        return
    assert plan["path"] == "tiled" and (plan["bm"], plan["bn"]) == mm.rq_tile(m, n, SMS)
    tiles = -(-m // plan["bm"]) * -(-n // plan["bn"])
    if 2 * tiles >= SMS:
        assert plan["ks"] == 1
    else:
        assert (plan["ks"], plan["kper"]) == mm.rq_split(m, n, k, (plan["bm"], plan["bn"]), SMS)
        assert plan["ks"] == 1 or plan["kper"] >= mm.RQ_MIN_STEPS


def test_k4_split_rule_at_the_measured_calls():
    """The splits K1's rule gives at the b1 calls whose splits were measured
    (`gemm_plan`'s docstring): (196, 1024, 256) four ways, (784, 512, 256),
    (196, 512, 1024) and (784, 512, 128) unsplit; a tile in `blocks` is the
    tiled path's, the skinny path reads none; every plan is one of
    `gemm_plans`'."""
    got = {c: mm.gemm_plan(*c, sms=SMS)["ks"]
           for c in ((196, 1024, 256), (784, 512, 256), (196, 512, 1024), (784, 512, 128))}
    assert got == {(196, 1024, 256): 4, (784, 512, 256): 1, (196, 512, 1024): 1,
                   (784, 512, 128): 1}
    assert mm.gemm_plan(784, 512, 128, (128, 64, 64), SMS)["bm"] == 128
    assert (mm.gemm_plan(49, 512, 2048, (128, 128, 64), SMS)
            == mm.gemm_plan(49, 512, 2048, sms=SMS))
    for m, k, n in ((49, 512, 2048), (37, 80, 13), (196, 1024, 256)):
        plans = mm.gemm_plans(m, k, n, SMS)
        assert {(p["bm"], p["bn"]) for p in plans if p["path"] == "tiled"} == set(mm.TILES)
        assert any(p["path"] == "skinny" for p in plans) == (m <= mm.SKINNY_M)
        assert all(mm.split_covers(p["ks"], p["kper"], -(-k // 64)) for p in plans)
        assert mm.gemm_plan(m, k, n, sms=SMS) in plans


def _raw_split_sums(x, wk, bias, ks, kper):
    """K4's sums as its kernel forms them on either path: split z adds the
    products of its steps [z*kper, (z+1)*kper) of the packed weight `wk`
    (steps, N, 64) into a zeroed int32 output, split 0 the bias as well;
    int32 sums wrap alike in any order."""
    m, k = x.shape
    steps, n, _ = wk.shape
    xp = torch.zeros((m, steps * mm.KSTEP), dtype=torch.int64)
    xp[:, :k] = x.to(torch.int64)
    xs = xp.reshape(m, steps, mm.KSTEP)
    out = torch.zeros((m, n), dtype=torch.int64)
    for z in range(ks):
        part = torch.zeros((m, n), dtype=torch.int64)
        for s in range(z * kper, min((z + 1) * kper, steps)):
            part += xs[:, s] @ wk[s].to(torch.int64).t()
        if z == 0:
            part += bias.to(torch.int64)
        out = (out + part).to(torch.int32).to(torch.int64)  # each add wraps in int32
    return out.to(torch.int32)


def _jax_bias_ok(m, k, n):
    """Whether the JAX package's raw qmatmul_int8 takes a bias at this shape:
    its N block must divide N (ROADMAP.md Queue 3, the matmul_int8.py fault)."""
    return n % j_default_blocks(m, k, n)[1] == 0


# (M, K, N): the b1 skinny calls, a ragged M and N, K % 16 == 8, K % 8 != 0,
# and tiled calls whose splits are uneven
RAW_CASES = [(1, 2048, 1000), (49, 512, 2048), (49, 960, 320), (8, 136, 128), (37, 80, 13),
             (49, 100, 40), (196, 1024, 256), (100, 200, 512), (70, 600, 24)]


@pytest.mark.parametrize("mkn", RAW_CASES)
@pytest.mark.parametrize("ks", [1, 2, 3])
def test_k4_split_sums_equal_plain_and_jax(rng, mkn, ks):
    """Split 1, 2 and 3 ways (each split non-empty), the sums added into a
    zeroed output with the bias on split 0, == K4's plain version == the
    JAX package's qmatmul_int8 without a multiplier; a bias at +-2^31 (less
    the column index) so that the sums wrap.  A ragged N is compared with
    JAX without the bias."""
    m, k, n = mkn
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    j = np.arange(n)
    b = np.where(j % 2, 2 ** 31 - 1 - j, -2 ** 31 + j).astype(np.int32)
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    steps = -(-k // mm.KSTEP)
    kper = -(-steps // min(ks, steps))
    got = _raw_split_sums(tx, mm.kmajor_weights(tw), tb, -(-steps // kper), kper)
    assert torch.equal(got, mm.qgemm_raw_plain(tx, tw, tb))
    if _jax_bias_ok(m, k, n):
        want = np.asarray(j_qmatmul_int8(x, w, bias=b))
    else:
        want = (np.asarray(j_qmatmul_int8(x, w)).astype(np.int64) + b).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    full = x.astype(np.int64) @ w.astype(np.int64) + b
    assert ((full >= 2 ** 31) | (full < -2 ** 31)).any()  # the sums wrapped


def test_k4_conv1x1_packs_its_stable_weight_once(rng, monkeypatch):
    """_conv1x1_matmul hands K4's GEMM mode a (CIN, COUT) view made per call
    and its 4-D weight as `w_src`: across two calls on one weight the cache
    returns the same packed tensor, so no call repacks."""
    seen = []
    real = mm.qgemm_raw

    def spy(x, w, b, *, w_src=None, **k):
        seen.append((w_src, mm.kmajor_weights(w_src)))
        return real(x, w, b, w_src=w_src, **k)

    monkeypatch.setattr(mm, "qgemm_raw", spy)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 6, 6, 40)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (1, 1, 40, 24)).astype(np.int8))
    outs = [conv.qconv2d_flat(x, w, None, strides=(2, 2), input_zero_point=3) for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and outs[0].dtype == torch.int32
    (src0, wk0), (src1, wk1) = seen
    assert src0 is w and src1 is w and wk0 is wk1
    assert wk0.shape == (1, 24, 64)


def _spy_routes(monkeypatch):
    routes = []
    real_raw, real_lib = mm.qgemm_raw, mm.qgemm_raw_library

    def raw(x, w, b, **k):
        routes.append(("kernel", k.get("blocks")))
        return real_raw(x, w, b, **k)

    def lib(x, w, b):
        routes.append(("library", None))
        return real_lib(x, w, b)

    monkeypatch.setattr(mm, "qgemm_raw", raw)
    monkeypatch.setattr(mm, "qgemm_raw_library", lib)
    return routes


def test_k4_reads_its_tile_and_record_as_the_jax_package_does(rng, monkeypatch):
    """qmatmul_int8 without a multiplier looks up the raw workload's record
    (the JAX package's key): a compiled tile reaches the kernel, {"impl":
    "xla"} the library route, a tile that is not compiled is ignored; an
    explicit `blocks` wins and a bad string raises; every route gives the
    plain integers, == the JAX package's."""
    routes = _spy_routes(monkeypatch)
    m, k, n = 49, 160, 128
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    b = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.int32)
    want = np.asarray(j_qmatmul_int8(x, w, bias=b))
    wl = mm.matmul_workload(m, k, n, False)
    assert wl == j_matmul_workload(m, k, n, False)
    tx = torch.from_numpy(x)
    for cfg, route in (({"blocks": [128, 64, 64]}, ("kernel", (128, 64, 64))),
                       ({"impl": "xla"}, ("library", None)),
                       ({"blocks": [256, 256, 64]}, ("kernel", None))):
        db = p_db.TuneDatabase()
        db.add(p_db.TuneRecord(wl, cfg, 0.01))
        db.add(p_db.TuneRecord(mm.matmul_workload(m, k, n, True), {"impl": "xla"}, 0.001))
        with p_db.apply_history_best(db):
            got = mm.qmatmul_int8(tx, w, b)
        assert routes[-1] == route, cfg
        np.testing.assert_array_equal(got.numpy(), want)
    got = mm.qmatmul_int8(tx, w, b, blocks=(64, 128, 64))
    assert routes[-1] == ("kernel", (64, 128, 64))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="compiled tile or 'xla'"):
        mm.qmatmul_int8(tx, w, b, blocks="pallas")
    with pytest.raises(ValueError, match="not a compiled tile"):
        mm.qmatmul_int8(tx, w, b, blocks=(32, 64, 64))


def test_k4_tune_task_offers_the_tiles_and_the_library_route():
    """tune_matmul's raw task (fused False) measures every compiled tile and
    the library route, each held == plain first (on the CPU: no error)."""
    wl, configs, measure, _, _ = p_tuner.matmul_task(20, 64, 24, fused=False, device="cpu")
    assert wl == j_matmul_workload(20, 64, 24, False)
    assert configs == ([{"blocks": [bm, bn, 64]} for bm, bn in mm.TILES]
                       + [{"impl": "xla"}])
    assert all(measure(c)[1] == p_db.NO_ERROR for c in configs)
