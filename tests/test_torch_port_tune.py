"""The port's tuning path on the CPU, against the JAX package's `tune/`.

Records are byte-equal JSON lines; features and cost-model predictions are
equal (rtol 1e-12); with the same deterministic fake `measure`, the budget
scheduler, the model search and the evolutionary search write the same
database lines and reports in both packages; `graph_tasks` finds the same
workloads with the same weights in a fused ResNet-18.  The port's own rules:
a trial whose output differs from the plain version is WRONG_ANSWER and never
best, the H100's credible ceiling is 1979 TOP/s, the tune entry points need a
card unless asked for the CPU, and the CLI tunes and serves a database.
"""

import json
import zlib

import numpy as np
import pytest
import torch

from tachikoma_tpu.models.vision import resnet as j_resnet
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.tune import database as j_db
from tachikoma_tpu.tune import evolutionary as j_evo
from tachikoma_tpu.tune import model as j_model
from tachikoma_tpu.tune import schedule as j_sched
from tachikoma_tpu.tune.schedule import graph_tasks as j_graph_tasks
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.tune import database as p_db
from tachikoma_tpu_torch.tune import evolutionary as p_evo
from tachikoma_tpu_torch.tune import model as p_model
from tachikoma_tpu_torch.tune import schedule as p_sched
from tachikoma_tpu_torch.tune import tuner as p_tuner

CONV = "qconv2d_flat/N8_H56_W56_C128_O128_K3x3_S2x2_rq"
CONFIGS = ([{"blocks": [bm, bn, 64]} | ({"layout": lay} if lay else {})
            for bm in (64, 128) for bn in (64, 128) for lay in (None, "t", "s", "w", "r")])
GEMM_CONFIGS = [{"blocks": [bm, bn, 64]} for bm in (64, 128) for bn in (64, 128)] \
    + [{"impl": "xla"}]
WORKLOADS = {
    CONV: CONFIGS,
    "qconv2d_flat/N8_H14_W14_C512_O512_K3x3_S2x2_rq": CONFIGS,
    "qmatmul_int8/M25088_K64_N256/fused": GEMM_CONFIGS,
    "qconv2d_chain/N8_H56_W56/K1C64O64+K3C64O64+K1C64O256":
        [{"bm": bm, "bn": bn} for bm in (64, 128) for bn in (64, 128)],
    "qconv2d_stack/N8_H7_W7/K1C2048O512+K3C512O512+K1C512O2048|"
    "K1C2048O512+K3C512O512+K1C512O2048":
        [{"bm": bm, "bn": bn} for bm in (64, 128) for bn in (64, 128)],
}


def fake_measure(workload):
    """A deterministic (time_s, error_no, msg): a smooth function of the
    config plus a hash, with one failing config."""
    def measure(cfg):
        if cfg.get("layout") == "w" and cfg.get("blocks", [0, 0])[1] == 128:
            return float("inf"), 1, "does not fit"
        h = zlib.crc32(json.dumps([workload, cfg], sort_keys=True).encode()) % 1000
        return 1e-5 * (1 + h / 500), 0, ""
    return measure


def _lines(db):
    return [r.to_json() for r in db.records]


def test_records_are_byte_equal_json():
    for args in [("w", {"blocks": [64, 128, 64], "layout": "r"}, 0.0123, 0, "", {"tops": 91.5}),
                 ("w", {"impl": "xla"}, float("inf"), 2, "refused", {}),
                 (CONV, {"bm": 64, "bn": 128}, 1e-3, 4, "output != plain version", {})]:
        line = p_db.TuneRecord(*args).to_json()
        assert line == j_db.TuneRecord(*args).to_json()
        assert p_db.TuneRecord.from_json(line).to_json() == line


def test_features_and_cost_model_equal_the_jax_package():
    rng = np.random.default_rng(0)
    pairs = [(w, c) for w, cs in WORKLOADS.items() for c in cs]
    for w, c in pairs:
        assert np.array_equal(p_model.featurize(w, c), j_model.featurize(w, c)), (w, c)
        assert p_model.parse_workload(w) == j_model.parse_workload(w)
    # the quirk kept with the features: "w" and "r" featurize like no layout
    assert np.array_equal(p_model.featurize(CONV, {"blocks": [64, 64, 64], "layout": "w"}),
                          p_model.featurize(CONV, {"blocks": [64, 64, 64]}))
    times = rng.uniform(0.01, 1.0, len(pairs))
    feats = np.asarray([p_model.featurize(w, c) for w, c in pairs])
    pm, jm = p_model.CostModel(), j_model.CostModel()
    pm.fit(feats, times)
    jm.fit(feats, times)
    np.testing.assert_allclose(pm.predict(feats), jm.predict(feats), rtol=1e-12)
    pdb, jdb = p_db.TuneDatabase(), j_db.TuneDatabase()
    for (w, c), t in zip(pairs, times):
        pdb.add(p_db.TuneRecord(w, c, float(t)))
        jdb.add(j_db.TuneRecord(w, c, float(t)))
    np.testing.assert_allclose(p_model.fit_from_db(pdb).predict(feats),
                               j_model.fit_from_db(jdb).predict(feats), rtol=1e-12)
    assert p_model.rank_candidates(p_model.fit_from_db(pdb), CONV, CONFIGS) == \
        j_model.rank_candidates(j_model.fit_from_db(jdb), CONV, CONFIGS)


def test_schedule_tune_equals_the_jax_package():
    reps, lines = [], []
    for sched, db_mod in ((p_sched, p_db), (j_sched, j_db)):
        tasks = [sched.TuneTask(w, cs, fake_measure(w), lambda t: {"tops": round(1e-6 / t, 2)},
                                weight=i + 1) for i, (w, cs) in enumerate(WORKLOADS.items())]
        db = db_mod.TuneDatabase()
        reps.append(sched.schedule_tune(tasks, db, total_trials=40))
        lines.append(_lines(db))
    assert reps[0] == reps[1] and lines[0] == lines[1]
    assert len(lines[0]) == 40


def test_model_search_equals_the_jax_package():
    out = []
    for model, db_mod in ((p_model, p_db), (j_model, j_db)):
        db = db_mod.TuneDatabase()
        for w, cs in list(WORKLOADS.items())[1:]:     # history: 24+ records to fit a model
            for c in cs:
                t, err, msg = fake_measure(w)(c)
                db.add(db_mod.TuneRecord(w, c, t * 1e3 if err == 0 else float("inf"), err, msg))
        best, trials = model.model_search(CONV, CONFIGS, fake_measure(CONV), db)
        out.append((best.to_json(), trials, _lines(db)))
    assert out[0] == out[1]


def test_evolution_replays_the_jax_trajectory():
    for seed in range(3):
        prng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for cfg in CONFIGS[:6] + GEMM_CONFIGS:
            assert p_evo.mutate(cfg, prng, layouts=True) == j_evo.mutate(cfg, jrng, layouts=True)
            assert p_evo.crossover(cfg, CONFIGS[3], prng) == j_evo.crossover(cfg, CONFIGS[3], jrng)
    out = []
    for evo, db_mod in ((p_evo, p_db), (j_evo, j_db)):
        db = db_mod.TuneDatabase()
        best, n = evo.evolutionary_search(CONV, CONFIGS[:8], fake_measure(CONV), db)
        out.append((best.to_json(), n, _lines(db)))
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def r18_32():
    rng = np.random.default_rng(0)
    jq = j_quantize(j_resnet(18, batch_size=1, image_size=32),
                    [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)])
    return jq, from_reference_graph(jq.to_json())


def test_graph_tasks_find_the_jax_workloads_and_weights(r18_32):
    jq, q = r18_32
    want = [(t.workload, t.weight) for t in j_graph_tasks(j_fuse_qnn(jq))]
    tasks = p_sched.graph_tasks(fuse_qnn(q), device="cpu")
    assert [(t.workload, t.weight) for t in tasks] == want
    assert any(c.get("layout") == "w" for t in tasks for c in t.configs)


def test_wrong_answer_is_recorded_and_never_best(monkeypatch):
    from tachikoma_tpu_torch.ops.kernels import conv

    real = conv.qconv_rq_t
    monkeypatch.setattr(conv, "qconv_rq_t", lambda *a, **k: real(*a, **k) ^ 1)
    wl, configs, measure, meta_fn, _ = p_tuner.conv_flat_task(
        (1, 9, 9, 16), (3, 3, 16, 16), (2, 2), (1, 1, 1, 1), 1, device="cpu")
    db = p_db.TuneDatabase()
    for cfg in configs[:5]:
        t, err, msg = measure(cfg)
        assert err == (p_db.WRONG_ANSWER if cfg.get("layout") == "t" else p_db.NO_ERROR), cfg
        db.add(p_db.TuneRecord(wl, cfg, 1e-9 if err else t * 1e3, err, msg))
    assert db.best(wl).config.get("layout") != "t"
    # a reading above the H100's int8 peak is recorded, never served
    db.add(p_db.TuneRecord(wl, {"blocks": [64, 64, 64], "layout": "s"}, 1e-12,
                           meta={"tops": 1979.5}))
    assert db.best(wl).config.get("layout") != "s" or db.best(wl).time_ms > 1e-12
    assert p_db.TuneDatabase.MAX_CREDIBLE_TOPS == 1979.0


def test_tune_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_tuner.matmul_task(64, 64, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_tuner.conv_chain_task(1, 8, 8, [(3, 16, 16)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_tuner.tune_conv((1, 8, 8, 16), (3, 3, 16, 16), (1, 1), (1, 1, 1, 1), 1,
                          p_db.TuneDatabase())
    wl, configs, measure, _, _ = p_tuner.matmul_task(20, 64, 24, device="cpu")
    assert configs[-1] == {"impl": "xla"} and all(measure(c)[1] == 0 for c in configs)


def test_cli_tunes_then_serves_the_database(r18_32, tmp_path, monkeypatch, capsys):
    from tachikoma_tpu_torch import cli
    from tachikoma_tpu_torch.runtime.artifact import load_artifact

    _, q = r18_32
    g, db = tmp_path / "g.json", tmp_path / "x.jsonl"
    g.write_text(q.to_json())
    with pytest.raises(SystemExit, match="--db is required"):
        cli.main(["tune", str(g), "--device", "cpu"])
    cli.main(["tune", str(g), "--db", str(db), "--budget", "8", "--device", "cpu"])
    lines = db.read_text().splitlines()
    assert len(lines) == 8 and all(p_db.TuneRecord.from_json(s).error_no == 0 for s in lines)
    monkeypatch.delenv("TK_TUNE_DB", raising=False)
    p_db.reset_default_database()
    cli.main(["run", str(g), "--device", "cpu", "-o", str(tmp_path / "a.npz")])
    # force a layout on every 3x3 conv that was tuned, then serve the database
    with open(db, "a") as f:
        for s in lines:
            rec = p_db.TuneRecord.from_json(s)
            if "_K3x3_" in rec.workload:
                f.write(p_db.TuneRecord(rec.workload, {"blocks": [64, 64, 64], "layout": "r"},
                                        0.0).to_json() + "\n")
    monkeypatch.setenv("TK_TUNE_DB", str(db))
    p_db.reset_default_database()
    try:
        cli.main(["run", str(g), "--device", "cpu", "-o", str(tmp_path / "b.npz")])
        cli.main(["compile", str(g), "-o", str(tmp_path / "m.tkmod")])
    finally:
        p_db.reset_default_database()
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    assert load_artifact(str(tmp_path / "m.tkmod"))[1]["_tune_jsonl"] == db.read_text()
