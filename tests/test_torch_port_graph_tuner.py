"""The port's graph tuner on the CPU, against the JAX package's
`tune/graph_tuner.py`, on the same quantized graphs: the JAX test's
two-chain model and VGG-11 at 32^2.

chain_runs are equal; apply_variant's fused graph has the JAX variant's
structural hash for each single flip and for all flips, and its integer
outputs under TorchExecutor(device="cpu") == the JAX run_graph's; with one
stub measurer, tune_graph's result and database lines are equal."""

import numpy as np
import pytest
import torch

from tachikoma_tpu import GraphBuilder, infer_types, run_graph
from tachikoma_tpu.models.vision import vgg as j_vgg
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.tune import database as j_db
from tachikoma_tpu.tune import graph_tuner as j_gt
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.tune import database as p_db
from tachikoma_tpu_torch.tune import graph_tuner as p_gt


def _two_chain_model(rng):
    """tests/test_graph_tuner.py's model: a two-conv run, a pool, a
    three-conv run."""
    b = GraphBuilder()
    x = b.var("x", (1, 12, 12, 8), "float32")

    def conv(src, cin, cout, name):
        w = b.const(rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.2, name + "_w")
        c = b.call("nn.conv2d", src, w, padding=(1, 1, 1, 1), name=name)
        return b.call("nn.relu", c)

    h = conv(conv(x, 8, 8, "c1"), 8, 8, "c2")
    h = b.call("nn.max_pool2d", h, pool_size=(2, 2), strides=(2, 2))
    h = conv(conv(conv(h, 8, 16, "c3"), 16, 16, "c4"), 16, 8, "c5")
    return infer_types(b.build(h))


@pytest.fixture(scope="module", params=["two_chain", "vgg11"])
def model(request):
    rng = np.random.default_rng(0)
    if request.param == "two_chain":
        g = _two_chain_model(rng)
        x = rng.standard_normal((1, 12, 12, 8)).astype(np.float32)
        n_runs = 2
    else:
        g = j_vgg(11, image_size=32)
        x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
        n_runs = 3
    jq = j_quantize(g, [x])
    return jq, from_reference_graph(jq.to_json()), x, n_runs


def test_chain_runs_and_variants_equal_the_jax_package(model):
    jq, q, x, n_runs = model
    jfused, fused = j_fuse_qnn(jq), fuse_qnn(q)
    runs = p_gt.chain_runs(fused)
    assert runs == j_gt.chain_runs(jfused) and len(runs) == n_runs
    assert p_gt.apply_variant(q, fused, set()) is fused
    for disabled in [{r} for r in runs] + [set(runs)]:
        v = p_gt.apply_variant(q, fused, disabled)
        jv = j_gt.apply_variant(jq, jfused, disabled)
        assert v.structural_hash() == jv.structural_hash(), disabled
        chains = sum(n.op == "tk.conv2d_chain" for n in v.nodes)
        assert chains == n_runs - len(disabled)
        names = [n.name for n in v.nodes if n.op not in ("var", "const")]
        got = TorchExecutor(v, capture=names, device="cpu").run(x)
        want = {}
        run_graph(jv, x, intercept=lambda name, op, args, out: want.__setitem__(name, out))
        n_int = 0
        for name, a in zip(names, got):
            b = np.asarray(want[name])
            if a.dtype.kind in "iu":
                assert a.dtype == b.dtype and np.array_equal(a, b), (disabled, name)
                n_int += 1
        assert n_int >= 2 * n_runs


def test_tune_graph_equals_the_jax_package(model, tmp_path):
    jq, q, _, n_runs = model
    runs = p_gt.chain_runs(fuse_qnn(q))
    slow = runs[0]

    def measure(graph):
        chains = [n.name for n in graph.nodes if n.op == "tk.conv2d_chain"]
        return 1.0 + (0.5 if slow in chains else 0.0) + (0.3 if runs[1] not in chains else 0.0)

    pdb = p_db.TuneDatabase(str(tmp_path / "p.jsonl"))
    jdb = j_db.TuneDatabase(str(tmp_path / "j.jsonl"))
    res = p_gt.tune_graph(q, measure, db=pdb, verbose=False, device="cpu")
    jres = j_gt.tune_graph(jq, measure, db=jdb, verbose=False)
    assert res.__dict__ == jres.__dict__
    assert res.best_disabled == [slow] and res.trials == n_runs + 1
    assert [r.to_json() for r in pdb.records] == [r.to_json() for r in jdb.records]
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert pdb.records[0].workload == f"graph/{q.structural_hash()[:16]}"


def test_tune_graph_needs_a_card_unless_asked_for_the_cpu(model, monkeypatch):
    _, q, _, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_gt.tune_graph(q, lambda g: 1.0, verbose=False)
    assert p_gt.tune_graph(q, lambda g: 1.0, verbose=False, device="cpu").best_disabled == []
