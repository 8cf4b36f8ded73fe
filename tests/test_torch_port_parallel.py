"""The port's parallel/* on the CPU, against the JAX package.

Four spawned ranks share one gloo process group, initialized through
`init_process_group` over a file store under the test's temporary directory
(`parallel/gather.py launch`; xdist workers share no port).  The ranks run
tests/parallel_cases.py (no jax) on the port's int8 LeNet-5 b8 and ResNet-18
b4 32^2, passed to them as .tkmod files; this process holds their results
against the JAX package:

- ShardedExecutor's integer captures over {"dp": 4}, {"dp": 2, "tp": 2} and
  {"tp": 4} == the numpy oracle, and for LeNet-5 == the JAX ShardedExecutor
  on its 8-device CPU mesh; every rank holds the same global values;
- ShardedTraceEmitter's bytes == the port's single-device TraceEmitter's and,
  integer records byte for byte, the JAX package's (float records within
  rtol 1e-5, atol 1e-6, tests/test_gather.py's rule); a step failing twice
  is retried into the same bytes;
- split_stages == the JAX package's stages; the pipeline at 2-3 stages x 1, 2,
  4 microbatches == the oracle; MoE at ep 2 and 4 == the reference and the
  JAX moe_dense_int8; ring attention at sp 2 and 4 == qnn.attention's oracle
  and the JAX ring_attention_int8 on its mesh.
"""

import io
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tachikoma_tpu import GraphBuilder as JGraphBuilder
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.models import vision as jv
from tachikoma_tpu.parallel.mesh import simple_mesh as j_simple_mesh
from tachikoma_tpu.parallel.moe import moe_dense_int8 as j_moe_dense_int8
from tachikoma_tpu.parallel.pipeline import split_stages as j_split_stages
from tachikoma_tpu.parallel.ring_attention import ring_attention_int8 as j_ring_attention_int8
from tachikoma_tpu.parallel.shard import ShardedExecutor as JShardedExecutor
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.trace.emitter import TraceEmitter as JTraceEmitter
from tachikoma_tpu.trace.format import TraceReader
from tachikoma_tpu_torch.ir.graph import Graph
from tachikoma_tpu_torch.models import vision as pv
from tachikoma_tpu_torch.parallel.gather import _with_retry, init_distributed, launch
from tachikoma_tpu_torch.parallel.mesh import simple_mesh
from tachikoma_tpu_torch.parallel.moe import moe_dense_int8_reference
from tachikoma_tpu_torch.parallel.pipeline import PipelineExecutor, split_stages
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.artifact import save_artifact
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.trace.emitter import TraceEmitter

from parallel_cases import (EXPERTS, MESHES, RINGS, SCALES, _key,  # tests/, no jax
                            default_group, failing, forced_row_parallel, integer_nodes,
                            moe_case, parallel_round, ring_case, world_of_one)

WORLD = 4
MODELS = {"lenet5": (lambda pkg: pkg.lenet5(batch_size=8), (8, 28, 28, 1)),
          "resnet18": (lambda pkg: pkg.resnet(18, batch_size=4, image_size=32), (4, 32, 32, 3))}


def _models():
    out = {}
    for name, (build, shape) in MODELS.items():
        rng = np.random.default_rng(0)
        data = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        out[name] = (quantize(build(pv), data), j_quantize(build(jv), data), data[0])
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    """The four ranks' results of tests/parallel_cases.py parallel_round."""
    tmp = tmp_path_factory.mktemp("parallel")
    artifacts = {}
    for name, (q, _, _) in models.items():
        artifacts[name] = str(tmp / f"{name}.tkmod")
        save_artifact(artifacts[name], q)
    feeds = {name: x for name, (_, _, x) in models.items()}
    return launch(WORLD, parallel_round, (artifacts, feeds, moe_case(), ring_case()),
                  init_method=f"file://{tmp / 'store'}", timeout=300)


def _oracle(jq, x):
    values = {}
    j_run_graph(jq, x, intercept=lambda name, op, ins, out: values.__setitem__(name, out))
    return values


@pytest.mark.parametrize("axes", MESHES, ids=_key)
@pytest.mark.parametrize("model", list(MODELS))
def test_sharded_integer_captures_equal_oracle(ranks, models, model, axes):
    q, jq, x = models[model]
    got = ranks[0]["captures"][(model, _key(axes))]
    want = _oracle(jq, x)
    names = integer_nodes(q)
    assert names
    for name in names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    out = q.outputs[0]
    np.testing.assert_allclose(got[out], want[out], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got[out], TorchExecutor(q, device="cpu").run(x)[0])


@pytest.mark.parametrize("axes", MESHES, ids=_key)
def test_sharded_captures_equal_jax_sharded_executor(ranks, models, axes):
    q, jq, x = models["lenet5"]
    names = integer_nodes(q)
    want = JShardedExecutor(jq, j_simple_mesh(axes), capture=names).run(x)
    got = ranks[0]["captures"][("lenet5", _key(axes))]
    for name, w in zip(names, want):
        np.testing.assert_array_equal(got[name], np.asarray(w), err_msg=name)


@pytest.mark.parametrize("axes", MESHES, ids=_key)
@pytest.mark.parametrize("model", list(MODELS))
def test_every_rank_holds_the_global_values(ranks, model, axes):
    digests = {r["digests"][(model, _key(axes))] for r in ranks}
    assert len(digests) == 1


@pytest.mark.parametrize("model", list(MODELS))
def test_plans(ranks, model):
    plans = {_key(a): ranks[0]["plans"][(model, _key(a))] for a in MESHES}
    assert set(plans["dp4"]["products"]) == {"whole"}
    assert plans["dp4"]["collectives"]["all_reduce"] == 0
    for key in ("dp2,tp2", "tp4"):
        assert plans[key]["products"].get("row", 0) >= 1
        assert plans[key]["products"].get("col", 0) >= 1
        assert plans[key]["collectives"]["all_reduce"] >= 1
    assert "tp_all_gather" not in plans["dp4"]["collectives"]
    assert "dp_all_gather" not in plans["tp4"]["collectives"]


@pytest.mark.parametrize("axes", MESHES, ids=_key)
def test_sharded_trace_bytes(ranks, models, axes):
    q, jq, x = models["lenet5"]
    sharded = ranks[0]["traces"][("lenet5", _key(axes))]
    assert sharded == TraceEmitter(q, backend="torch", device="cpu").emit_bytes(x)
    r1 = TraceReader(io.BytesIO(JTraceEmitter(jq, backend="oracle").emit_bytes(x)))
    r2 = TraceReader(io.BytesIO(sharded))
    assert len(r1) == len(r2)
    for rec1, rec2 in zip(r1, r2):
        if rec1.output.dtype.startswith(("int", "uint")):
            assert rec1.encode() == rec2.encode(), rec1.name
        else:
            np.testing.assert_allclose(rec1.output.to_array(), rec2.output.to_array(),
                                       rtol=1e-5, atol=1e-6)


def test_retry_recovers_and_exhausts(ranks):
    blob, records = ranks[0]["retried"]
    assert blob == ranks[0]["traces"][("lenet5", "dp2,tp2")]
    assert all(r["retried"][1] == records for r in ranks)
    assert all(r["retried"][0] is None for r in ranks[1:])
    msg, cause = ranks[0]["exhausted"]
    assert "failed after 2 attempts" in msg and cause == "ZeroDivisionError"
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return 42

    assert _with_retry(flaky, "test", retries=3, backoff=0.0) == 42 and calls["n"] == 3


def test_meshes_and_members(ranks):
    assert [r["member"] for r in ranks] == [True, True, False, False]
    assert [r["non_member_raises"] for r in ranks] == [False, False, True, True]
    assert [r["coordinator"] for r in ranks] == [True, False, False, False]
    for rank, r in enumerate(ranks):
        names, axes, coords = r["topology"]
        assert names == ("dp", "tp", "pp", "sp") and axes == {"dp": 2, "tp": 2, "pp": 1, "sp": 1}
        assert coords == {"dp": rank // 2, "tp": rank % 2, "pp": 0, "sp": 0}
        assert r["too_big"] == "mesh needs 16 devices, have 4"


@pytest.mark.parametrize("ep", EXPERTS)
def test_moe_equals_reference(ranks, ep):
    x, w, gate = moe_case()
    want = moe_dense_int8_reference(x, w, gate)
    assert len(set(gate.tolist())) > 1
    for r in ranks[:ep]:
        np.testing.assert_array_equal(r["moe"][ep], want)
        # a kept ExpertParallelDense, called again on the tokens reversed
        np.testing.assert_array_equal(r["moe_kept"][ep][0], want)
        np.testing.assert_array_equal(r["moe_kept"][ep][1], want[::-1])
    np.testing.assert_array_equal(
        ranks[0]["moe"][ep], np.asarray(j_moe_dense_int8(x, w, gate, j_simple_mesh({"ep": ep}))))


@pytest.mark.parametrize("sp", RINGS)
def test_ring_attention_equals_jax(ranks, sp):
    q, k, v = ring_case()
    b = JGraphBuilder()
    qn, kn, vn = (b.var(n, q.shape, "int8") for n in "qkv")
    g = j_infer_types(b.build(b.call("qnn.attention", qn, kn, vn, **SCALES)))
    oracle = j_run_graph(g, {"q": q, "k": k, "v": v})[0]
    jring = np.asarray(j_ring_attention_int8(q, k, v, j_simple_mesh({"sp": sp}), **SCALES))
    for r in ranks[:sp]:
        got, stats = r["ring"][sp]
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(got, jring)
        # one ring step per phase and rank, then the context's all-gather
        assert stats["send_recv"]["calls"] == 3 * sp and stats["all_gather"]["calls"] == 1


def test_forced_row_parallel_dense(tmp_path):
    """tests/test_shard.py test_collectives_inserted: dense weights split on
    K force an int32 all-reduce; the output equals the oracle's."""
    g, jg = pv.mlp(batch_size=8, hidden=(64,), in_dim=64, num_classes=8), \
        jv.mlp(batch_size=8, hidden=(64,), in_dim=64, num_classes=8)
    rng = np.random.default_rng(0)
    data = [rng.standard_normal((8, 64)).astype(np.float32) for _ in range(2)]
    q, jq = quantize(g, data), j_quantize(jg, data)
    path = str(tmp_path / "mlp.tkmod")
    save_artifact(path, q)
    res = launch(2, forced_row_parallel, (path, data[0]),
                 init_method=f"file://{tmp_path / 'store'}", timeout=120)
    want = j_run_graph(jq, data[0])[0]
    for out, plan, specs, stats in res:
        assert specs
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-7)
        assert plan["collectives"]["all_reduce"] == plan["products"]["row"] >= 1
        assert stats["all_reduce"]["calls"] == plan["collectives"]["all_reduce"]


def test_launch_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="exited with code 1"):
        launch(2, failing, init_method=f"file://{tmp_path / 'store'}", timeout=60)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_over_a_tcp_coordinator():
    """The reference's signature: a "host:port" coordinator, the process
    count and this process's id; the default group is gloo, one process
    included.  Without a coordinator it makes none."""
    assert not dist.is_initialized()
    init_distributed()
    assert not dist.is_initialized()
    init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        assert (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == ("gloo", 1, 0)
        init_distributed("localhost:1", 2, 1)  # already initialized: no-op
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_launch_ranks_share_a_gloo_group_over_tcp():
    assert launch(2, default_group, init_method=f"localhost:{_free_port()}",
                  timeout=120) == [("gloo", 2, [3, 3, 3])] * 2


def test_launch_makes_a_group_of_one_rank(tmp_path):
    assert launch(1, world_of_one, init_method=f"file://{tmp_path / 'store'}",
                  timeout=60) == [(1, True, True)]


@pytest.mark.parametrize("num_stages", [2, 3, 4])
@pytest.mark.parametrize("model", list(MODELS))
def test_split_stages_equal_reference(models, model, num_stages):
    q, jq, _ = models[model]
    got, want = split_stages(q, num_stages), j_split_stages(jq, num_stages)
    assert [(s.inputs, s.outputs) for s in got] == [(s.inputs, s.outputs) for s in want]
    assert [s.graph.structural_bytes(include_params=True) for s in got] == \
        [s.graph.structural_bytes(include_params=True) for s in want]


@pytest.mark.parametrize("num_stages,micro", [(2, 1), (2, 2), (2, 4), (3, 1), (3, 2), (3, 4)])
def test_pipeline_equals_oracle(models, num_stages, micro):
    q, jq, x = models["lenet5"]
    pe = PipelineExecutor(q, num_stages, devices=["cpu"] * num_stages)
    got = pe.run(x, num_microbatches=micro)
    np.testing.assert_allclose(got[0], j_run_graph(jq, x)[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got[0], TorchExecutor(q, device="cpu").run(x)[0])
    assert pe.intervals() == []  # the stages ran in order on the CPU


def test_pipeline_integer_output_and_errors(models, monkeypatch):
    q, jq, x = models["resnet18"]
    names = integer_nodes(q)
    last = names[-1]  # the int8 logits
    head = Graph(list(q.nodes), [last], dict(q.params), q.name)
    got = PipelineExecutor(head, 3, devices=["cpu", "cpu", "cpu"]).run(x, num_microbatches=4)
    np.testing.assert_array_equal(got[0], _oracle(jq, x)[last])
    with pytest.raises(ValueError, match="stages need that many devices"):
        PipelineExecutor(q, 4, devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineExecutor(q, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simple_mesh({"dp": 1}, backend="gloo")
