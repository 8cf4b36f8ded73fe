"""The port's per-op placement on the CPU, against the JAX package's
(`tests/test_placement.py`'s graphs): `plan_devices` gives the JAX
package's dicts, and `HeterogeneousExecutor` over torch devices (here
`("cpu",) * n`, so every boundary is still split and counted) equals the
single-device executor, the oracle and the JAX package's executor."""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.runtime.placement import HeterogeneousExecutor as JHeterogeneousExecutor
from tachikoma_tpu.runtime.placement import plan_devices as j_plan_devices
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.placement import HeterogeneousExecutor, plan_devices

CPUS = ("cpu",) * 8


def two_stage_mlp(builder, infer, seed=0):
    rng = np.random.default_rng(seed)
    b = builder()
    x = b.var("x", (4, 16), "float32")
    w1 = b.const(rng.standard_normal((16, 32)).astype(np.float32) * 0.1, "w1")
    h = b.call("nn.dense", x, w1, name="fc1")
    r = b.call("nn.relu", h, name="act1")
    w2 = b.const(rng.standard_normal((32, 8)).astype(np.float32) * 0.1, "w2")
    d2 = b.call("nn.dense", r, w2, name="fc2")
    b.annotate("fc2", device=1)
    s = b.call("nn.softmax", d2, name="out")
    return infer(b.build(s))


def int_graph(builder, infer, seed=1):
    rng = np.random.default_rng(seed)
    b = builder()
    x = b.var("x", (2, 64), "int8")
    w1 = b.const(rng.integers(-127, 127, (64, 64)).astype(np.int8), "w1")
    d1 = b.call("nn.dense", x, w1, out_dtype="int32", name="d1")
    r = b.call("right_shift", d1, b.const(np.int32(4)), name="rs")
    c = b.call("clip", r, a_min=-128, a_max=127, name="cl")
    q = b.call("cast", c, dtype="int8", name="q8")
    b.annotate("q8", device=2)
    w2 = b.const(rng.integers(-127, 127, (64, 16)).astype(np.int8), "w2")
    d2 = b.call("nn.dense", q, w2, out_dtype="int32", name="d2")
    return infer(b.build(d2))


@pytest.mark.parametrize("make", [two_stage_mlp, int_graph])
def test_plan_equals_the_jax_package(make):
    g, jg = make(GraphBuilder, infer_types), make(JGraphBuilder, j_infer_types)
    plan = plan_devices(g)
    assert plan == j_plan_devices(jg)
    assert plan_devices(g, default_device=3) == j_plan_devices(jg, default_device=3)
    if make is two_stage_mlp:
        assert plan["fc1"] == 0 and plan["act1"] == 0 and plan["fc2"] == 1
        assert plan["out"] == 1 and plan["w2"] == 1 and plan["w1"] == 0


def test_heterogeneous_matches_single_device():
    g = two_stage_mlp(GraphBuilder, infer_types)
    jg = two_stage_mlp(JGraphBuilder, j_infer_types)
    x = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    hx = HeterogeneousExecutor(g, devices=CPUS)
    got = hx.run({"x": x})
    jhx = JHeterogeneousExecutor(jg)
    jgot = jhx.run({"x": x})
    assert len(hx.segments) == len(jhx.segments) == 2
    assert [(d, [n.name for n in ns]) for d, ns in hx.segments] == \
        [(d, [n.name for n in ns]) for d, ns in jhx.segments]
    assert hx.transfers == jhx.transfers >= 1   # the stage boundary moved a tensor
    want = TorchExecutor(g, device="cpu").run({"x": x})
    for a, b, c, o in zip(got, want, jgot, j_run_graph(jg, {"x": x})):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, o, rtol=1e-5, atol=1e-6)


def test_integer_graph_exact_across_devices():
    g = int_graph(GraphBuilder, infer_types)
    jg = int_graph(JGraphBuilder, j_infer_types)
    x = np.random.default_rng(3).integers(-127, 127, (2, 64)).astype(np.int8)
    hx = HeterogeneousExecutor(g, devices=CPUS)
    got = hx.run({"x": x})[0]
    jhx = JHeterogeneousExecutor(jg)
    assert (got == run_graph(g, {"x": x})[0]).all()
    assert (got == np.asarray(jhx.run({"x": x})[0])).all()
    assert (got == j_run_graph(jg, {"x": x})[0]).all()
    assert hx.transfers == jhx.transfers


@pytest.mark.parametrize("op,a,b", [
    ("right_shift", np.array([5, -5, 1 << 30, -(1 << 30), 7, -7], np.int32),
     np.array([0, 1, 31, 32, 33, 2], np.int32)),
    ("left_shift", np.array([5, -5, 64, -128], np.int8), np.array([1, 7, 8, 2], np.int8)),
    ("bitwise_and", np.arange(-8, 8, dtype=np.int16), np.full(16, 0x5A, np.int16)),
    ("bitwise_or", np.arange(-8, 8, dtype=np.int32), np.full(16, 3, np.int8)),
    ("bitwise_xor", np.arange(16, dtype=np.uint8), np.full(16, 0xF0, np.uint8)),
])
def test_bitwise_ops_equal_the_jax_package(op, a, b):
    from tachikoma_tpu.runtime.executor import JaxExecutor

    graphs = []
    for builder, infer in ((GraphBuilder, infer_types), (JGraphBuilder, j_infer_types)):
        bb = builder()
        graphs.append(infer(bb.build(bb.call(op, bb.var("a", a.shape, str(a.dtype)),
                                             bb.var("b", b.shape, str(b.dtype)), name="y"))))
    g, jg = graphs
    feeds = {"a": a, "b": b}
    want = j_run_graph(jg, feeds)[0]
    for got in (run_graph(g, feeds)[0], TorchExecutor(g, device="cpu").run(feeds)[0],
                np.asarray(JaxExecutor(jg).run(feeds)[0])):
        assert got.dtype == want.dtype and (got == want).all()


def test_bitwise_not_equals_the_jax_package():
    a = np.arange(-4, 4, dtype=np.int8)
    b = GraphBuilder()
    g = infer_types(b.build(b.call("bitwise_not", b.var("a", a.shape, "int8"))))
    jb = JGraphBuilder()
    jg = j_infer_types(jb.build(jb.call("bitwise_not", jb.var("a", a.shape, "int8"))))
    want = j_run_graph(jg, [a])[0]
    assert (run_graph(g, [a])[0] == want).all()
    assert (TorchExecutor(g, device="cpu").run([a])[0] == want).all()


def test_embeddings_on_host_equals_one_device():
    """The CPU-offload layout of an int8 BERT's embedding table (two device
    ids, both the CPU here; on the card ("cuda:0", "cpu")): one boundary
    copy, outputs == the single-device executor and the oracle."""
    from tachikoma_tpu_torch.models.transformer import bert
    from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
    from tachikoma_tpu_torch.runtime.placement import embeddings_on_host

    g = bert(batch_size=2, seq_len=16, hidden=32, layers=2, heads=4, ffn_dim=64, vocab=100,
             seed=0)
    x = np.random.default_rng(3).integers(0, 100, (2, 16)).astype(np.int32)
    q = fuse_qnn(quantize(g, [x], TRANSFORMER_INT8))
    placed = embeddings_on_host(q)
    plan = plan_devices(placed)
    assert plan["embed_tok"] == 1 and plan["tok_emb"] == 1 and plan["input_ids"] == 1
    assert plan["embed_tok_q"] == 0 and plan[q.outputs[0]] == 0
    hx = HeterogeneousExecutor(placed, devices=("cpu", "cpu"))
    got = hx.run(x)
    assert hx.transfers == 1 and [d for d, _ in hx.segments] == [1, 0]
    for a, b, o in zip(got, TorchExecutor(q, device="cpu").run(x), run_graph(q, x)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, o, rtol=1e-5, atol=1e-6)


def test_unannotated_graph_single_segment_and_a_missing_card(monkeypatch):
    b = GraphBuilder()
    g = infer_types(b.build(b.call("tanh", b.var("x", (3, 5), "float32"))))
    hx = HeterogeneousExecutor(g, devices=("cpu",))
    hx.run([np.ones((3, 5), np.float32)])
    assert len(hx.segments) == 1 and hx.transfers == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, ("cuda:0", "cpu")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HeterogeneousExecutor(g, devices=devices)
