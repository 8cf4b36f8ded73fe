"""The port's BucketedExecutor on the CPU, against the JAX package's
(`tests/test_bucketed.py`'s graph and sizes): one executor per bucket, a
padded run equals an exact-shape run of the port and of the JAX package's
`run_graph_jax` at every batch, integers with ==."""

import numpy as np
import pytest
import torch

from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.bucketed import BucketedExecutor as JBucketedExecutor
from tachikoma_tpu.runtime.executor import run_graph_jax
from tachikoma_tpu_torch.ir.graph import GraphBuilder
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.bucketed import BucketedExecutor
from tachikoma_tpu_torch.runtime.executor import TorchExecutor


def _model(builder, seed=0):
    rng = np.random.default_rng(seed)
    b = builder("dyn")
    x = b.var("x", (1, 8, 8, 4), "float32")
    w = b.const(rng.standard_normal((3, 3, 4, 8)).astype(np.float32) * 0.2)
    h = b.call("nn.conv2d", x, w, strides=(1, 1), padding=(1, 1, 1, 1))
    h = b.call("nn.relu", h)
    h = b.call("nn.global_avg_pool2d", h)
    h = b.call("nn.batch_flatten", h)
    w2 = b.const(rng.standard_normal((8, 5)).astype(np.float32) * 0.2)
    h = b.call("nn.dense", h, w2)
    return b.build([h])


def _x(batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, 8, 8, 4)).astype(np.float32)


def test_bucketed_matches_exact():
    ex = BucketedExecutor(_model(GraphBuilder), buckets=(2, 4, 8), device="cpu")
    jex = JBucketedExecutor(_model(JGraphBuilder), buckets=(2, 4, 8))
    for i, batch in enumerate((1, 2, 3, 4, 3, 7, 2)):
        x = _x(batch, i)
        got = ex.run([x])[0]
        assert got.shape[0] == batch
        want = TorchExecutor(ex._graph_for(batch), device="cpu").run([x])[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, run_graph_jax(jex._graph_for(batch), [x])[0],
                                   rtol=1e-5, atol=1e-5)
    # 7 batch sizes, only 3 distinct buckets built (2, 4, 8)
    assert ex.compiled_buckets == [2, 4, 8]
    assert ex._graph_for(3).to_json() == jex._graph_for(3).to_json()


def test_bucketed_overflow_batch():
    ex = BucketedExecutor(_model(GraphBuilder), buckets=(2,), device="cpu")
    out = ex.run([_x(5, 0)])[0]
    assert out.shape[0] == 5
    assert ex.compiled_buckets == [5]


@pytest.mark.parametrize("batch,buckets", [(3, (4,)), (1, (1, 2, 4, 8)), (3, (1, 2, 4, 8)),
                                           (8, (1, 2, 4, 8))])
def test_bucketed_quantized_bitexact(batch, buckets):
    data = [_x(1, 10)]
    qg = quantize(_model(GraphBuilder), data)
    jqg = j_quantize(_model(JGraphBuilder), data)
    assert qg.to_json() == jqg.to_json()
    ex = BucketedExecutor(qg, buckets=buckets, device="cpu", fuse=True)
    x = _x(batch, 11)
    got = ex.run({"x": x})[0]
    want = run_graph_jax(JBucketedExecutor(jqg)._graph_for(batch), [x])[0]
    # integer interior: padded rows cannot perturb real rows
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TorchExecutor(ex._graph_for(batch), device="cpu", fuse=True).run([x])[0])


def test_bucketed_refuses_an_aggregate_output_and_a_missing_card(monkeypatch):
    b = GraphBuilder()
    x = b.var("x", (1, 4), "float32")
    g = b.build(b.call("sum", x, axis=None))
    with pytest.raises(ValueError, match="no batch axis"):
        BucketedExecutor(g, buckets=(4,), device="cpu").run([np.ones((3, 4), np.float32)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BucketedExecutor(_model(GraphBuilder))
