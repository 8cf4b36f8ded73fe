"""nn.batch_norm's torch impl against the JAX package's numpy oracle, bit for
bit on the CPU.

torch's CPU float32 `sqrt` is not correctly rounded on every input (an ulp
off on about 0.5% of uniform values in [0.5, 2)), so the port takes the sqrt
and the division of 1 / sqrt(var + eps) in float64 and rounds each once to
float32, as the oracle's float32 operations round them.  The first test
feeds variances where torch's float32 sqrt misses; the second holds every
batch-norm node of DenseNet's and ResNet3D-18's quantized graphs == the
oracle's at the vision-zoo tests' sizes.
"""

import numpy as np
import pytest
import torch

from tachikoma_tpu import GraphBuilder as JGraphBuilder
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.models import vision as jv
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu_torch import GraphBuilder
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.models import vision as pv
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

EPS = 1e-5


def _sqrt_misses(n: int) -> np.ndarray:
    """Variances v whose float32 v + eps has a float32 torch.sqrt that
    differs from numpy's (correctly rounded) float32 sqrt."""
    rng = np.random.default_rng(0)
    v = rng.uniform(0.5, 2.0, 1 << 16).astype(np.float32)
    t = v + np.float32(EPS)
    miss = torch.sqrt(torch.from_numpy(t)).numpy() != np.sqrt(t)
    return v[miss][:n]


def _bn_graph(builder, var: np.ndarray):
    c = var.shape[0]
    rng = np.random.default_rng(1)
    b = builder("bn")
    x = b.var("x", (2, 3, 3, c), "float32")
    ins = [b.const(a.astype(np.float32), name=nm) for nm, a in (
        ("gamma", rng.uniform(0.5, 2.0, c)), ("beta", rng.standard_normal(c)),
        ("mean", rng.standard_normal(c) * 0.1), ("var", var))]
    return b.build(b.call("nn.batch_norm", x, *ins, epsilon=EPS, axis=-1))


def test_batch_norm_equals_oracle_where_torch_sqrt_misses():
    var = np.concatenate([_sqrt_misses(31), [np.float32(1.0478698) - np.float32(EPS)]])
    var = var.astype(np.float32)
    t = var + np.float32(EPS)
    assert (torch.sqrt(torch.from_numpy(t)).numpy() != np.sqrt(t)).sum() >= 16
    x = np.random.default_rng(2).standard_normal((2, 3, 3, var.shape[0])).astype(np.float32)
    want = j_run_graph(_bn_graph(JGraphBuilder, var), x)[0]
    got = TorchExecutor(_bn_graph(GraphBuilder, var), device="cpu").run(x)[0]
    np.testing.assert_array_equal(got, want)


ZOO = {"densenet": {"image_size": 32, "blocks": (2, 2, 2, 2), "growth": 8},
       "resnet_3d": {"frames": 2, "image_size": 8}}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_batch_norm_nodes_equal_oracle(name):
    """Each batch-norm node of the quantized graph, fed the oracle's inputs
    of that node (ResNet3D-18's come from a float conv3d, which the oracle
    sums in float64), == the oracle's output."""
    g, jg = getattr(pv, name)(**ZOO[name]), getattr(jv, name)(**ZOO[name])
    rng = np.random.default_rng(7)
    feeds = [{n.name: rng.standard_normal(n.shape).astype(np.float32) for n in g.inputs}
             for _ in range(2)]
    q, jq = quantize(g, [feeds[0]]), j_quantize(jg, [feeds[0]])
    seen = {}

    def record(nm, op, ins, out):
        if op == "nn.batch_norm":
            seen[nm] = (ins, out)

    j_run_graph(jq, feeds[1], intercept=record)
    assert len(seen) >= 12
    impl = get_op("nn.batch_norm").torch_impl
    for nm, (ins, want) in seen.items():
        got = impl(*[torch.from_numpy(np.asarray(a)) for a in ins], node=q[nm]).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {nm}")
