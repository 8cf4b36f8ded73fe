"""The six ops the TensorFlow importer emits that the port had no torch impl
for (rsqrt, floor_divide, floor_mod, all, any, stack), on the CPU, against
the JAX package: each case of tests/tf_op_cases.py builds the same one-op
graph in both packages (equal JSON: the relations agree) and runs the JAX
package's oracle, its jax impl (where it agrees with the oracle), the port's
oracle and the port's torch impl, held with == (every op here is exact: an
integer op, a comparison or one correctly rounded float32 operation)."""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import all_ops as j_all_ops
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import all_ops, get_op
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

from tf_op_cases import CASES

TF_OPS = ("rsqrt", "floor_divide", "floor_mod", "all", "any", "stack")


def _one_op(builder, infer, op, inputs, attrs):
    b = builder("t")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    return infer(b.build(b.call(op, *names, name="y", **attrs)))


def _held(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        f"{what}: {got.dtype}{got.shape} != {want.dtype}{want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=what)
    if want.dtype.kind == "f":  # a zero's sign too (NaN's sign is no value)
        seen = ~np.isnan(want)
        np.testing.assert_array_equal(np.signbit(got)[seen], np.signbit(want)[seen],
                                      err_msg=what)


@pytest.mark.parametrize("op,inputs,attrs,tol,jax,n_out,graph",
                         [pytest.param(*c[1:], id=c[0]) for c in CASES])
def test_tf_op_matches_reference_oracle(op, inputs, attrs, tol, jax, n_out, graph):
    feeds = {f"x{i}": x for i, x in enumerate(inputs)}
    with np.errstate(all="ignore"):
        g = _one_op(GraphBuilder, infer_types, op, inputs, attrs)
        jg = _one_op(JGraphBuilder, j_infer_types, op, inputs, attrs)
        assert g.to_json() == jg.to_json()
        (want,) = j_run_graph(jg, feeds)
        outs = {"port oracle": run_graph(g, feeds)[0],
                "port torch": TorchExecutor(g, device="cpu").run(feeds)[0],
                "torch impl": get_op(op).torch_impl(*map(torch.from_numpy, inputs),
                                                    node=Node("y", op, tuple(feeds), attrs))}
        if jax:
            outs["jax impl"] = np.asarray(j_get_op(op).jax_impl(
                *inputs, node=JNode("y", op, tuple(feeds), attrs)))
    for key, got in outs.items():
        _held(got, want, f"{op} {key}")


def test_rsqrt_is_the_oracles_division_not_torch_rsqrt():
    """The impl computes 1 / sqrt(x) in float32, the oracle's two correctly
    rounded operations, bit for bit over 2^20 values."""
    x = np.random.default_rng(5).uniform(1e-3, 1e3, 1 << 20).astype(np.float32)
    got = get_op("rsqrt").torch_impl(torch.from_numpy(x), node=Node("y", "rsqrt", ("x",), {}))
    np.testing.assert_array_equal(got.numpy(), (1.0 / np.sqrt(x)).astype(np.float32))


def test_the_six_ops_have_torch_impls_and_89_ops_still_lack_one():
    """ROADMAP's op count: of the JAX package's registered ops, 89 lack a
    torch impl in the port (95 before these six)."""
    done = {o for o in all_ops() if get_op(o).torch_impl is not None}
    assert set(TF_OPS) <= done
    assert len(set(j_all_ops()) - done) == 89
