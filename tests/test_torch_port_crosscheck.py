"""runtime/crosscheck.py (the float-source set and the node-level rule that
holds a run on the card against the CPU path) and ops/nn.py
float32_products (the port's float convolutions and products run with TF32
off whatever torch's flags say), on the CPU.

The node-level rule is exercised on a graph x -> exp -> qnn.quantize ->
qnn.dequantize beside x -> qnn.quantize, with "card" values made by hand:
exp one step the other side of a rounding boundary, as CUDA's expf may be.
"""

import numpy as np
import pytest
import torch

import tachikoma_tpu_torch  # noqa: F401  (registers every op)
from tachikoma_tpu_torch.ir.graph import CONST, VAR, GraphBuilder, Node
from tachikoma_tpu_torch.ir.infer import infer_types
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.runtime.crosscheck import (FLOAT_PRODUCTS, FLOAT_SOURCES,
                                                    float_source_set, hold_node_level)
from tachikoma_tpu_torch.runtime.executor import computational_nodes


def _graph():
    b = GraphBuilder()
    x = b.var("x", (1, 8), "float32")
    e = b.call("exp", x, name="e")
    q1 = b.call("qnn.quantize", e, name="q1", scale=0.5, zero_point=0, out_dtype="int8")
    dq = b.call("qnn.dequantize", q1, name="dq", scale=0.5, zero_point=0)
    q0 = b.call("qnn.quantize", x, name="q0", scale=0.25, zero_point=3, out_dtype="int8")
    return infer_types(b.build([dq, q0]))


def _walk(graph, x, exp_out=None):
    """Every op node's value in order, on the CPU; `exp_out` replaces exp's."""
    env = {"x": torch.from_numpy(x)}
    for n in graph.nodes:
        if n.op == VAR:
            continue
        assert n.op != CONST
        env[n.name] = (torch.from_numpy(exp_out) if n.op == "exp" and exp_out is not None
                       else get_op(n.op).torch_impl(*[env[i] for i in n.inputs], node=n))
    return [env[nm].numpy() for nm in computational_nodes(graph)]


def _inputs():
    x = np.linspace(-1, 1, 8).astype(np.float32)[None]
    x[0, 2] = np.log(np.float32(1.24999))  # exp(x) / 0.5 just under 2.5
    cpu_exp = np.exp(x)
    card_exp = cpu_exp.copy()
    card_exp[0, 2] = np.float32(1.25001)  # just over 2.5: rounds to 3, not 2
    return x, card_exp


def test_float_source_set_follows_a_source_through_integer_nodes():
    g = _graph()
    assert float_source_set(g) == {"e", "q1", "dq"}
    assert float_source_set(g, floats_only=True) == {"e"}
    assert float_source_set(g, FLOAT_PRODUCTS) == set()
    assert set(FLOAT_PRODUCTS) < set(FLOAT_SOURCES)
    # the elementwise float ops written op for op are not sources
    assert not {"nn.batch_norm", "nn.relu", "qnn.dequantize", "nn.bias_add"} & set(FLOAT_SOURCES)


def test_node_level_rule_reports_a_flip_and_holds_every_node():
    g = _graph()
    names = computational_nodes(g)
    x, card_exp = _inputs()
    cpu, card = _walk(g, x), _walk(g, x, card_exp)
    counts, differing = hold_node_level(g, names, card, cpu, {"x": x}, 1e-4, 1e-4)
    assert counts["int"] == 1 and counts["cone_int"] == 1 and counts["cone_float"] == 2
    assert counts["cone"] == 3 and counts["cone_int_differing"] == 1
    assert differing == [("q1", 1, 1, (0, 2))]
    counts, differing = hold_node_level(g, names, cpu, cpu, {"x": x}, 1e-4, 1e-4)
    assert differing == [] and counts["cone_int_differing"] == 0


@pytest.mark.parametrize("node,message", [("q1", "its CPU impl on the card's inputs"),
                                          ("q0", "the CPU path")])
def test_node_level_rule_fails_an_integer_node_that_is_wrong(node, message):
    g = _graph()
    names = computational_nodes(g)
    x, card_exp = _inputs()
    cpu, card = _walk(g, x), _walk(g, x, card_exp)
    card[names.index(node)] = card[names.index(node)].copy()
    card[names.index(node)][0, 5] += 1
    with pytest.raises(AssertionError, match=message):
        hold_node_level(g, names, card, cpu, {"x": x}, 1e-4, 1e-4)


def test_node_level_rule_fails_a_float_node_off_its_own_op():
    g = _graph()
    names = computational_nodes(g)
    x, card_exp = _inputs()
    cpu, card = _walk(g, x), _walk(g, x, card_exp)
    card[names.index("dq")] = card[names.index("dq")] + np.float32(1e-2)
    with pytest.raises(AssertionError):
        hold_node_level(g, names, card, cpu, {"x": x}, 1e-4, 1e-4)


_PRODUCTS = {
    "nn.conv2d": ("conv2d", [(1, 5, 5, 2), (3, 3, 2, 4)], {"padding": (1, 0, 2, 1)}),
    "nn.conv2d_transpose": ("conv_transpose2d", [(1, 3, 3, 2), (3, 3, 2, 4)],
                            {"strides": (2, 2), "padding": (1, 1, 1, 1)}),
    "nn.conv3d": ("conv3d", [(1, 3, 4, 4, 2), (3, 3, 3, 2, 4)], {"padding": (1,) * 6}),
    "nn.dense": ("matmul", [(2, 3), (3, 4)], {}),
    "nn.batch_matmul": ("matmul", [(2, 2, 3), (2, 4, 3)], {"transpose_b": True}),
}


@pytest.mark.parametrize("op", list(_PRODUCTS))
def test_float_products_run_with_tf32_off(op, monkeypatch):
    """With TF32 allowed for cuDNN and matmuls, as a user may leave it, each
    float product runs with both off and leaves the flags as it found them."""
    fn, shapes, attrs = _PRODUCTS[op]
    module = torch if fn == "matmul" else torch.nn.functional
    real, seen = getattr(module, fn), []

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(module, fn, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rng = np.random.default_rng(3)
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    node = Node("n", op, ("a", "b"), attrs)
    got = get_op(op).torch_impl(*map(torch.from_numpy, args), node=node)
    assert seen == [(False, False)]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    np.testing.assert_allclose(got.numpy(), get_op(op).np_impl(*args, node=node), rtol=1e-5,
                               atol=1e-5)
