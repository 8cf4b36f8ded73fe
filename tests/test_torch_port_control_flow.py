"""The port's control flow, `tk.cond` and `tk.while_loop` (ops/control.py), on
the CPU, against the JAX package.

The graphs of tests/test_control_flow.py and two int8 graphs of
tests/runtime_cases.py (a cond between two qnn.dense + requantize heads, a
loop applying a qnn.dense + requantize + clip block n times) at small
widths go through the JAX package's oracle and `JaxExecutor` and the port's
oracle and torch executor on the same seeded inputs, on both predicates and
at several trip counts, held with ==.  The branch-type mismatch and
`max_iterations` raise as the JAX package's relation and oracle do; the
traces are byte-equal to the JAX package's numpy trace; a subgraph's
constants go to a device once and leave it with their graph; the host reads are one per cond and one per
evaluation of a loop condition."""

import gc
import weakref

import numpy as np
import pytest

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import Graph as JGraph
from tachikoma_tpu import GraphBuilder as JGraphBuilder
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.runtime.executor import run_graph_jax
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import Graph, GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ops import control
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

from runtime_cases import cond_heads, while_blocks

PORT = (GraphBuilder, Graph, infer_types)
JAX = (JGraphBuilder, JGraph, j_infer_types)


def _sub(pkg, build_fn, name="sub"):
    """tests/test_control_flow.py's subgraph: no dead-code elimination, so a
    loop's cond and body keep every state var."""
    builder_cls, graph_cls, infer = pkg
    b = builder_cls(name)
    out = build_fn(b)
    outs = out if isinstance(out, list) else [out]
    return infer(graph_cls(list(b.nodes), outs, dict(b.params), name)).to_json()


def _add_sub_cond(pkg, shape=(4, 8)):
    builder_cls, _, infer = pkg
    then_j = _sub(pkg, lambda b: b.call("add", b.var("a", shape, "int32"),
                                        b.var("c", shape, "int32")))
    else_j = _sub(pkg, lambda b: b.call("subtract", b.var("a", shape, "int32"),
                                        b.var("c", shape, "int32")))
    b = builder_cls()
    p = b.var("p", (), "bool")
    x = b.var("x", shape, "int32")
    y = b.var("y", shape, "int32")
    return infer(b.build(b.call("tk.cond", p, x, y, then_graph=then_j, else_graph=else_j)))


def _countdown(pkg, max_iterations=None):
    """state (i, acc): while i < 5: acc = acc * 2 + 1; i += 1."""
    builder_cls, _, infer = pkg

    def cond(b):
        i = b.var("i", (), "int32")
        b.var("acc", (2, 3), "int32")  # unused but part of the state
        return b.call("less", i, b.const(np.int32(5)))

    def body(b):
        i = b.var("i", (), "int32")
        acc = b.var("acc", (2, 3), "int32")
        two, one = b.const(np.int32(2)), b.const(np.int32(1))
        return [b.call("add", i, one), b.call("add", b.call("multiply", acc, two), one)]

    b = builder_cls()
    i0 = b.var("i0", (), "int32")
    a0 = b.var("a0", (2, 3), "int32")
    extra = {} if max_iterations is None else {"max_iterations": max_iterations}
    out = b.call("tk.while_loop", i0, a0, cond_graph=_sub(pkg, cond), body_graph=_sub(pkg, body),
                 **extra)
    return infer(b.build([b.call("tuple_get_item", out, index=0),
                          b.call("tuple_get_item", out, index=1)]))


def _all_ways(g, jg, feeds):
    """JAX oracle == JaxExecutor == port oracle == port torch (CPU); returns
    the answer."""
    assert g.to_json() == jg.to_json()
    want = [np.asarray(v) for v in j_run_graph(jg, dict(feeds))]
    for what, got in (("JaxExecutor", run_graph_jax(jg, dict(feeds))),
                      ("port oracle", run_graph(g, dict(feeds))),
                      ("port torch", TorchExecutor(g, device="cpu").run(dict(feeds)))):
        assert len(got) == len(want), what
        for a, b in zip(got, want):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, what
            np.testing.assert_array_equal(a, b, err_msg=what)
    return want


def _i8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("pred", [True, False])
def test_cond_int32_both_predicates(pred):
    rng = np.random.default_rng(0)
    xv = rng.integers(-100, 100, (4, 8)).astype(np.int32)
    yv = rng.integers(-100, 100, (4, 8)).astype(np.int32)
    out = _all_ways(_add_sub_cond(PORT), _add_sub_cond(JAX),
                    {"p": np.asarray(pred), "x": xv, "y": yv})
    np.testing.assert_array_equal(out[0], xv + yv if pred else xv - yv)


@pytest.mark.parametrize("flag", [True, False, np.int32(0), np.int32(3)], ids=str)
def test_cond_int8_heads(flag):
    """Two int8 heads (qnn.dense 64 -> 10, requantize) on both predicates,
    a bool or an integer flag."""
    g = cond_heads(*PORT, batch=2, features=64, classes=10)
    jg = cond_heads(*JAX, batch=2, features=64, classes=10)
    feeds = {"flag": np.asarray(flag).astype(bool), "features": _i8((2, 64), 1)}
    out = _all_ways(g, jg, feeds)
    other = _all_ways(g, jg, {**feeds, "flag": ~feeds["flag"]})
    assert out[0].dtype == np.int8 and (out[0] != other[0]).any()


def test_cond_branch_type_mismatch():
    then_j = _sub(PORT, lambda b: b.call("nn.relu", b.var("a", (4,), "float32")))
    else_j = _sub(PORT, lambda b: b.call("cast", b.var("a", (4,), "float32"), dtype="int32"))
    b = GraphBuilder()
    p = b.var("p", (), "bool")
    x = b.var("x", (4,), "float32")
    out = b.call("tk.cond", p, x, then_graph=then_j, else_graph=else_j)
    with pytest.raises(Exception, match="disagree"):
        infer_types(b.build(out))


def test_cond_predicate_must_be_scalar():
    then_j = _sub(PORT, lambda b: b.call("nn.relu", b.var("a", (4,), "float32")))
    b = GraphBuilder()
    p = b.var("p", (2,), "bool")
    out = b.call("tk.cond", p, b.var("x", (4,), "float32"), then_graph=then_j,
                 else_graph=then_j)
    with pytest.raises(Exception, match="scalar"):
        infer_types(b.build(out))


def test_while_countdown():
    a = np.random.default_rng(0).integers(0, 5, (2, 3)).astype(np.int32)
    i, acc = _all_ways(_countdown(PORT), _countdown(JAX), {"i0": np.int32(0), "a0": a})
    want = a.copy()
    for _ in range(5):
        want = want * 2 + 1
    assert int(i) == 5
    np.testing.assert_array_equal(acc, want)


@pytest.mark.parametrize("n", [0, 1, 4])
def test_while_int8_blocks(n):
    g = while_blocks(*PORT, batch=2, features=48)
    jg = while_blocks(*JAX, batch=2, features=48)
    x = _i8((2, 48), 2)
    count, out = _all_ways(g, jg, {"i0": np.int32(0), "n": np.int32(n), "features": x})
    assert int(count) == n
    if n == 0:
        np.testing.assert_array_equal(out, x)
    else:
        assert out.min() >= 0


@pytest.mark.parametrize("limit", [3, 5])
def test_while_max_iterations_raises_as_the_oracle_does(limit):
    """The oracle raises once the count reaches max_iterations, even where
    the loop would have stopped there (5 iterations against a limit of 5);
    the port's torch impl raises on the same count (the JAX package's jax
    impl ignores the limit: ROADMAP Queue 3)."""
    feeds = {"i0": np.int32(0), "a0": np.zeros((2, 3), np.int32)}
    with pytest.raises(RuntimeError, match=f"exceeded {limit} iterations"):
        j_run_graph(_countdown(JAX, limit), dict(feeds))
    g = _countdown(PORT, limit)
    with pytest.raises(RuntimeError, match=f"exceeded {limit} iterations"):
        run_graph(g, dict(feeds))
    with pytest.raises(RuntimeError, match=f"exceeded {limit} iterations"):
        TorchExecutor(g, device="cpu").run(dict(feeds))
    run_graph(_countdown(PORT, 6), dict(feeds))  # a limit above the count runs


@pytest.mark.parametrize("which", ["cond", "while"])
def test_traces_byte_equal_to_the_reference(which):
    if which == "cond":
        g = cond_heads(*PORT, batch=1, features=64, classes=10)
        jg = cond_heads(*JAX, batch=1, features=64, classes=10)
        feeds = {"flag": np.asarray(False), "features": _i8((1, 64), 3)}
    else:
        g = while_blocks(*PORT, batch=1, features=48)
        jg = while_blocks(*JAX, batch=1, features=48)
        feeds = {"i0": np.int32(0), "n": np.int32(2), "features": _i8((1, 48), 4)}
    want = j_emit_trace(jg, dict(feeds), backend="numpy")
    blob = emit_trace(g, dict(feeds), backend="torch", device="cpu")
    assert blob == want
    assert emit_trace(g, dict(feeds), backend="oracle") == want
    assert verify_trace(blob, g)["mismatches"] == []


def test_json_round_trip():
    g = cond_heads(*PORT, batch=2, features=64, classes=10)
    g2 = Graph.from_json(g.to_json())
    feeds = {"flag": np.asarray(True), "features": _i8((2, 64), 5)}
    np.testing.assert_array_equal(run_graph(g2, feeds)[0], run_graph(g, feeds)[0])


def test_constants_move_once_and_host_reads_are_counted():
    """A branch's constants go to the device once per node, subgraph and
    device (a second call reuses the same tensors, so a kernel's per-tensor
    caches hold); one host read per cond, n + 1 per loop of n iterations."""
    g = cond_heads(*PORT, batch=2, features=64, classes=10)
    ex = TorchExecutor(g, device="cpu")
    feeds = {"flag": np.asarray(True), "features": _i8((2, 64), 6)}
    control.HOST_READS.clear()
    ex.run(feeds)
    held = control._DEVICE_CONSTS[id(ex.graph["head"])]
    assert list(held) == [("then_graph", "cpu")]
    consts = held[("then_graph", "cpu")]
    ex.run(feeds)
    assert list(held) == [("then_graph", "cpu")]
    assert held[("then_graph", "cpu")]["a_w"] is consts["a_w"]
    assert control.HOST_READS["tk.cond"] == 2

    w = while_blocks(*PORT, batch=2, features=48)
    control.HOST_READS.clear()
    TorchExecutor(w, device="cpu").run({"i0": np.int32(0), "n": np.int32(4),
                                        "features": _i8((2, 48), 7)})
    assert control.HOST_READS == {"tk.while_loop": 5}


def test_branch_constants_are_freed_with_their_graph():
    """The device copy of a branch's constants lives as long as the graph
    whose tk.cond node holds the branch, not for the rest of the process."""
    g = cond_heads(*PORT, batch=2, features=64, classes=10)
    ex = TorchExecutor(g, device="cpu")
    for flag in (True, False):
        ex.run({"flag": np.asarray(flag), "features": _i8((2, 64), 8)})
    key = id(ex.graph["head"])
    consts = control._DEVICE_CONSTS[key]
    assert sorted(consts) == [("else_graph", "cpu"), ("then_graph", "cpu")]
    w = weakref.ref(consts[("then_graph", "cpu")]["a_w"])
    del ex, g, consts
    gc.collect()
    assert key not in control._DEVICE_CONSTS and w() is None
