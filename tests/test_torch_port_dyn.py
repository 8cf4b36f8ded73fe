"""The port's data-dependent shapes (ops/dyn.py, runtime/dynshape.py) and the
static ops the dyn folds emit, on the CPU, against the JAX package.

At tests/test_dyn.py's shapes the same seeded inputs go through the JAX
package's `DynShapeExecutor` (its oracle and `JaxExecutor`) and the port's
(its oracle and its torch backend), and through both packages' oracles and
the port's torch executor without specialization; every output is held with
== and its dtype compared.  `specialize` gives the JAX package's keys and
static graphs (structural bytes, params included); a hit runs with no fold,
no type inference and no executor build, and every specialization shares
one copy of the parameters.  The integer `topk` repair is held against
`lax.top_k` and a stable int64 argsort, with the oracle's wrap pinned as the
recorded reference gap.  The slice as a whole: a quantized ResNet-18 b2 32²
with a `dyn.topk` head on its int8 logits, fused, == the JAX package's."""

import io
from collections import Counter

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import Graph as JGraph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.runtime.dynshape import DynShapeExecutor as JDynShapeExecutor
from tachikoma_tpu.runtime.dynshape import specialize as j_specialize
from tachikoma_tpu.runtime.executor import run_graph_jax
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir.graph import Graph, Node
from tachikoma_tpu_torch.ir.infer import TypeError_
from tachikoma_tpu_torch.runtime import dynshape
from tachikoma_tpu_torch.runtime.dynshape import (DynShapeExecutor, has_dynamic_shapes,
                                                  specialize)
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

from runtime_cases import CASES, DYN_OPS, f32, i32, one_op, rand_f32, with_topk_head


FOLDED = [c for c in CASES if not c[0].startswith("nonzero")]

def _same(got, want, what, float_tol=None):
    """== and one dtype; float arrays within `float_tol` (rtol, atol) where
    given (a softmax summed in another order)."""
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        if float_tol and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, *float_tol, err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)


SOFTMAX_TOL = (1e-5, 1e-7)  # tests/test_torch_port_resnet.py's


def test_the_cases_cover_every_dyn_op():
    ops = {n.op for _, build, _ in CASES for n in build(GraphBuilder).nodes}
    assert DYN_OPS <= ops
    from tachikoma_tpu_torch.ir.registry import get_op
    assert all(get_op(op).torch_impl is not None for op in DYN_OPS)


# where the JAX package's oracle gives the recorded wrong answer (its integer
# topk sorts -a in the input's dtype: ROADMAP Queue 3); JaxExecutor is right
ORACLE_WRAPS = {"topk_int8_values"}


@pytest.mark.parametrize("cid,build,feeds", CASES, ids=[c[0] for c in CASES])
def test_dyn_op_matches_reference(cid, build, feeds):
    """Port oracle, port torch (specialized and not), JAX oracle and
    JaxExecutor: one answer, ==, in one dtype."""
    g, jg = build(GraphBuilder), build(JGraphBuilder)
    want = [np.asarray(v) for v in JDynShapeExecutor(jg, backend="jax").run(dict(feeds))]
    oracle = JDynShapeExecutor(jg, backend="oracle").run(dict(feeds))
    if cid in ORACLE_WRAPS:
        assert any((np.asarray(a) != b).any() for a, b in zip(oracle, want))
    else:
        _same(oracle, want, "JAX oracle")
    _same(DynShapeExecutor(g, backend="oracle").run(dict(feeds)), want, "port oracle")
    _same(DynShapeExecutor(g, backend="torch", device="cpu").run(dict(feeds)), want, "port torch")
    # unspecialized: the dyn ops' own impls (each folds its shape inputs itself)
    _same(run_graph(infer_types(g), dict(feeds)), want, "port oracle, unspecialized")
    _same(TorchExecutor(g, device="cpu").run(dict(feeds)), want, "port torch, unspecialized")


@pytest.mark.parametrize("build,feeds", [c[1:] for c in FOLDED], ids=[c[0] for c in FOLDED])
def test_specialize_gives_the_reference_key_and_graph(build, feeds):
    g, jg = build(GraphBuilder), build(JGraphBuilder)
    assert has_dynamic_shapes(g)
    sg, key = specialize(g, dict(feeds))
    jsg, jkey = j_specialize(jg, dict(feeds))
    assert key == jkey
    assert not has_dynamic_shapes(sg)
    assert sg.structural_bytes(include_params=True) == jsg.structural_bytes(include_params=True)


def _reshape_graph(B):
    b = B("dr")
    x = b.var("x", (2, 12), "float32")
    s = b.var("shape", (3,), "int32")
    return b.build([b.call("abs", b.call("dyn.reshape", x, s, name="dr0"), name="out")])


@pytest.mark.parametrize("backend", ["oracle", "torch"])
def test_cache_counts_and_hits_skip_fold_infer_and_build(backend, monkeypatch):
    g, jg = _reshape_graph(GraphBuilder), _reshape_graph(JGraphBuilder)
    ex = DynShapeExecutor(g, backend=backend, device="cpu")
    jex = JDynShapeExecutor(jg, backend="oracle")
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    shapes = ([2, 3, 4], [2, 3, 4], [6, 2, 2], [1, 24, 1], [6, 2, 2])
    for shp in shapes[:3]:
        feeds = {"x": x, "shape": i32(shp)}
        _same(ex.run(feeds), jex.run(dict(feeds)), str(shp))
    assert (ex.misses, ex.hits, len(ex._cache)) == (2, 1, 2) and len(jex._cache) == 2
    assert set(ex.miss_seconds[0]) == {"fold", "infer", "build"}

    def refuse(*a, **k):
        raise AssertionError("a hit folded, inferred types or built an executor")

    for name in ("_fold", "infer_types", "TorchExecutor"):
        monkeypatch.setattr(dynshape, name, refuse)
    _same(ex.run({"x": x, "shape": i32([6, 2, 2])}), [np.abs(x.reshape(6, 2, 2))], "hit")
    with pytest.raises(AssertionError, match="a hit folded"):
        ex.run({"x": x, "shape": i32(shapes[3])})
    assert ex.hits == 2


def test_full_keys_include_the_fill_value():
    """dyn.full folds both inputs: two fills at one shape are two keys."""
    build = one_op("dyn.full", [("fill", (1,), "float32"), ("shape", (2,), "int32")])
    ex = DynShapeExecutor(build(GraphBuilder), device="cpu")
    shp = i32([2, 2])
    a = ex.run({"fill": f32([1.0]), "shape": shp})[0]
    c = ex.run({"fill": f32([3.0]), "shape": shp})[0]
    assert len(ex._cache) == 2 and a[0, 0] == 1.0 and c[0, 0] == 3.0


def test_specializations_share_one_copy_of_the_params():
    b = GraphBuilder("p")
    x = b.var("x", (2, 6), "float32")
    s = b.var("shape", (2,), "int32")
    w = b.const(rand_f32((2, 6), 3), name="w")
    g = b.build([b.call("dyn.reshape", b.call("add", x, w), s, name="r0")])
    ex = DynShapeExecutor(g, device="cpu")
    for shp in ([3, 4], [4, 3], [12, 1]):
        ex.run({"x": rand_f32((2, 6), 4), "shape": i32(shp)})
    assert ex.misses == 3
    assert all(e._params["w"] is ex._params["w"] for e in ex._cache.values())


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynShapeExecutor(_reshape_graph(GraphBuilder))
    with pytest.raises(ValueError, match="backend"):
        DynShapeExecutor(_reshape_graph(GraphBuilder), backend="jax", device="cpu")


def test_shape_boundary_names_the_node():
    """Unknown shapes flow through value-only ops; a shape-consuming op
    fails at infer time naming the node, in both packages."""
    g = infer_types(_reshape_graph(GraphBuilder))
    assert g["dr0"].shape is None and g["out"].shape is None

    def flat(B):
        b = B("drf")
        x = b.var("x", (2, 12), "float32")
        s = b.var("shape", (3,), "int32")
        return b.build([b.call("nn.batch_flatten", b.call("dyn.reshape", x, s, name="dr0"),
                               name="flat")])

    with pytest.raises(TypeError_, match="flat"):
        infer_types(flat(GraphBuilder))
    with pytest.raises(Exception, match="flat"):
        j_infer_types(flat(JGraphBuilder))


def test_const_shape_folds_with_no_feed():
    def build(B):
        b = B("drc")
        x = b.var("x", (3, 8), "float32")
        s = b.const(i32([4, 6]), name="shp")
        return b.build([b.call("dyn.reshape", x, s, name="dr0")])

    sg, key = specialize(build(GraphBuilder), {"x": np.zeros((3, 8), np.float32)})
    jsg, jkey = j_specialize(build(JGraphBuilder), {"x": np.zeros((3, 8), np.float32)})
    assert sg["dr0"].shape == (4, 6) and key == jkey
    assert sg.structural_bytes(include_params=True) == jsg.structural_bytes(include_params=True)


def test_resize2d_fold_drops_roi_as_the_reference_does():
    """The recorded reference gap (ROADMAP Queue 3): the fold keeps input 0
    only, so a roi input is dropped; the port matches it, roi and all."""
    def build(B):
        b = B("drz")
        x = b.var("x", (1, 4, 4, 2), "float32")
        s = b.var("size", (2,), "int32")
        roi = b.var("roi", (4,), "float32")
        return b.build([b.call("dyn.image.resize2d", x, s, roi, method="nearest_neighbor",
                               name="rz0")])

    feeds = {"x": rand_f32((1, 4, 4, 2), 2), "size": i32([6, 6]), "roi": f32([0, 0, .5, .5])}
    sg, _ = specialize(build(GraphBuilder), feeds)
    jsg, _ = j_specialize(build(JGraphBuilder), feeds)
    assert sg["rz0"].inputs == ("x",) and "roi" not in sg
    assert sg.structural_bytes(include_params=True) == jsg.structural_bytes(include_params=True)


def test_nonzero_traces_byte_equal_to_the_reference():
    from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace

    from tachikoma_tpu_torch.trace.emitter import emit_trace

    build = CASES[0][1]
    g, jg = infer_types(build(GraphBuilder)), j_infer_types(build(JGraphBuilder))
    x = np.eye(4, 6, dtype=np.int32)
    want = j_emit_trace(jg, [x], backend="numpy")
    assert emit_trace(g, [x], backend="torch", device="cpu") == want
    assert emit_trace(g, [x], backend="oracle") == want


# ---------------------------------------------------------------------------
# the static twins the folds emit, and shape_of
# ---------------------------------------------------------------------------

STATIC_CASES = [
    ("zeros", "zeros", [], {"shape": (2, 3), "dtype": "int8"}),
    ("ones", "ones", [], {"shape": (4,), "dtype": "float32"}),
    ("full_float", "full", [], {"shape": (2, 2), "fill_value": 2.5, "dtype": "float32"}),
    ("full_float_into_int", "full", [], {"shape": (3,), "fill_value": -2.75, "dtype": "int32"}),
    ("full_bool", "full", [], {"shape": (2, 3), "fill_value": True, "dtype": "bool"}),
    ("sparse_to_dense", "sparse_to_dense",
     [i32([[0, 0], [1, 2], [2, 3]]), f32([1., 2., 3.]), np.asarray(-1., np.float32)],
     {"output_shape": (3, 4)}),
    ("sparse_to_dense_1d_int8", "sparse_to_dense",
     [i32([4, 0, 7]), np.array([5, -128, 127], np.int8), np.asarray(3, np.int8)],
     {"output_shape": (9,)}),
    ("sparse_to_dense_scalar_value", "sparse_to_dense",
     [i32([[1, 1], [0, 2]]), np.asarray(9, np.int32), np.asarray(0, np.int32)],
     {"output_shape": (2, 3)}),
    ("sparse_to_dense_negative_index", "sparse_to_dense",
     [i32([[-1, 0], [0, -2]]), f32([4., 5.]), np.asarray(0., np.float32)],
     {"output_shape": (2, 3)}),
    ("shape_of", "shape_of", [rand_f32((2, 5, 3), 0)], {}),
    ("shape_of_int64", "shape_of", [np.zeros((7, 1), np.int8)], {"dtype": "int64"}),
    ("upsampling3d", "nn.upsampling3d", [rand_f32((1, 2, 3, 2, 4), 5)],
     {"scale_d": 2.0, "scale_h": 1.5, "scale_w": 3.0}),
    ("upsampling3d_int8", "nn.upsampling3d",
     [np.arange(24, dtype=np.int8).reshape(1, 2, 2, 3, 2)],
     {"scale_d": 1.0, "scale_h": 2.0, "scale_w": 2.0}),
]


def _static_graph(B, infer, op, inputs, attrs):
    b = B("s")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    return infer(b.build(b.call(op, *names, name="y", **attrs)))


@pytest.mark.parametrize("op,inputs,attrs", [c[1:] for c in STATIC_CASES],
                         ids=[c[0] for c in STATIC_CASES])
def test_static_twin_matches_reference(op, inputs, attrs):
    g = _static_graph(GraphBuilder, infer_types, op, inputs, attrs)
    jg = _static_graph(JGraphBuilder, j_infer_types, op, inputs, attrs)
    assert (g["y"].shape, g["y"].dtype) == (jg["y"].shape, jg["y"].dtype)
    want = j_run_graph(jg, inputs)
    _same(run_graph_jax(jg, inputs), want, "JaxExecutor")
    _same(run_graph(g, inputs), want, "port oracle")
    _same(TorchExecutor(g, device="cpu").run(inputs), want, "port torch")


def test_sparse_to_dense_repeated_index_keeps_the_last_write():
    """The oracle's loop leaves the last value of a repeated index; the
    torch impl picks it by position, not by scatter order."""
    inputs = [i32([[1, 1], [0, 0], [1, 1], [1, 1]]), f32([1., 2., 3., 4.]),
              np.asarray(0., np.float32)]
    g = _static_graph(GraphBuilder, infer_types, "sparse_to_dense", inputs,
                      {"output_shape": (2, 2)})
    jg = _static_graph(JGraphBuilder, j_infer_types, "sparse_to_dense", inputs,
                       {"output_shape": (2, 2)})
    want = j_run_graph(jg, inputs)
    assert want[0][1, 1] == 4.0
    _same(TorchExecutor(g, device="cpu").run(inputs), want, "port torch")


def test_creation_ops_follow_the_executor_device():
    """full / ones / zeros have no tensor input: they take the device of the
    walk (the CPU here; the card's under TorchExecutor(device='cuda'))."""
    from tachikoma_tpu_torch.ops.nn import walk_device, walking_on

    assert walk_device() == torch.device("cpu")
    with walking_on("meta"):
        assert walk_device() == torch.device("meta")
    assert walk_device() == torch.device("cpu")


# ---------------------------------------------------------------------------
# the integer topk repair (ROADMAP Queue 3): the port follows lax.top_k
# ---------------------------------------------------------------------------

TOPK_INT = [
    ("int8_min", np.array([[3, -128, 5, 5, 127, -1], [-128, -128, 0, 1, -1, 2]], np.int8)),
    ("uint8", np.array([[0, 3, 200, 7, 255, 200]], np.uint8)),
    ("int32_min", np.array([[np.iinfo(np.int32).min, 4, -7, 4, np.iinfo(np.int32).max, 0]],
                           np.int32)),
]


def _topk_graph(B, infer, a, k, axis=-1):
    b = B("tk")
    x = b.var("x", a.shape, str(a.dtype))
    y = b.call("topk", x, k=k, axis=axis, ret_type="both", name="t")
    return infer(b.build([b.call("tuple_get_item", y, index=i, name=f"o{i}")
                          for i in range(2)]))


@pytest.mark.parametrize("a", [c[1] for c in TOPK_INT], ids=[c[0] for c in TOPK_INT])
def test_integer_topk_matches_lax_top_k(a):
    k = 4
    want_idx = np.argsort(-a.astype(np.int64), axis=-1, kind="stable")[..., :k]
    want = [np.take_along_axis(a, want_idx, -1), want_idx.astype(np.int32)]
    jg = _topk_graph(JGraphBuilder, j_infer_types, a, k)
    _same(run_graph_jax(jg, [a]), want, "JaxExecutor (lax.top_k)")
    g = _topk_graph(GraphBuilder, infer_types, a, k)
    _same(run_graph(g, [a]), want, "port oracle")
    _same(TorchExecutor(g, device="cpu").run([a]), want, "port torch")


def test_reference_oracle_topk_wraps_on_integers():
    """The recorded reference gap: the JAX package's oracle sorts -a in the
    input's dtype, so int8 -128 (whose negation wraps to itself) comes
    first; the port does not copy it."""
    a = TOPK_INT[0][1][:1]
    jvals, jidx = j_run_graph(_topk_graph(JGraphBuilder, j_infer_types, a, 3), [a])
    assert jvals.tolist() == [[-128, 127, 5]] and jidx.tolist() == [[1, 4, 2]]
    vals, idx = run_graph(_topk_graph(GraphBuilder, infer_types, a, 3), [a])
    assert vals.tolist() == [[127, 5, 5]] and idx.tolist() == [[4, 2, 3]]


@pytest.mark.parametrize("axis", [-1, 0])
def test_float_topk_unchanged(axis):
    """Floats: the JAX oracle's answer bit for bit (ties to the lower index,
    -0.0 and 0.0 equal, as before the repair)."""
    a = np.round(rand_f32((5, 6), 7), 1)
    a[0, :3] = [0.0, -0.0, 0.0]
    a[2, 2] = a[2, 4]
    jg = _topk_graph(JGraphBuilder, j_infer_types, a, 3, axis)
    want = j_run_graph(jg, [a])
    g = _topk_graph(GraphBuilder, infer_types, a, 3, axis)
    _same(run_graph(g, [a]), want, "port oracle")
    got = TorchExecutor(g, device="cpu").run([a])
    _same(got, want, "port torch")
    assert np.signbit(got[0]).tolist() == np.signbit(want[0]).tolist()


# ---------------------------------------------------------------------------
# the slice as a whole: a dyn.topk head on quantized ResNet-18's int8 logits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet18_head():
    from tachikoma_tpu.models.vision import resnet as j_resnet
    from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
    from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn

    from tachikoma_tpu_torch.models.vision import resnet
    from tachikoma_tpu_torch.quantize.quantizer import quantize
    from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

    rng = np.random.default_rng(0)
    calib = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    q = quantize(resnet(18, batch_size=2, image_size=32, seed=0), [calib])
    jq = j_quantize(j_resnet(18, batch_size=2, image_size=32, seed=0), [calib])
    g, jg = with_topk_head(q, Node, Graph), with_topk_head(jq, JNode, JGraph)
    return dict(g=g, jg=jg, fused=fuse_qnn(g), jfused=j_fuse_qnn(jg),
                x=rng.standard_normal((2, 32, 32, 3)).astype(np.float32))


def test_topk_head_fuses_as_the_reference(resnet18_head):
    f, jf = resnet18_head["fused"], resnet18_head["jfused"]
    assert f.structural_bytes(include_params=True) == jf.structural_bytes(include_params=True)
    ops = Counter(n.op for n in f.nodes)
    assert sum(v for op, v in ops.items() if op.startswith("tk.")) == 15
    assert ops["dyn.topk"] == 1


@pytest.mark.parametrize("k", [1, 5, 10])
def test_topk_head_matches_reference_and_static_graph(resnet18_head, k):
    """Fused, through the port's DynShapeExecutor on the CPU: == the JAX
    package's JaxExecutor on its fused graph, == the same graph with k a
    static topk; the int8 logits hold -128 entries, which the oracle's wrap
    would have put first."""
    f, jf, x = resnet18_head["fused"], resnet18_head["jfused"], resnet18_head["x"]
    feeds = {"data": x, "k": i32([k])}
    want = JDynShapeExecutor(jf, backend="jax").run(dict(feeds))
    ex = DynShapeExecutor(f, device="cpu")
    got = ex.run(feeds)
    _same(got, [np.asarray(w) for w in want], "fused, torch", SOFTMAX_TOL)
    sg, key = specialize(f, feeds)
    assert key == (("head_topk", ((k,),)),) and sg["head_topk"].op == "topk"
    _same(TorchExecutor(sg, device="cpu").run({"data": x}), got, "static topk")
    deq = next(n for n in f.nodes if n.op == "qnn.dequantize")
    logits = TorchExecutor(f, capture=[deq.inputs[0]], device="cpu").run(feeds)[0]
    assert got[1].shape == (2, k) and (np.sort(logits, -1)[:, ::-1][:, :k] == got[1]).all()


def test_topk_head_trace_matches_the_reference(resnet18_head):
    """The specialized unfused graph's trace.  Its torch backend against
    the JAX package's jax trace (lax.top_k): every integer record byte-equal
    (the head's among them), the float records (dequantize, softmax) within
    SOFTMAX_TOL.  Its oracle backend against the JAX package's numpy trace:
    every record byte-equal but the head's, where the reference oracle's
    wrap put an int8 -128 first (ROADMAP Queue 3)."""
    from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace

    from tachikoma_tpu_torch.trace.emitter import emit_trace
    from tachikoma_tpu_torch.trace.format import TraceReader

    feeds = {"data": resnet18_head["x"], "k": i32([5])}
    sg, _ = specialize(resnet18_head["g"], feeds)
    jsg, _ = j_specialize(resnet18_head["jg"], feeds)
    x = {"data": resnet18_head["x"]}

    def records(blob):
        return list(TraceReader(io.BytesIO(blob)))

    got = records(emit_trace(sg, x, backend="torch", device="cpu"))
    ref = records(j_emit_trace(jsg, x, backend="jax"))
    assert len(got) == len(ref)
    n_int = 0
    for a, b in zip(got, ref):
        assert (a.name, a.op_name, a.attrs) == (b.name, b.op_name, b.attrs)
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), a.name
            n_int += 1
        else:
            for ta, tb in zip(a.tensors, b.tensors):
                np.testing.assert_allclose(ta.to_array(), tb.to_array(), *SOFTMAX_TOL)
    assert n_int == len(ref) - 2
    oracle = records(emit_trace(sg, x, backend="oracle"))
    differ = [a.name for a, b in zip(oracle, records(j_emit_trace(jsg, x, backend="numpy")))
              if a.encode() != b.encode()]
    assert differ == ["head_topk"]
