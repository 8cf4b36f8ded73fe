"""The ops the ONNX importer emits (53: 31 of ops/nn.py, 16 of ops/extra.py,
5 of ops/tail.py, trunc_mod of ops/tail3.py), on the CPU, against the JAX
package.

Each case builds the same one-op graph in both packages (equal JSON: the
relations agree) and runs the JAX package's oracle, its jax impl, the port's
oracle and the port's torch impl (`TorchExecutor(device="cpu")`) on the same
seeded inputs.  Integers, indices and bools are held with ==; floats within
the case's tolerance: 1e-6 (rtol and atol) for the elementwise functions,
whose torch and numpy float32 versions may differ by an ulp, 1e-5 for
reductions, norms and products summed in another order.  The cases are
those of tests/test_ops_np.py, test_ops_extra.py, test_ops_tail.py,
test_ops_tail3.py and test_resize.py for these ops, and named cases for the
places where torch's conventions differ from the oracle's: topk's ties and
int8 -128, integer divide / mod / trunc_mod over mixed signs and at a zero
divisor, depth_to_space's DCR and CRD, every resize2d mode and rounding
method, negative indices, scatters that write one place twice.

Where the jax impl departs from the oracle (the oracle is the rule the port
follows), the case says so and the jax impl is not compared: XLA's integer
division by zero, jnp's take_along_axis and scatter of a doubly wrapped
index.  The one exception is an integer topk: the oracle sorts -a in the
input's dtype, which wraps at -128, and the port follows lax.top_k there
(ROADMAP Queue 3), so those cases are held to the jax impl."""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

from onnx_op_cases import CASES, EXACT, JAX_IMPL, SPECIAL, TOPK_TIES, floats, ints

OP_CASES = [pytest.param(*c[1:], id=c[0]) for c in CASES]


def _one_op(builder, infer, op, inputs, attrs, n_out):
    b = builder("t")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    y = b.call(op, *names, name="y", **attrs)
    if n_out > 1:
        return infer(b.build([b.get_item(y, i) for i in range(n_out)]))
    return infer(b.build(y))


def _held(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        f"{what}: {got.dtype}{got.shape} != {want.dtype}{want.shape}"
    if tol is EXACT or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _listed(v):
    return [np.asarray(o) for o in v] if isinstance(v, list) else [np.asarray(v)]


@pytest.mark.parametrize("op,inputs,attrs,tol,jax,n_out,graph", OP_CASES)
def test_op_matches_reference_oracle_and_jax_impl(op, inputs, attrs, tol, jax, n_out, graph):
    """`graph`: through one-op graphs and both executors; else (where the
    JAX package's relation and oracle part, so its interpreter refuses the
    graph) each impl called on the arrays, as tests/test_ops_tail.py does."""
    feeds = {f"x{i}": x for i, x in enumerate(inputs)}
    node = Node("y", op, tuple(feeds), attrs)
    jnode = JNode("y", op, tuple(feeds), attrs)
    with np.errstate(all="ignore"):
        if graph:
            g = _one_op(GraphBuilder, infer_types, op, inputs, attrs, n_out)
            jg = _one_op(JGraphBuilder, j_infer_types, op, inputs, attrs, n_out)
            assert g.to_json() == jg.to_json()
            wants = j_run_graph(jg, feeds)
            outs = {"port oracle": run_graph(g, feeds),
                    "port torch": TorchExecutor(g, device="cpu").run(feeds)}
        else:
            wants = _listed(j_get_op(op).np_impl(*inputs, node=jnode))
            outs = {"port oracle": _listed(get_op(op).np_impl(*inputs, node=node)),
                    "port torch": _listed(get_op(op).torch_impl(
                        *map(torch.from_numpy, inputs), node=node))}
        if jax:
            outs["jax impl"] = _listed(j_get_op(op).jax_impl(*inputs, node=jnode))
        if jax == JAX_IMPL:  # the oracle's answer is the recorded reference fault
            wants = outs.pop("jax impl")
    for key, got in outs.items():
        assert len(got) == len(wants)
        for a, w in zip(got, wants):
            _held(a, w, tol, f"{op} {key}")


# ---------------------------------------------------------------------------
# what a case cannot show: refusals, signed zeros, relations the oracle
# departs from, the torch impls on their own
# ---------------------------------------------------------------------------

def _node(op, n_in, **attrs):
    return Node("y", op, tuple(f"x{i}" for i in range(n_in)), attrs)


def _both(op, *arrays, **attrs):
    node = _node(op, len(arrays), **attrs)
    want = get_op(op).np_impl(*arrays, node=node)
    got = get_op(op).torch_impl(*map(torch.from_numpy, arrays), node=node)
    return got, want


@pytest.mark.parametrize("op,arrays,attrs,err", [
    ("gather", [np.zeros((3, 2), np.float32), np.array([[3, 0]], np.int64)], dict(axis=0),
     IndexError),
    ("gather", [np.zeros((3, 2), np.float32), np.array([[-4, 0]], np.int64)], dict(axis=0),
     IndexError),
    ("gather_nd", [np.zeros((3, 2), np.float32), np.array([[0, 2]], np.int64)], {}, IndexError),
    ("scatter_nd", [np.zeros((3, 2), np.int32), np.array([[3]], np.int64),
                    np.ones((1, 2), np.int32)], {}, IndexError),
    ("scatter_elements", [np.zeros((3, 2), np.int32), np.array([[-7, 0]], np.int64),
                          np.ones((1, 2), np.int32)], dict(axis=0), IndexError),
    ("power", [np.array([2, 3], np.int32), np.array([-1, 2], np.int32)], {}, ValueError),
    ("squeeze", [np.zeros((2, 3), np.float32)], dict(axis=(0,)), ValueError),
], ids=["gather_past_end", "gather_before_start", "gather_nd_past_end", "scatter_nd_past_end",
        "scatter_elements_before_start", "power_int_negative_exponent", "squeeze_non_unit"])
def test_refused_where_the_oracle_refuses(op, arrays, attrs, err):
    node = _node(op, len(arrays), **attrs)
    with pytest.raises(err):
        get_op(op).np_impl(*arrays, node=node)
    with pytest.raises(err):
        get_op(op).torch_impl(*map(torch.from_numpy, arrays), node=node)


def test_resize_linear_refuses_integers():
    node = _node("image.resize2d", 1, size=(8, 8), method="linear",
                 coordinate_transformation_mode="half_pixel")
    x = np.zeros((1, 4, 4, 2), np.int8)
    with pytest.raises(NotImplementedError, match="float input"):
        get_op("image.resize2d").np_impl(x, node=node)
    with pytest.raises(NotImplementedError, match="float input"):
        get_op("image.resize2d").torch_impl(torch.from_numpy(x), node=node)


def test_resize_linear_is_the_oracles_three_ops_bit_for_bit():
    """top + (bot - top) * w in float32, op for op: bit-equal to the oracle,
    where F.interpolate's bilinear is not."""
    x = floats(2, 9, 13, 3, seed=5, scale=100)
    for ctm in ("asymmetric", "half_pixel", "align_corners"):
        got, want = _both("image.resize2d", x, size=(17, 6), method="linear",
                          coordinate_transformation_mode=ctm)
        assert got.numpy().tobytes() == want.tobytes(), ctm


def test_signed_zeros_and_nans_are_numpys():
    """mod's zero takes the divisor's sign, trunc_mod's the dividend's, and
    sign keeps NaN: bit for bit, which == cannot see."""
    a = np.array([-4.0, 4.0, -0.0, 6.0, 1.0, np.nan], np.float32)
    b = np.array([2.0, -2.0, 3.0, -3.0, 0.0, 1.0], np.float32)
    for op in ("mod", "trunc_mod"):
        with np.errstate(all="ignore"):
            got, want = _both(op, a, b)
        assert got.numpy().tobytes() == want.tobytes(), op
    got, want = _both("sign", SPECIAL)
    assert got.numpy().tobytes() == want.tobytes()


def test_reference_relation_and_oracle_part_on_prod_and_cumsum():
    """The JAX package's `prod` relation keeps an int8 input's dtype while its
    oracle returns int32; `cumsum` with no axis flattens in the oracle, not
    in the relation.  The port's torch impls follow the oracle."""
    x = ints(3, 4, lo=-3, hi=4)
    got, want = _both("prod", x, axis=(1,))
    assert want.dtype == np.int32 and j_get_op("prod").infer(
        JNode("y", "prod", ("x0",), {"axis": (1,)}), [((3, 4), "int8")])[1] == "int8"
    _held(got.numpy(), want, EXACT, "prod")
    got, want = _both("cumsum", x)
    assert want.shape == (12,)
    _held(got.numpy(), want, EXACT, "cumsum")


def test_topk_tuple_items_run_through_the_executor():
    """TopK's two outputs leave the op as a tuple and reach the graph's
    outputs through tuple_get_item, in TorchExecutor as in the oracle."""
    x = TOPK_TIES
    b = GraphBuilder("t")
    v = b.call("topk", b.var("x", x.shape, "float32"), k=3, axis=-1, ret_type="both",
               dtype="int64")
    g = infer_types(b.build([b.get_item(v, 1), b.get_item(v, 0)]))
    idx, vals = TorchExecutor(g, device="cpu").run({"x": x})
    order = np.argsort(-x, axis=-1, kind="stable")[:, :3]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(vals, np.take_along_axis(x, order, -1))
    assert idx.dtype == np.int64


def test_integer_ops_read_no_float_path():
    """The integer forms stay integer end to end: no float32 round trip
    loses an int32 above 2^24."""
    big = np.array([2 ** 30 + 1, -(2 ** 30) - 3], np.int32)
    for op, args in (("negative", [big]), ("abs", [big]), ("sign", [big]),
                     ("divide", [big, np.array([3, -7], np.int32)]),
                     ("mod", [big, np.array([3, -7], np.int32)]),
                     ("trunc_mod", [big, np.array([3, -7], np.int32)])):
        got, want = _both(op, *args)
        _held(got.numpy(), want, EXACT, op)


def test_scatter_add_sums_in_the_oracles_order_on_the_cpu():
    """Float adds into one place, in C order, as np.add.at: bit-equal."""
    data = np.zeros((2, 3), np.float32)
    idx = np.zeros((64, 3), np.int64)
    upd = floats(64, 3, seed=9, scale=1e3)
    upd[::7] *= 1e-6
    got, want = _both("scatter_elements", data, idx, upd, axis=0, reduction="add")
    assert got.numpy().tobytes() == want.tobytes()
    got, want = _both("scatter_nd", data, np.zeros((64, 1), np.int64), upd, mode="add")
    assert got.numpy().tobytes() == want.tobytes()
