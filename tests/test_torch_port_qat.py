"""The port's quantization-aware training (quantize/qat.py, the fake-quant
ops of ops/qnn.py, runtime/autodiff.py), on the CPU, against the JAX package.

`qnn.simulated_quantize` / `simulated_dequantize` equal the JAX package's
oracle and jax impl with == (per tensor and per axis), and their gradient
is its straight-through estimator (the same masks as `jax.grad`, at the
clip's edges too).  `qat_prepare` gives the JAX package's graph (structural
bytes, params included) on tests/test_qat.py's small CNN and on ResNet-18
b2 32² with a cross-entropy loss; one training step through the port's
`value_and_grad_fn` gives `jax.value_and_grad`'s loss and gradients within
rtol 1e-4, atol 1e-5 and lowers the loss; `qat_finalize` from the same
stepped weights gives the JAX package's integer graph and trace."""

import io

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import Graph as JGraph
from tachikoma_tpu import GraphBuilder as JGraphBuilder
from tachikoma_tpu import Node as JNode
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.quantize.qat import qat_finalize as j_qat_finalize
from tachikoma_tpu.quantize.qat import qat_prepare as j_qat_prepare
from tachikoma_tpu.runtime.autodiff import value_and_grad_fn as j_value_and_grad_fn
from tachikoma_tpu.runtime.executor import run_graph_jax
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import Graph, GraphBuilder, Node, infer_types, run_graph
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.quantize.qat import qat_finalize, qat_prepare
from tachikoma_tpu_torch.runtime.autodiff import value_and_grad_fn
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.trace.emitter import emit_trace
from tachikoma_tpu_torch.trace.format import TraceReader

from runtime_cases import one_hot_labels, with_cross_entropy

RTOL, ATOL = 1e-4, 1e-5  # tests/test_autodiff.py:38-42

# ---------------------------------------------------------------------------
# the fake-quant pair
# ---------------------------------------------------------------------------

SIM_CASES = [
    ("per_tensor_zp3", (4, 8), dict(scale=0.05, zero_point=3, out_dtype="int8")),
    ("per_tensor_uint8", (3, 5), dict(scale=0.02, zero_point=128, out_dtype="uint8")),
    ("per_axis_last", (2, 3, 4), dict(scale=[0.01, 0.03, 0.1, 0.5], zero_point=0,
                                      out_dtype="int8", axis=2)),
    ("per_axis_0", (3, 6), dict(scale=[0.02, 0.2, 1.0], zero_point=[0, 5, -7],
                                out_dtype="int8", axis=0)),
]


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)


def _pair_graph(B, infer, shape, attrs):
    b = B()
    v = b.var("x", shape, "float32")
    sq = b.call("qnn.simulated_quantize", v, name="sq", **attrs)
    dq_attrs = {k: v for k, v in attrs.items() if k != "out_dtype"}
    dq = b.call("qnn.simulated_dequantize", sq, name="sdq", **dq_attrs)
    return infer(b.build([sq, dq]))


@pytest.mark.parametrize("shape,attrs", [c[1:] for c in SIM_CASES],
                         ids=[c[0] for c in SIM_CASES])
def test_simulated_quantize_matches_reference(shape, attrs):
    x = _x(shape)
    g = _pair_graph(GraphBuilder, infer_types, shape, attrs)
    jg = _pair_graph(JGraphBuilder, j_infer_types, shape, attrs)
    want = j_run_graph(jg, x)
    for what, got in (("JaxExecutor", run_graph_jax(jg, x)), ("port oracle", run_graph(g, x)),
                      ("port torch", TorchExecutor(g, device="cpu").run(x))):
        for a, b in zip(got, want):
            a = np.asarray(a)
            assert a.dtype == b.dtype == np.float32, what
            np.testing.assert_array_equal(a, b, err_msg=what)
    # the fake-quant round trip is the real quantize -> dequantize pair
    if np.ndim(attrs["scale"]) == 0:
        b2 = GraphBuilder()
        q = b2.call("qnn.quantize", b2.var("x", shape, "float32"), **attrs)
        dq = b2.call("qnn.dequantize", q, **{k: v for k, v in attrs.items() if k != "out_dtype"})
        np.testing.assert_array_equal(run_graph(infer_types(b2.build(dq)), x)[0], want[1])


def _ste_grad(attrs, x):
    """d sum(sdq(sq(x))) / dx from the port's torch impls and from jax.grad
    of the JAX package's jax impls."""
    import jax
    import jax.numpy as jnp

    dq_attrs = {k: v for k, v in attrs.items() if k != "out_dtype"}
    nodes = [Node("s", "qnn.simulated_quantize", ("x",), attrs),
             Node("d", "qnn.simulated_dequantize", ("s",), dq_attrs)]
    jnodes = [JNode("s", "qnn.simulated_quantize", ("x",), attrs),
              JNode("d", "qnn.simulated_dequantize", ("s",), dq_attrs)]
    xt = torch.tensor(x, requires_grad=True)
    out = get_op("qnn.simulated_dequantize").torch_impl(
        get_op("qnn.simulated_quantize").torch_impl(xt, node=nodes[0]), node=nodes[1])
    out.sum().backward()

    def f(v):
        sq = j_get_op("qnn.simulated_quantize").jax_impl(v, node=jnodes[0])
        return j_get_op("qnn.simulated_dequantize").jax_impl(sq, node=jnodes[1]).sum()

    return xt.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x)))


def test_ste_gradient_mask():
    """1 inside the range, 0 where the clip saturates: the range of scale
    0.1 int8 is [-12.8, 12.7]; 12.7 and -12.8 quantize to the edges (inside),
    12.8 and -12.9 past them (outside)."""
    x = np.array([0.5, -0.3, 20.0, -20.0, 3.0, 12.7, -12.8, 12.8, -12.9], np.float32)
    got, want = _ste_grad(dict(scale=0.1, zero_point=0, out_dtype="int8"), x)
    np.testing.assert_allclose(got, [1, 1, 0, 0, 1, 1, 1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,attrs", [c[1:] for c in SIM_CASES],
                         ids=[c[0] for c in SIM_CASES])
def test_ste_gradient_matches_jax(shape, attrs):
    got, want = _ste_grad(attrs, _x(shape, seed=4) * 10)
    assert (got == 0).any() and (got != 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# prepare, train, finalize
# ---------------------------------------------------------------------------

def _tiny_cnn(B, infer, seed, with_loss=True):
    """tests/test_qat.py's model."""
    rng = np.random.default_rng(seed)
    b = B()
    x = b.var("x", (4, 8, 8, 3), "float32")
    w1 = b.const(rng.standard_normal((3, 3, 3, 8)).astype(np.float32) * 0.3, "w1")
    c = b.call("nn.conv2d", x, w1, padding=(1, 1, 1, 1), name="c1")
    c = b.call("nn.relu", c)
    c = b.call("nn.global_avg_pool2d", c)
    c = b.call("reshape", c, newshape=(4, 8))
    w2 = b.const(rng.standard_normal((8, 5)).astype(np.float32) * 0.3, "w2")
    d = b.call("nn.dense", c, w2, name="fc")
    if with_loss:
        d = b.call("mean", b.call("multiply", d, d))  # scalar
    return infer(b.build(d))


def _data(shape, n=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _bytes(g):
    return g.structural_bytes(include_params=True)


def test_tiny_cnn_prepare_train_finalize():
    data = _data((4, 8, 8, 3))
    qat_g = qat_prepare(_tiny_cnn(GraphBuilder, infer_types, 5), data)
    jqat_g = j_qat_prepare(_tiny_cnn(JGraphBuilder, j_infer_types, 5), data)
    assert _bytes(qat_g) == _bytes(jqat_g)
    assert [n.op for n in qat_g.nodes].count("qnn.simulated_quantize") == 4

    fn, train, _ = value_and_grad_fn(qat_g, device="cpu")
    jfn, jtrain, _ = j_value_and_grad_fn(jqat_g)
    x = {"x": data[0]}
    loss0, grads = fn(train, x)
    jloss0, jgrads = jfn(jtrain, dict(x))
    np.testing.assert_allclose(loss0.numpy(), np.asarray(jloss0), rtol=RTOL, atol=ATOL)
    assert set(grads) == set(jgrads) == {"w1", "w2"}
    for k in grads:
        assert float(grads[k].abs().sum()) > 0
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]), rtol=RTOL, atol=ATOL)
    stepped = {k: train[k] - 0.05 * grads[k] for k in grads}
    loss1, _ = fn(stepped, x)
    assert float(loss1) < float(loss0)

    # finalize from the same stepped weights: the JAX package's integer graph
    # and trace (the logits model: the float loss tail does not ship)
    sw = {k: v.numpy() for k, v in stepped.items()}
    qg = qat_finalize(_tiny_cnn(GraphBuilder, infer_types, 5, with_loss=False), stepped, data)
    jqg = j_qat_finalize(_tiny_cnn(JGraphBuilder, j_infer_types, 5, with_loss=False), sw, data)
    assert _bytes(qg) == _bytes(jqg)
    want = j_emit_trace(jqg, data[0], backend="numpy")
    assert emit_trace(qg, data[0], backend="oracle") == want
    _same_integer_trace(emit_trace(qg, data[0], backend="torch", device="cpu"), want)


def _same_integer_trace(blob, ref_blob, rtol=1e-5, atol=1e-6):
    """Integer records byte-equal, float records within rtol / atol."""
    got, ref = (list(TraceReader(io.BytesIO(b))) for b in (blob, ref_blob))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.name, a.op_name, a.attrs) == (b.name, b.op_name, b.attrs)
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), a.name
        else:
            for ta, tb in zip(a.tensors, b.tensors):
                np.testing.assert_allclose(ta.to_array(), tb.to_array(), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def resnet18_qat():
    from tachikoma_tpu.models.vision import resnet as j_resnet

    from tachikoma_tpu_torch.models.vision import resnet

    calib = _data((2, 32, 32, 3), n=1, seed=2)
    feeds = {"data": calib[0], "labels": one_hot_labels(2, 1000)}
    g = with_cross_entropy(resnet(18, batch_size=2, image_size=32, seed=0), Node, Graph)
    jg = with_cross_entropy(j_resnet(18, batch_size=2, image_size=32, seed=0), JNode, JGraph)
    return dict(g=g, jg=jg, calib=calib, qat=qat_prepare(g, [feeds]),
                jqat=j_qat_prepare(jg, [dict(feeds)]), feeds=feeds)


def test_resnet18_prepare_matches_reference(resnet18_qat):
    q, jq = resnet18_qat["qat"], resnet18_qat["jqat"]
    assert _bytes(q) == _bytes(jq)
    ops = [n.op for n in q.nodes]
    # the 21 weights of 20 convs and the dense, and 18 distinct activations
    # (a downsampling block's input feeds two convs: one fake-quant pair)
    assert ops.count("qnn.simulated_quantize") == 39


# ResNet-18's gradients, card or CPU against jax.value_and_grad: each
# tensor's norm-wise relative difference (the float sums of 21 layers run in
# XLA's order and in torch's; a few elements of the first layers' gradients
# differ by 3e-3 relative, the worst tensor by 8.3e-5 norm-wise)
GRAD_NORMWISE = 1e-3


def test_resnet18_loss_and_grads_match_jax(resnet18_qat):
    fn, train, frozen = value_and_grad_fn(resnet18_qat["qat"], device="cpu")
    jfn, jtrain, _ = j_value_and_grad_fn(resnet18_qat["jqat"])
    feeds = resnet18_qat["feeds"]
    loss, grads = fn(train, feeds)
    jloss, jgrads = jfn(jtrain, dict(feeds))
    assert set(grads) == set(jgrads) and not frozen and len(grads) == 21 * 1 + 20 * 4 + 1
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=RTOL, atol=ATOL)
    for k in jgrads:
        a, b = grads[k].numpy(), np.asarray(jgrads[k])
        assert np.linalg.norm(a - b) <= GRAD_NORMWISE * np.linalg.norm(b), k


def test_resnet18_step_and_finalize_match_reference(resnet18_qat):
    """Three SGD steps lower the loss; qat_finalize from those weights ==
    the JAX package's from the same weights."""
    from tachikoma_tpu.models.vision import resnet as j_resnet

    from tachikoma_tpu_torch.models.vision import resnet

    fn, train, _ = value_and_grad_fn(resnet18_qat["qat"], device="cpu")
    feeds = resnet18_qat["feeds"]
    losses = []
    for _ in range(3):
        loss, grads = fn(train, feeds)
        losses.append(float(loss))
        train = {k: v - 1e-5 * grads[k] for k, v in train.items()}
    assert losses[2] < losses[0]
    calib = resnet18_qat["calib"]
    qg = qat_finalize(resnet(18, batch_size=2, image_size=32, seed=0), train, calib)
    jqg = j_qat_finalize(j_resnet(18, batch_size=2, image_size=32, seed=0),
                         {k: v.numpy() for k, v in train.items()}, calib)
    assert _bytes(qg) == _bytes(jqg)
