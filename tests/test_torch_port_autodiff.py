"""The port's gradients (runtime/autodiff.py: torch autograd over a
functional run of the torch executor), on the CPU, against the JAX
package's `jax.value_and_grad` over its whole-graph program.

tests/test_autodiff.py's MLP with a log_softmax + cross-entropy loss and a
small CNN (conv, batch norm, relu, pools, dense) go through both packages'
`value_and_grad_fn` from the same seeded weights and inputs: the loss and
every gradient within rtol 1e-4, atol 1e-5 (tests/test_autodiff.py:38-42);
remat (torch.utils.checkpoint) within 1e-5 of the plain run; `wrt`
subsets, a non-scalar loss and a missing card refused; training descends."""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import GraphBuilder as JGraphBuilder
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu.runtime.autodiff import value_and_grad_fn as j_value_and_grad_fn
from tachikoma_tpu_torch import GraphBuilder, infer_types
from tachikoma_tpu_torch.runtime.autodiff import grad_graph, value_and_grad_fn

RTOL, ATOL = 1e-4, 1e-5  # tests/test_autodiff.py:38-42


def mlp_with_loss(B, infer, seed=0):
    rng = np.random.default_rng(seed)
    b = B()
    x = b.var("x", (4, 8), "float32")
    t = b.var("t", (4, 3), "float32")
    w1 = b.const(rng.standard_normal((8, 16)).astype(np.float32) * 0.3, "w1")
    w2 = b.const(rng.standard_normal((16, 3)).astype(np.float32) * 0.3, "w2")
    h = b.call("tanh", b.call("nn.dense", x, w1))
    lsm = b.call("nn.log_softmax", b.call("nn.dense", h, w2), axis=-1)
    return infer(b.build(b.call("nn.cross_entropy_with_logits", lsm, t)))


def cnn_with_loss(B, infer, seed=0):
    """conv 3x3 -> batch norm -> relu -> max pool -> conv -> relu -> global
    average pool -> dense + bias, log_softmax and cross entropy."""
    rng = np.random.default_rng(seed)
    b = B()
    x = b.var("x", (2, 8, 8, 3), "float32")
    t = b.var("t", (2, 5), "float32")

    def c(name, shape, scale=0.3):
        return b.const(rng.standard_normal(shape).astype(np.float32) * scale, name)

    h = b.call("nn.conv2d", x, c("w1", (3, 3, 3, 8)), padding=(1, 1, 1, 1))
    h = b.call("nn.batch_norm", h, c("g", (8,)), c("be", (8,)), c("m", (8,), 0.1),
               b.const(np.abs(rng.standard_normal(8)).astype(np.float32) + 0.5, "v"))
    h = b.call("nn.max_pool2d", b.call("nn.relu", h), pool_size=(2, 2), strides=(2, 2))
    h = b.call("nn.relu", b.call("nn.conv2d", h, c("w2", (3, 3, 8, 6)), padding=(1, 1, 1, 1)))
    h = b.call("reshape", b.call("nn.global_avg_pool2d", h), newshape=(2, 6))
    logits = b.call("nn.bias_add", b.call("nn.dense", h, c("w3", (6, 5))), c("bias", (5,)))
    lsm = b.call("nn.log_softmax", logits, axis=-1)
    return infer(b.build(b.call("nn.cross_entropy_with_logits", lsm, t)))


MODELS = {"mlp": (mlp_with_loss, (4, 8), (4, 3)), "cnn": (cnn_with_loss, (2, 8, 8, 3), (2, 5))}


def _feeds(model, seed=1):
    _, xs, ts = MODELS[model]
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(xs).astype(np.float32),
            "t": rng.dirichlet(np.ones(ts[1]), ts[0]).astype(np.float32)}


def _both(model, **kw):
    build = MODELS[model][0]
    jfn, jtrain, _ = j_value_and_grad_fn(build(JGraphBuilder, j_infer_types), **kw)
    fn, train, frozen = value_and_grad_fn(build(GraphBuilder, infer_types), device="cpu", **kw)
    return (jfn, jtrain), (fn, train, frozen)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_loss_and_grads_match_jax(model):
    (jfn, jtrain), (fn, train, _) = _both(model)
    feeds = _feeds(model)
    jloss, jgrads = jfn(jtrain, dict(feeds))
    loss, grads = fn(train, feeds)
    assert set(grads) == set(jgrads) and loss.shape == ()
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=RTOL, atol=ATOL)
    for k in jgrads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_grad_graph_matches_torch_by_hand():
    g = mlp_with_loss(GraphBuilder, infer_types)
    feeds = _feeds("mlp")
    loss, grads = grad_graph(g, device="cpu")(feeds)
    w1 = torch.tensor(g.params["w1"], requires_grad=True)
    w2 = torch.tensor(g.params["w2"], requires_grad=True)
    lsm = torch.log_softmax(torch.tanh(torch.from_numpy(feeds["x"]) @ w1) @ w2, -1)
    tl = -(torch.from_numpy(feeds["t"]) * lsm).sum() / 4
    tl.backward()
    np.testing.assert_allclose(loss, tl.item(), rtol=1e-5)
    np.testing.assert_allclose(grads["w1"], w1.grad.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads["w2"], w2.grad.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_matches(model):
    (_, _), (fn, train, _) = _both(model)
    (_, _), (fnr, trainr, _) = _both(model, remat=True)
    feeds = _feeds(model)
    l1, g1 = fn(train, feeds)
    l2, g2 = fnr(trainr, feeds)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-5, atol=1e-6)


def test_training_descends():
    fn, train, _ = value_and_grad_fn(mlp_with_loss(GraphBuilder, infer_types), device="cpu")
    feeds = _feeds("mlp")
    losses = []
    for _ in range(25):
        loss, grads = fn(train, feeds)
        losses.append(float(loss))
        train = {k: v - 0.5 * grads[k] for k, v in train.items()}
    assert losses[-1] < losses[0] - 0.15 and losses[-1] == min(losses)


def test_wrt_subset_and_frozen():
    (jfn, jtrain), (fn, train, frozen) = _both("cnn", wrt=["w3", "g"])
    assert set(train) == {"w3", "g"} and {"w1", "w2", "m", "v", "be", "bias"} <= set(frozen)
    feeds = _feeds("cnn")
    loss, grads = fn(train, feeds)
    _, jgrads = jfn(jtrain, dict(feeds))
    for k in ("w3", "g"):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]), rtol=RTOL, atol=ATOL)


def test_non_scalar_loss_and_missing_card_raise(monkeypatch):
    b = GraphBuilder()
    x = b.var("x", (2, 3), "float32")
    g = infer_types(b.build(b.call("nn.dense", x, b.const(np.ones((3, 4), np.float32), "w"))))
    fn, train, _ = value_and_grad_fn(g, device="cpu")
    with pytest.raises(ValueError, match="not scalar"):
        fn(train, {"x": np.ones((2, 3), np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        value_and_grad_fn(g)
