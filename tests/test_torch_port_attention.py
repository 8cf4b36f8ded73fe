"""The float attention path of the port on the CPU, against the JAX package:
K6's plain version and the port's tk.attention against the Pallas
`flash_attention` in interpret mode and the oracle `_attn_np`; the port's
`fuse_attention` against the JAX package's (JSON equal); the fused BERT,
GPT-2 and ViT forwards against `JaxExecutor` and the unfused oracle.

Tolerances are tests/test_flash_attention.py's: rtol 2e-5, atol 2e-6 for
the kernel against a float64 softmax; rtol 1e-4, atol 1e-5 for a forward."""

import numpy as np
import pytest
import torch

from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.ir.transforms import fuse_attention as j_fuse_attention
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.ops.pallas.flash_attention import flash_attention as j_flash_attention
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.ir.transforms import fuse_attention
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.ops import attention
from tachikoma_tpu_torch.ops.kernels import _lib
from tachikoma_tpu_torch.ops.kernels.flash_attention import (KG_DVS, TILES, WARPS, fa_plan,
                                                              fa_smem_bytes,
                                                              flash_attention,
                                                              flash_attention_plain)
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

KERNEL_RTOL, KERNEL_ATOL = 2e-5, 2e-6
GRAPH_RTOL, GRAPH_ATOL = 1e-4, 1e-5

# (B, H, S, D, causal): tests/test_flash_attention.py's four shapes,
# ViT-B/16's (S = 197: the keys of the last tile are masked) and two head
# widths above 128 (K6 splits the output columns across blocks there)
SHAPES = [(2, 2, 128, 64, False), (1, 3, 256, 64, True), (2, 2, 200, 128, False),
          (1, 2, 130, 64, True), (1, 12, 197, 64, False), (1, 2, 24, 160, False),
          (1, 2, 24, 256, True)]

# the sizes of tests/test_flash_attention.py:46,62; ViT at image 32, patch 8
# (S = 17, a ragged size)
MODELS = {
    "bert": (dict(batch_size=2, seq_len=32, hidden=64, layers=2, heads=4, ffn_dim=128,
                  vocab=100, seed=0), lambda rng: rng.integers(0, 100, (2, 32)).astype(np.int32)),
    "gpt2": (dict(batch_size=1, seq_len=32, hidden=64, layers=2, heads=4, ffn_dim=128,
                  vocab=80, seed=1), lambda rng: rng.integers(0, 80, (1, 32)).astype(np.int32)),
    "vit": (dict(batch_size=2, image_size=32, patch=8, hidden=64, layers=2, heads=4,
                 ffn_dim=128, num_classes=10, seed=2),
            lambda rng: rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda c: "x".join(map(str, c)))
def interpret_case(request):
    """Inputs from a seed and the Pallas kernel's output in interpret mode,
    computed once per shape (0.4-2 s each on the CPU)."""
    import jax.numpy as jnp

    b, h, s, d, causal = request.param
    q, k, v = _qkv((b, h, s, d), seed=s + d)
    want = np.asarray(j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, interpret=True))
    return q, k, v, causal, want


def test_plain_matches_pallas_kernel_in_interpret_mode(interpret_case):
    q, k, v, causal, want = interpret_case
    got = flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_torch_impl_matches_pallas_kernel_and_oracle(interpret_case):
    """The port's tk.attention on the CPU (the wrapper, which takes the plain
    version for a CPU tensor) against the kernel and the JAX package's
    `_attn_np`; the port's oracle is the JAX package's, bit for bit."""
    q, k, v, causal, want = interpret_case
    attrs = {"scale": float(np.float32(1 / np.sqrt(q.shape[-1]))), "causal": causal}
    node = Node("attn", "tk.attention", ("q", "k", "v"), attrs)
    before = _lib.LAUNCHES["flash_attn"]
    got = get_op("tk.attention").torch_impl(*(torch.from_numpy(t) for t in (q, k, v)),
                                            node=node).numpy()
    assert _lib.LAUNCHES["flash_attn"] == before  # a CPU tensor launches nothing
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    oracle = j_get_op("tk.attention").np_impl(q, k, v, node=JNode("attn", "tk.attention",
                                                                  ("q", "k", "v"), attrs))
    np.testing.assert_allclose(got, oracle, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_array_equal(get_op("tk.attention").np_impl(q, k, v, node=node), oracle)


@pytest.mark.parametrize("causal", [False, True])
def test_wrapper_on_cpu_is_the_plain_version(causal):
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 2, 70, 40), seed=3))
    got = flash_attention(q, k, v, scale=0.2, causal=causal)
    assert torch.equal(got, flash_attention_plain(q, k, v, scale=0.2, causal=causal))
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fuse_attention_equals_reference(model):
    kw, _ = MODELS[model]
    jg, g = getattr(jt, model)(**kw), getattr(pt, model)(**kw)
    fused, j_fused = fuse_attention(g), j_fuse_attention(jg)
    assert fused.to_json() == j_fused.to_json()
    attn = [n for n in fused.nodes if n.op == "tk.attention"]
    assert len(attn) == 2
    assert all(bool(n.attrs["causal"]) == (model == "gpt2") for n in attn)
    assert not any(n.op in ("nn.softmax", "nn.batch_matmul") for n in fused.nodes)
    if model == "vit":
        assert fused[attn[0].inputs[0]].shape == (2, 4, 17, 16)
    # a graph with nothing to fuse comes back as it is
    assert fuse_attention(fused).to_json() == fused.to_json()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fused_forward_matches_jax_executor_and_unfused_oracle(model, monkeypatch):
    kw, make_input = MODELS[model]
    x = make_input(np.random.default_rng(11))
    jg = getattr(jt, model)(**kw)
    j_fused = j_fuse_attention(jg)
    fused = fuse_attention(getattr(pt, model)(**kw))
    attn = [n.name for n in fused.nodes if n.op == "tk.attention"]
    names = attn + list(fused.outputs)

    calls = []
    monkeypatch.setattr(attention, "flash_attention", lambda *a, _fn=attention.flash_attention,
                        **k: (calls.append(k["causal"]), _fn(*a, **k))[1])
    got = TorchExecutor(fused, capture=names, device="cpu").run(x)
    assert calls == [model == "gpt2"] * 2
    want = JaxExecutor(j_fused, capture=names).run(x)
    unfused = {}
    logits = j_run_graph(jg, x, intercept=lambda name, op, args, out: unfused.__setitem__(name, out))
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=GRAPH_RTOL, atol=GRAPH_ATOL, err_msg=name)
        # the unfused graph's context bmm carries the fused node's name
        np.testing.assert_allclose(a, unfused[name], rtol=GRAPH_RTOL, atol=GRAPH_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[-1], logits[0], rtol=GRAPH_RTOL, atol=GRAPH_ATOL)
    # per layer, bmm, multiply, softmax (and GPT-2's mask add) go into tk.attention
    assert len(computational_nodes(j_fused)) == len(computational_nodes(jg)) - 2 * (
        4 if model == "gpt2" else 3)


# (G = B*H, S, D): the zoo's calls (BERT-base b4, GPT-2 small b1, ViT-B/16
# b8), the card tests' head widths and two that need Q and K read from
# global memory
PLAN_SHAPES = [(48, 128, 64), (12, 128, 64), (96, 197, 64), (6, 130, 32), (6, 197, 80),
               (2, 130, 160), (4, 197, 256), (2, 130, 320), (2, 40, 1100), (1, 8, 1),
               (2, 24, 3000)]


@pytest.mark.parametrize("g,s,d", PLAN_SHAPES)
def test_fa_plan_covers_every_column_and_fits(g, s, d):
    """K6's plan: a tile it is built for, deep enough for D, output column
    blocks that cover D, a block's planes within 227 KB of shared memory,
    and Q and K read from global memory exactly where D is above 256."""
    plan = fa_plan(g, s, d)
    assert plan["kg"] == (d > 256)
    if plan["kg"]:
        assert plan["w"] == 1 and plan["dq"] == 0 and plan["dv"] in KG_DVS
    else:
        assert (plan["dq"], plan["dv"], plan["bk"]) in TILES and plan["w"] in WARPS
        assert plan["dq"] >= d and (plan["dq"] == 32 or plan["dq"] < 2 * d + 8)
    assert plan["cs"] * plan["dv"] >= d > (plan["cs"] - 1) * plan["dv"]
    assert plan["stages"] in (1, 2) and (plan["stages"] == 1 or s > plan["bk"])
    assert fa_smem_bytes(plan["w"], plan["dq"], plan["dv"], plan["bk"], plan["kg"],
                         plan["stages"]) <= 227 * 1024
    assert plan["blocks"] == -(-s // (16 * plan["w"])) * g * plan["cs"]
