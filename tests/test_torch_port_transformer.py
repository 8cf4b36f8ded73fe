"""The float op set and the transformer zoo of the port on the CPU, against
the JAX package.

Each op runs as a one-op graph in both packages on the same numpy inputs:
the port's type relation and numpy oracle equal the JAX package's (JSON and
bits), and its torch impl equals the JAX package's oracle and `jax_impl`
(elementwise, layout and gather ops bit for bit; float products, layer norm,
gelu and tanh within rtol 1e-5, atol 1e-6: a sum in another order, another
libm).  The zoo graphs equal the reference's node for node and param for
param, at small sizes and at BERT-base's published widths; the JAX package's
fused BERT JSON runs in the port; the CLI takes the zoo names and quantizes
and compiles a transformer as the JAX package's CLI does."""

import numpy as np
import pytest

from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.ir.transforms import fuse_attention as j_fuse_attention
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.runtime.executor import JaxExecutor
from tachikoma_tpu_torch import Graph, GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.ir.transforms import fuse_attention
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes

RTOL, ATOL = 1e-5, 1e-6
GRAPH_RTOL, GRAPH_ATOL = 1e-4, 1e-5


class C:
    """An input that is a const of the graph, not a var."""

    def __init__(self, value):
        self.value = np.asarray(value)


def _f(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _i(lo, hi, *shape, dtype=np.int32, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


# (id, op, inputs, attrs, exact)
OP_CASES = [
    ("add_f32_broadcast", "add", [_f(2, 3, 4), _f(1, 3, 1, seed=1)], {}, True),
    ("add_i32_wraps", "add", [np.array([2**31 - 5, -2**31 + 1, 7], np.int32),
                              np.array([10, -3, 5], np.int32)], {}, True),
    ("add_i8_i32_promotes", "add", [_i(-128, 128, 3, 4, dtype=np.int8),
                                    _i(-1000, 1000, 3, 4, seed=1)], {}, True),
    ("multiply_f32_scalar_const", "multiply", [_f(2, 3, 4, 4), C(np.float32(0.125))], {}, True),
    ("multiply_i8_wraps", "multiply", [_i(-128, 128, 5, dtype=np.int8),
                                       _i(-128, 128, 5, dtype=np.int8, seed=1)], {}, True),
    ("dense_3d", "nn.dense", [_f(2, 5, 7), _f(7, 3, seed=1)], {}, False),
    ("dense_2d", "nn.dense", [_f(5, 64), _f(64, 9, seed=1)], {}, False),
    ("bmm", "nn.batch_matmul", [_f(2, 3, 4, 5), _f(2, 3, 5, 6, seed=1)], {}, False),
    ("bmm_transpose_b", "nn.batch_matmul", [_f(2, 3, 4, 5), _f(2, 3, 6, 5, seed=1)],
     {"transpose_b": True}, False),
    ("bmm_transpose_a", "nn.batch_matmul", [_f(2, 5, 4), _f(2, 5, 6, seed=1)],
     {"transpose_a": True}, False),
    ("bmm_transpose_both", "nn.batch_matmul", [_f(2, 5, 4), _f(2, 6, 5, seed=1)],
     {"transpose_a": True, "transpose_b": True}, False),
    ("bmm_broadcast_batch", "nn.batch_matmul", [_f(1, 3, 4, 5), _f(2, 1, 5, 6, seed=1)], {},
     False),
    ("matmul_lm_head", "nn.matmul", [_f(1, 8, 16), _f(16, 10, seed=1)], {}, False),
    ("layer_norm_eps_1e-12", "nn.layer_norm", [_f(2, 5, 16), _f(16, seed=1), _f(16, seed=2)],
     {"axis": -1, "epsilon": 1e-12}, False),
    ("layer_norm_default_eps", "nn.layer_norm", [_f(3, 32) * 4 + 1, _f(32, seed=1),
                                                 _f(32, seed=2)], {}, False),
    ("gelu_erf", "nn.gelu", [_f(4, 33) * 3], {}, False),
    ("gelu_tanh", "nn.gelu", [_f(4, 33) * 3], {"approximate": "tanh"}, False),
    ("tanh", "tanh", [_f(4, 33) * 3], {}, False),
    ("reshape_minus1_first", "reshape", [_f(2, 3, 4)], {"newshape": (-1, 4)}, True),
    ("reshape_minus1_last", "reshape", [_f(2, 12)], {"newshape": (2, 3, -1)}, True),
    ("strided_slice_axes", "strided_slice", [_f(2, 5, 4)],
     {"begin": (0, 0), "end": (2, 1), "strides": (1, 1), "axes": (0, 1)}, True),
    ("strided_slice_negative_stride", "strided_slice", [_f(3, 6)],
     {"begin": (5,), "end": (0,), "strides": (-2,), "axes": (1,)}, True),
    ("strided_slice_no_axes", "strided_slice", [_f(4, 6)],
     {"begin": (1, 0), "end": (3, 6), "strides": (1, 2)}, True),
    ("broadcast_to", "broadcast_to", [_f(1, 1, 8)], {"shape": (3, 1, 8)}, True),
    ("concatenate_axis1", "concatenate", [_f(2, 1, 8), _f(2, 5, 8, seed=1)], {"axis": 1}, True),
    ("concatenate_three_last_axis", "concatenate", [_f(2, 3), _f(2, 1, seed=1), _f(2, 4, seed=2)],
     {"axis": -1}, True),
    ("conv2d_patch_embed", "nn.conv2d", [_f(2, 16, 16, 3), _f(4, 4, 3, 8, seed=1)],
     {"strides": (4, 4), "padding": (0, 0, 0, 0)}, False),
    ("conv2d_3x3_pad1", "nn.conv2d", [_f(1, 7, 9, 5), _f(3, 3, 5, 6, seed=1)],
     {"strides": (1, 1), "padding": (1, 1, 1, 1)}, False),
    ("conv2d_asymmetric_pad_s2", "nn.conv2d", [_f(1, 8, 7, 4), _f(3, 3, 4, 6, seed=1)],
     {"strides": (2, 2), "padding": (0, 1, 1, 0)}, False),
    ("conv2d_depthwise", "nn.conv2d", [_f(1, 6, 6, 4), _f(3, 3, 1, 4, seed=1)],
     {"padding": (1, 1, 1, 1), "groups": 4}, False),
    ("take_clip_out_of_range", "take", [_f(10, 4), np.array([[-3, 0, 9, 12, 50]], np.int32)],
     {"axis": 0}, True),
    ("take_clip_embedding_table", "take", [_f(300, 8), _i(-20, 320, 2, 6)], {"axis": 0}, True),
    ("take_wrap", "take", [_f(10, 4), np.array([-3, 0, 9, 12, 50], np.int32)],
     {"axis": 0, "mode": "wrap"}, True),
    ("take_axis1", "take", [_f(3, 7), np.array([[6, 0], [9, -1]], np.int32)], {"axis": 1}, True),
    ("take_flat", "take", [_f(3, 4), np.array([0, 11, 13, -2], np.int32)], {}, True),
]


def _one_op_graph(builder, op, inputs, attrs):
    b = builder("op")
    names = [b.const(a.value, name=f"c{i}") if isinstance(a, C)
             else b.var(f"x{i}", a.shape, str(a.dtype)) for i, a in enumerate(inputs)]
    return b.build(b.call(op, *names, name="out", **attrs))


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_matches_reference_oracle_and_jax_impl(case):
    _, op, inputs, attrs, exact = case
    jg = j_infer_types(_one_op_graph(JGraphBuilder, op, inputs, attrs))
    g = infer_types(_one_op_graph(GraphBuilder, op, inputs, attrs))
    assert g.to_json() == jg.to_json()
    feeds = {f"x{i}": a for i, a in enumerate(inputs) if not isinstance(a, C)}
    want = j_run_graph(jg, feeds)[0]
    jax_out = JaxExecutor(jg).run(feeds)[0]
    np.testing.assert_array_equal(run_graph(g, feeds)[0], want)
    got = TorchExecutor(g, device="cpu").run(feeds)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_out)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=ATOL)


def test_integer_products_have_no_torch_impl():
    """Integer nn.batch_matmul has no torch impl (quantized graphs carry the
    qnn form); integer nn.dense has one only where float64 sums it exactly
    (operands of at most 16 bits: the JAX package's placement tests run an
    int8 one), == the oracle, and none for wider operands."""
    x8 = np.arange(-3, 3, dtype=np.int8).reshape(2, 3)
    for dtype, ok in (("int8", True), ("int32", False)):
        b = GraphBuilder()
        x = b.var("x", (2, 3), dtype)
        w = b.const(np.full((3, 4), -7, dtype), name="w")
        g = b.build(b.call("nn.dense", x, w, out_dtype="int32", name="d"))
        if ok:
            got = TorchExecutor(g, device="cpu").run(x8)[0]
            assert got.dtype == np.int32 and (got == run_graph(g, x8)[0]).all()
        else:
            with pytest.raises(NotImplementedError, match="no exact torch impl"):
                TorchExecutor(g, device="cpu").run(x8.astype(dtype))
    b = GraphBuilder()
    a = b.var("a", (2, 3, 4), "int8")
    g = b.build(b.call("nn.batch_matmul", a, a, transpose_b=True, name="m"))
    with pytest.raises(NotImplementedError, match="qnn"):
        TorchExecutor(g, device="cpu").run(np.ones((2, 3, 4), np.int8))
    assert get_op("nn.matmul").flops is get_op("nn.batch_matmul").flops is not None


SMALL = {
    "bert": dict(batch_size=2, seq_len=32, hidden=64, layers=2, heads=4, ffn_dim=128, vocab=100,
                 seed=3),
    "gpt2": dict(batch_size=1, seq_len=24, hidden=48, layers=3, heads=4, ffn_dim=96, vocab=80,
                 seed=4),
    "vit": dict(batch_size=2, image_size=32, patch=8, hidden=64, layers=2, heads=4, ffn_dim=128,
                num_classes=10, seed=5),
}


def _same_graph(g, ref):
    assert g.structural_hash() == ref.structural_hash()
    assert g.structural_hash(include_params=True) == ref.structural_hash(include_params=True)
    assert g.params.keys() == ref.params.keys()
    for k, v in ref.params.items():
        assert g.params[k].dtype == v.dtype and (g.params[k] == v).all(), k


@pytest.mark.parametrize("model", sorted(SMALL))
def test_zoo_graph_equals_reference(model):
    g, ref = getattr(pt, model)(**SMALL[model]), getattr(jt, model)(**SMALL[model])
    _same_graph(g, ref)
    ops = {n.op for n in g.nodes}
    assert {"nn.layer_norm", "nn.batch_matmul", "multiply", "nn.softmax", "reshape",
            "transpose", "add"} <= ops
    assert ("nn.matmul" in ops) == (model == "gpt2")
    assert ("nn.conv2d" in ops) == (model == "vit")


def test_bert_base_at_published_widths_equals_reference():
    """BERT-base (hidden 768, 12 layers, 12 heads, FFN 3072, vocab 30522),
    built once by each package and not run."""
    g, ref = pt.bert_base(batch_size=1, seq_len=128, seed=0), jt.bert_base(batch_size=1,
                                                                          seq_len=128, seed=0)
    _same_graph(g, ref)
    assert g.params["tok_emb"].shape == (30522, 768)
    assert sum(n.op == "nn.softmax" for n in g.nodes) == 12
    assert sum(n.op == "tk.attention" for n in fuse_attention(g).nodes) == 12


def test_reference_fused_bert_json_runs_in_the_port():
    jg = j_fuse_attention(jt.bert(**SMALL["bert"]))
    g = from_reference_graph(jg.to_json())
    assert g.structural_bytes(include_params=True) == jg.structural_bytes(include_params=True)
    x = np.random.default_rng(6).integers(-5, 130, (2, 32)).astype(np.int32)  # some ids clip
    names = computational_nodes(g)
    got = TorchExecutor(g, capture=names, device="cpu").run(x)
    want = JaxExecutor(jg, capture=names).run(x)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=GRAPH_RTOL, atol=GRAPH_ATOL, err_msg=name)


def test_cli_runs_a_fused_transformer_and_refuses_to_quantize_it(tmp_path, capsys, monkeypatch):
    """The CLI runs a fused float transformer, and quantizes and compiles the
    transformers (a graph file with its tk.attention left float, and the zoo
    names, with and without --transformer) to the JAX package's CLI's
    graphs.  The name is older than the quantizer's transformer handlers,
    which ended the refusal."""
    from tachikoma_tpu.cli import main as j_cli_main
    from tachikoma_tpu_torch.runtime.artifact import load_artifact

    path = tmp_path / "bert.json"
    g = fuse_attention(pt.bert(**SMALL["bert"]))
    path.write_text(g.to_json())
    cli_main(["info", str(path)])
    assert "tk.attention             2" in capsys.readouterr().out
    out = tmp_path / "out.npz"
    cli_main(["run", str(path), "--device", "cpu", "-o", str(out)])
    x = np.random.default_rng(0).integers(0, 100, (2, 32)).astype(np.int32)  # the CLI's input
    want = TorchExecutor(g, device="cpu").run(x)[0]
    np.testing.assert_array_equal(np.load(out)[g.outputs[0]], want)

    def same_output(cmd, model, extra):
        mine, ref = tmp_path / f"p_{cmd}", tmp_path / f"j_{cmd}"
        cli_main([cmd, model, "-o", str(mine), *extra])
        j_cli_main([cmd, model, "-o", str(ref), *extra])
        if cmd == "quantize":
            assert mine.read_text() == ref.read_text()
            return Graph.from_json(mine.read_text())
        qa, qb = load_artifact(str(mine))[0], load_artifact(str(ref))[0]
        assert qa.to_json() == qb.to_json()
        return qa

    for extra in ([], ["--transformer"]):
        q = same_output("quantize", str(path), extra)
        assert sum(n.op == "tk.attention" for n in q.nodes) == 2  # left float
    # the zoo names reach the transformer builders (small stand-ins here)
    built = []
    for name, fn in (("bert", "bert_base"), ("bert_base", "bert_base"), ("gpt2", "gpt2_small"),
                     ("vit_b16", "vit_b16"), ("vit_l16", "vit_l16")):
        model = "vit" if fn.startswith("vit") else fn.split("_")[0]
        monkeypatch.setattr(pt, fn, lambda *a, _m=model, _fn=fn, **k: (
            built.append(_fn), getattr(pt, _m)(**SMALL[_m]))[1])
        monkeypatch.setattr(jt, fn, lambda *a, _m=model, **k: getattr(jt, _m)(**SMALL[_m]))
        for extra in ([], ["--transformer"]):
            for cmd in ("quantize", "compile"):
                q = same_output(cmd, name, extra)
                ops = {n.op for n in q.nodes}
                assert {"qnn.batch_matmul", "qnn.layer_norm"} <= ops
                assert ("qnn.softmax" in ops) == bool(extra)
    assert built == [fn for fn in ("bert_base", "bert_base", "gpt2_small", "vit_b16", "vit_l16")
                     for _ in range(4)]
