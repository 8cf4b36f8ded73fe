"""The port's torch.fx importer on the CPU, against the JAX package's:
`from_torch` on every model of tests/test_frontend_torch.py (its non-slow
tests, run with both importers behind their `from_torch`, both runs behind
their `run_graph` and both quantizers behind `quantize`), on ResNet-50 of
models/torch_resnet.py at b1 32^2, and the two ops it needed, `nn.silu`
and `nn.upsampling`; the CLI's float `.pt`.

Graphs compare as `Graph.to_json()` does (equal bytes, `same_graph`).  Runs compare the port's
TorchExecutor on the CPU with the JAX package's oracle: integers ==, floats
within rtol 1e-4, atol 1e-5 (tests/test_frontend_torch.py's own tolerance
against torch eager).  `nn.upsampling` equals its oracle; `nn.silu` is
within rtol 1e-6, atol 1e-6 of it (torch's float32 exp and numpy's differ by
an ulp; the rest of the formula is the oracle's)."""

import inspect

import numpy as np
import pytest
import torch

import tachikoma_tpu
import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import tachikoma_tpu.quantize.quantizer as j_quantizer
import test_frontend_torch as j_fx_tests
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend.torch_fx import from_torch as j_from_torch
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.runtime.executor import run_graph_jax
from tachikoma_tpu_torch import run_graph
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.frontend import from_torch
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.models.torch_resnet import resnet50_torch
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from torch_import_cases import same_graph

RTOL, ATOL = 1e-4, 1e-5           # tests/test_frontend_torch.py:13
SILU_RTOL, SILU_ATOL = 1e-6, 1e-6
# ResNet-50's float logits: float32's error at its pooled features' scale of
# 10^3 (4.8e-4 against torch eager at b1 32^2; chip_smoke.py R50_FLOAT_ATOL)
R50_ATOL = 2.5e-3


def _held(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _is_slow(fn) -> bool:
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


JAX_FX_TESTS = sorted(n for n in dir(j_fx_tests) if n.startswith("test_"))


def test_every_non_slow_model_test_is_covered():
    assert [n for n in JAX_FX_TESTS if not _is_slow(getattr(j_fx_tests, n))] == [
        "test_attention_like", "test_avgpool_cat_chunk", "test_embedding_take",
        "test_import_then_quantize", "test_mlp_gelu_layernorm", "test_residual_and_pool",
        "test_simple_cnn"]


# the HF BERT tests run only under `slow`, as in tests/test_frontend_torch.py
@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if _is_slow(getattr(j_fx_tests, n)) else n
    for n in JAX_FX_TESTS])
def test_jax_fx_test_models_import_and_run_as_the_references(name, monkeypatch):
    paired, runs = {}, []

    def both_import(model, example_inputs, input_dtypes=None):
        jg = j_from_torch(model, example_inputs, input_dtypes)
        g = from_torch(model, example_inputs, input_dtypes)
        assert same_graph(g, jg)
        paired[id(jg)] = g
        return jg

    def both_quantize(jg, dataset, *a, **k):
        jq = j_quantize(jg, dataset, *a, **k)
        if id(jg) in paired:
            q = quantize(paired[id(jg)], dataset, *a, **k)
            assert same_graph(q, jq)
            paired[id(jq)] = q
        return jq

    def both_run(jg, inputs, *a, **k):
        wants = j_run_graph(jg, inputs, *a, **k)
        g = paired[id(jg)]
        gots = TorchExecutor(g, device="cpu").run(inputs)
        for nm, got, want in zip(g.outputs, gots, wants):
            _held(got, want, f"{name} {nm} ({g[nm].op})")
        for nm, got, want in zip(g.outputs, gots, run_graph_jax(jg, inputs)):
            _held(got, np.asarray(want), f"{name} {nm} ({g[nm].op}) vs JaxExecutor")
        runs.append(name)
        return wants

    j_quantize = j_quantizer.quantize
    monkeypatch.setattr(j_fx_tests, "from_torch", both_import)
    monkeypatch.setattr(j_fx_tests, "run_graph", both_run)
    monkeypatch.setattr(j_quantizer, "quantize", both_quantize)
    monkeypatch.setattr(tachikoma_tpu, "run_graph", both_run)  # the HF tests import it late
    fn = getattr(j_fx_tests, name)
    fn(**({"rng": np.random.default_rng(0)} if "rng" in inspect.signature(fn).parameters
          else {}))
    assert paired and runs


def test_every_handler_is_the_references():
    from tachikoma_tpu.frontend.torch_fx import _Importer as JImporter
    from tachikoma_tpu_torch.frontend.torch_fx import _Importer

    ours = sorted(n for n in vars(_Importer) if not n.startswith("__"))
    assert ours == sorted(n for n in vars(JImporter) if not n.startswith("__"))
    for n in ours:
        a, b = getattr(_Importer, n), getattr(JImporter, n)
        if callable(a):
            assert inspect.getsource(a) == inspect.getsource(b), n


class _SiluUpsample(torch.nn.Module):
    def __init__(self, mode_module):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.act = torch.nn.SiLU()
        self.up = mode_module

    def forward(self, x):
        h = self.up(self.act(self.conv(x)))
        return torch.nn.functional.silu(h) + 1.0


@pytest.mark.parametrize("up", [torch.nn.Upsample(scale_factor=2),
                                torch.nn.Upsample(scale_factor=(1, 3), mode="nearest"),
                                torch.nn.UpsamplingNearest2d(scale_factor=2)],
                         ids=["upsample2", "upsample1x3", "nearest2d"])
def test_silu_and_upsampling_models(up):
    torch.manual_seed(0)
    m = _SiluUpsample(up).eval()
    shape = (2, 3, 6, 5)
    g, jg = from_torch(m, {"x": shape}), j_from_torch(m, {"x": shape})
    assert same_graph(g, jg)
    ops = [n.op for n in g.nodes]
    assert ops.count("nn.silu") == 2 and ops.count("nn.upsampling") == 1
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    got = TorchExecutor(g, device="cpu").run(x)[0]
    _held(got, want, "vs torch eager")
    _held(got, j_run_graph(jg, x)[0], "vs the JAX oracle")
    _held(run_graph(g, x)[0], j_run_graph(jg, x)[0], "oracle vs oracle")


def test_upsampling_modes_other_than_nearest_are_refused():
    m = torch.nn.Sequential(torch.nn.Upsample(scale_factor=2, mode="bilinear"))
    with pytest.raises(NotImplementedError, match="nearest only"):
        from_torch(m, {"x": (1, 2, 4, 4)})


UPSAMPLING_CASES = [((2, 5, 7, 3), 2.0, 2.0), ((1, 4, 4, 8), 1.5, 3.0), ((1, 3, 2, 1), 0.5, 1.0),
                    ((2, 1, 1, 4), 4.0, 4.0)]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int32"])
@pytest.mark.parametrize("case", UPSAMPLING_CASES, ids=lambda c: "x".join(map(str, c[0]))
                         + f"_{c[1]}_{c[2]}")
def test_upsampling_equals_the_oracle(case, dtype):
    shape, sh, sw = case
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 50).astype(dtype)
    attrs = {"scale_h": sh, "scale_w": sw}
    node, jnode = Node("y", "nn.upsampling", ("x",), attrs), JNode("y", "nn.upsampling", ("x",),
                                                                   attrs)
    op, jop = get_op("nn.upsampling"), j_get_op("nn.upsampling")
    want = jop.np_impl(x, node=jnode)
    assert op.infer(node, [(shape, dtype)]) == jop.infer(jnode, [(shape, dtype)]) \
        == (want.shape, dtype)
    np.testing.assert_array_equal(op.np_impl(x, node=node), want)
    got = op.torch_impl(torch.from_numpy(x), node=node).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jop.jax_impl(x, node=jnode)), want)


@pytest.mark.parametrize("shape,scale", [((7,), 1.0), ((4, 33), 6.0), ((2, 3, 5, 8), 20.0)])
def test_silu_against_the_oracle(shape, scale):
    x = (np.random.default_rng(2).standard_normal(shape) * scale).astype(np.float32)
    x.flat[:3] = [0.0, -88.0, 88.0][:x.size]
    node, jnode = Node("y", "nn.silu", ("x",), {}), JNode("y", "nn.silu", ("x",), {})
    op, jop = get_op("nn.silu"), j_get_op("nn.silu")
    want = jop.np_impl(x, node=jnode)
    assert op.infer(node, [(shape, "float32")]) == (shape, "float32")
    np.testing.assert_array_equal(op.np_impl(x, node=node), want)
    got = op.torch_impl(torch.from_numpy(x), node=node).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SILU_RTOL, atol=SILU_ATOL)
    np.testing.assert_allclose(got, torch.nn.functional.silu(torch.from_numpy(x)).numpy(),
                               rtol=SILU_RTOL, atol=SILU_ATOL)


def test_resnet50_float_import_as_the_reference():
    """ResNet-50 of models/torch_resnet.py at b1 32^2: the JAX importer's
    graph (53 nn.conv2d, 53 nn.batch_norm), run within rtol 1e-4, atol
    R50_ATOL of torch eager and of the JAX oracle; quantized as the JAX
    package quantizes it."""
    m = resnet50_torch()
    shape = (1, 3, 32, 32)
    g, jg = from_torch(m, {"x": shape}), j_from_torch(m, {"x": shape})
    assert same_graph(g, jg)
    ops = [n.op for n in g.nodes]
    assert ops.count("nn.conv2d") == ops.count("nn.batch_norm") == 53
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    got = TorchExecutor(g, device="cpu").run(x)[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=R50_ATOL)
    np.testing.assert_allclose(got, j_run_graph(jg, x)[0], rtol=RTOL, atol=R50_ATOL)
    q = quantize(g, [x])
    assert same_graph(q, j_quantizer.quantize(jg, [x]))


def test_resnet50_logits_near_100_with_varied_top1():
    """At 224^2 the projected fc keeps the logits near 10^2, and the top-1
    class varies over random images and over synthetic_images."""
    from tachikoma_tpu_torch.quantize.dataset import synthetic_images

    m = resnet50_torch()
    noise = np.random.default_rng(0).standard_normal((4, 3, 224, 224)).astype(np.float32)
    images = synthetic_images(4, (224, 224, 3), seed=0).data.transpose(0, 3, 1, 2)
    for x in (noise, np.ascontiguousarray(images)):
        with torch.no_grad():
            logits = m(torch.from_numpy(x)).numpy()
        assert 30 < np.abs(logits).max() < 300
        assert len(set(logits.argmax(-1))) >= 3


def test_cli_runs_a_float_pt(tmp_path, capsys, monkeypatch):
    """A torch.save'd float module through the CLI: the fx importer, with
    the shape from a saved (model, shape) tuple or TK_TORCH_INPUT_SHAPE."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.SiLU(),
                            torch.nn.Upsample(scale_factor=2), torch.nn.Flatten(),
                            torch.nn.Linear(4 * 8 * 8, 5)).eval()
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 4)).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    xin, out = str(tmp_path / "x.npy"), str(tmp_path / "y.npz")
    np.save(xin, x)
    tup, bare = str(tmp_path / "m.pt"), str(tmp_path / "bare.pth")
    torch.save((m, (2, 3, 4, 4)), tup)
    torch.save(m, bare)
    cli_main(["run", tup, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    _held(got[got.files[0]], want, "cli (model, shape)")
    with pytest.raises(SystemExit, match="TK_TORCH_INPUT_SHAPE"):
        cli_main(["run", bare, "--device", "cpu"])
    monkeypatch.setenv("TK_TORCH_INPUT_SHAPE", "2,3,4,4")
    cli_main(["run", bare, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    _held(got[got.files[0]], want, "cli TK_TORCH_INPUT_SHAPE")
    cli_main(["info", tup])
    assert "nn.silu" in capsys.readouterr().out
