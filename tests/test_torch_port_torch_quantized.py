"""The port's prequantized-torch importer on the CPU, against the JAX
package's: `from_torch_quantized` and `import_torch_quantized` on every
model of tests/test_torch_quantized.py (each test run with both importers
behind its import functions), on the jax-free copies of those models in
tests/torch_import_cases.py, and on the torch.ao-quantized ResNet-50 of
models/torch_resnet.py at b1 32^2 (fused to 14 tk.conv2d_rq, 1
tk.conv2d_chain, 4 tk.conv2d_block_stack, 1 tk.dense_rq); the CLI's
quantized `.pt`.

Graphs compare as `Graph.to_json()` does (equal bytes, `same_graph`).  Every node of the port's
CPU run (TorchExecutor, the kernels' plain versions) equals the JAX
package's oracle and its executor: integers ==, floats within rtol 1e-5,
atol 1e-6 (torch's float32 against numpy's in the float interiors torch
itself computes in float: hardswish, leaky ReLU, conv_transpose)."""

import inspect

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import test_torch_quantized as j_tq_tests
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend.torch_quantized import from_torch_quantized as j_from_tq
from tachikoma_tpu.frontend.torch_quantized import import_torch_quantized as j_import_tq
from tachikoma_tpu.runtime.executor import computational_nodes, run_graph_jax
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.frontend.torch_quantized import (from_torch_quantized,
                                                          import_torch_quantized)
from tachikoma_tpu_torch.models.torch_resnet import quantize_fx, resnet50_torch
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from torch_import_cases import TORCH_AO_CASES, same_graph, torch_ao_case

RTOL, ATOL = 1e-5, 1e-6
R50_FUSED = {"tk.conv2d_rq": 14, "tk.conv2d_chain": 1, "tk.conv2d_block_stack": 4,
             "tk.dense_rq": 1}


def _held(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _every_node_as_the_references(g, jg, x, executor=True):
    """The port's CPU run, every computational node, against the JAX
    package's oracle; the outputs against its executor too."""
    names = computational_nodes(jg)
    seen = {}
    j_run_graph(jg, [x], intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    for nm, got in zip(names, TorchExecutor(g, capture=names, device="cpu").run([x])):
        _held(got, seen[nm], f"{nm} ({g[nm].op})")
    if executor:
        outs = TorchExecutor(g, device="cpu").run([x])
        for nm, got, want in zip(g.outputs, outs, run_graph_jax(jg, [x])):
            _held(got, want, f"{nm} vs JaxExecutor")
    return names


JAX_TQ_TESTS = sorted(n for n in dir(j_tq_tests) if n.startswith("test_"))


@pytest.mark.parametrize("name", JAX_TQ_TESTS)
def test_jax_torch_quantized_tests_import_and_run_as_the_references(name, monkeypatch):
    imported = []

    def both(port_fn, jax_fn):
        def run(model, example_inputs, *a, **k):
            jg = jax_fn(model, example_inputs, *a, **k)
            g = port_fn(model, example_inputs, *a, **k)
            assert same_graph(g, jg)
            imported.append((g, jg))
            return jg
        return run

    monkeypatch.setattr(j_tq_tests, "import_torch_quantized",
                        both(import_torch_quantized, j_import_tq))
    monkeypatch.setattr(j_tq_tests, "from_torch_quantized", both(from_torch_quantized, j_from_tq))
    getattr(j_tq_tests, name)()
    assert imported
    for g, jg in imported:
        x = np.random.default_rng(3).standard_normal(jg.inputs[0].shape).astype(np.float32)
        _every_node_as_the_references(g, jg, x)


@pytest.mark.parametrize("case", sorted(TORCH_AO_CASES))
def test_jax_free_copies_are_the_jax_tests_models(case):
    """tests/torch_import_cases.py (imported by the card tests and
    chip_smoke.py, which cannot import the JAX tests) builds the models of
    tests/test_torch_quantized.py: the same imported graph, fused as the
    JAX package fuses it."""
    mq, shape = torch_ao_case(case)
    g = import_torch_quantized(mq, {"x": shape})
    torch.manual_seed(0)
    jmq = {
        "convnet": lambda: j_tq_tests._fx_quantize(j_tq_tests._ConvNet(),
                                                   torch.randn(2, 3, 32, 32)),
        "resblock": lambda: j_tq_tests._fx_quantize(j_tq_tests._ResBlockNet(),
                                                    torch.randn(1, 4, 16, 16)),
        "convnet_fbgemm": lambda: j_tq_tests._fx_quantize(
            j_tq_tests._ConvNet(), torch.randn(1, 3, 16, 16), backend="fbgemm"),
        "convnet_qint8": lambda: j_tq_tests._fx_quantize_qint8(j_tq_tests._ConvNet(),
                                                               torch.randn(2, 3, 16, 16)),
        "mnv3": lambda: j_tq_tests._fx_quantize(j_tq_tests._MNv3Flavor(),
                                                torch.randn(2, 3, 16, 16), backend="qnnpack"),
        "deep_resnet": lambda: j_tq_tests._fx_quantize(j_tq_tests._DeepResNet(),
                                                       torch.randn(2, 3, 16, 16),
                                                       backend="fbgemm"),
        "eager_qf": lambda: _eager(j_tq_tests._EagerQF()),
    }[case]()
    jg = j_import_tq(jmq, {"x": shape})
    assert same_graph(g, jg)
    fused = fuse_qnn(g)
    assert same_graph(fused, j_fuse_qnn(jg))
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    for got, want in zip(TorchExecutor(fused, device="cpu").run([x]), j_run_graph(jg, [x])):
        _held(got, want, f"{case} fused")


def _eager(m):
    from torch_import_cases import eager_quantize

    return eager_quantize(m, (1, 3, 8, 8))


@pytest.fixture(scope="module")
def r50():
    m = resnet50_torch()
    mq = quantize_fx(m, (1, 3, 32, 32), seed=0)
    return m, mq


def test_resnet50_torch_ao_imports_as_the_reference_and_fuses(r50):
    """The torch.ao-quantized ResNet-50 at b1 32^2: the JAX importer's graph
    and fused graph (native ResNet-50's form), the stem's input zero point
    nonzero and the others -128 (quint8's zero points shifted by -128),
    every node of the unfused run and the fused outputs == the JAX oracle."""
    _, mq = r50
    shape = (1, 3, 32, 32)
    g, jg = import_torch_quantized(mq, {"x": shape}), j_import_tq(mq, {"x": shape})
    assert same_graph(g, jg)
    ops = [n.op for n in g.nodes]
    assert (ops.count("qnn.conv2d"), ops.count("qnn.dense"), ops.count("qnn.add")) == (53, 1, 16)
    izps = [int(n.attrs["input_zero_point"]) for n in g.nodes if n.op == "qnn.conv2d"]
    assert izps[0] != 0 and set(izps[1:]) == {-128}
    assert {int(np.max(np.abs(n.attrs.get("kernel_zero_point", 0)))) for n in g.nodes
            if n.op == "qnn.conv2d"} == {0}
    pool = next(n for n in g.nodes if n.op == "nn.adaptive_avg_pool2d")
    assert g[pool.inputs[0]].dtype == "int8"
    fused = fuse_qnn(g)
    assert same_graph(fused, j_fuse_qnn(jg))
    counts = {k: [n.op for n in fused.nodes].count(k) for k in R50_FUSED}
    assert counts == R50_FUSED
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _every_node_as_the_references(g, jg, x, executor=False)
    got = TorchExecutor(fused, device="cpu").run([x])[0]
    _held(got, j_run_graph(jg, [x])[0], "fused logits")


def test_resnet50_torch_ao_near_torch_eager(r50):
    """Not ==: torch requantizes with a float multiply, the graph with the
    31-bit fixed-point one; the logits stay within a few output quanta and
    the top-1 class is torch's."""
    m, mq = r50
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    g = fuse_qnn(import_torch_quantized(mq, {"x": (2, 3, 32, 32)}))
    got = TorchExecutor(g, device="cpu").run([x])[0]
    want = mq(torch.from_numpy(x)).detach().numpy()
    quanta = np.abs(got - want).max() / float(mq.fc.scale)
    assert quanta <= 16, quanta
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_cli_runs_a_quantized_pt(tmp_path, r50):
    """A saved (model, shape) tuple of the torch.ao-quantized ResNet-50:
    the CLI imports it through FQ2I, runs it fused (--device cpu) and its
    output equals the JAX oracle's on the imported graph."""
    _, mq = r50
    path = str(tmp_path / "r50_int8.pt")
    torch.save((mq, (1, 3, 32, 32)), path)
    x = np.random.default_rng(2).standard_normal((1, 3, 32, 32)).astype(np.float32)
    xin, out = str(tmp_path / "x.npy"), str(tmp_path / "y.npz")
    np.save(xin, x)
    cli_main(["run", path, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    want = j_run_graph(j_import_tq(mq, {"x": (1, 3, 32, 32)}), [x])[0]
    _held(got[got.files[0]], want, "cli")
    cli_main(["run", path, "--device", "cpu", "--backend", "oracle", "--input", xin, "-o", out])
    _held(np.load(out)[got.files[0]], want, "cli oracle")


def test_import_signatures_are_the_references():
    for ours, theirs in ((from_torch_quantized, j_from_tq), (import_torch_quantized, j_import_tq)):
        assert inspect.signature(ours) == inspect.signature(theirs)
