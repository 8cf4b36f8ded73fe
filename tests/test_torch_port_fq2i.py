"""The port's FQ2I (quantize/fq2i.py) on the CPU, against the JAX package's:
every test of tests/test_fq2i.py run with both importers behind its
`from_onnx`, both rewrites behind its `fq2i` and both runs behind its
`run_graph`; the jax-free copies of those models in
tests/torch_import_cases.py (written with the port's protobuf encoder),
rewritten, fused and run on the kernels' plain versions; the rewrite's
pieces (downstream scale resolution, exact weight recovery, the float
fallback where no quantize defines a scale).

Graphs compare as `Graph.to_json()` does (equal bytes, `same_graph`); integer values ==,
float values within rtol 1e-5, atol 1e-5 (the float convs of the QDQ
simulations, summed by torch and by numpy in other orders); the integer
graphs' dequantized outputs are == all the same."""

import inspect

import numpy as np
import pytest

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import test_fq2i as j_fq2i_tests
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend.onnx import from_onnx as j_from_onnx
from tachikoma_tpu.quantize.fq2i import fq2i as j_fq2i
from tachikoma_tpu.runtime.executor import computational_nodes, run_graph_jax
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu_torch.frontend import from_onnx
from tachikoma_tpu_torch.frontend.onnx_proto import encode
from tachikoma_tpu_torch.ir.graph import GraphBuilder
from tachikoma_tpu_torch.ops.kernels import conv, matmul_int8
from tachikoma_tpu_torch.quantize.fq2i import FQ2IQuantizer, ScaleUnresolved, _QDQScales, fq2i
from tachikoma_tpu_torch.quantize.config import QConfig
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from torch_import_cases import QDQ_CASES, same_graph

FLOAT_OPS = {"nn.conv2d", "nn.dense", "nn.matmul", "nn.batch_matmul"}
RTOL, ATOL = 1e-5, 1e-5   # the QDQ float simulations' float convs, torch's sums against numpy's


def _held(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


JAX_FQ2I_TESTS = sorted(n for n in dir(j_fq2i_tests) if n.startswith("test_"))


@pytest.mark.parametrize("name", JAX_FQ2I_TESTS)
def test_jax_fq2i_tests_rewrite_and_run_as_the_references(name, monkeypatch):
    paired, runs = {}, []

    def both_import(model, input_shapes=None):
        jg = j_from_onnx(model, input_shapes)
        g = from_onnx(model, input_shapes)
        assert same_graph(g, jg)
        paired[id(jg)] = g
        return jg

    def both_fq2i(jg, config=None):
        jig = j_fq2i(jg, config)
        ig = fq2i(paired[id(jg)], config)
        assert same_graph(ig, jig)
        paired[id(jig)] = ig
        return jig

    def both_run(jg, inputs, *a, **k):
        wants = j_run_graph(jg, inputs, *a, **k)
        g = paired[id(jg)]
        names = computational_nodes(jg)
        seen = {}
        j_run_graph(jg, inputs, intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
        for nm, got in zip(names, TorchExecutor(g, capture=names, device="cpu").run(inputs)):
            _held(got, seen[nm], f"{name} {nm} ({g[nm].op})")
        for got, want in zip(TorchExecutor(g, device="cpu").run(inputs),
                             run_graph_jax(jg, inputs)):
            _held(got, want, f"{name} vs JaxExecutor")
        runs.append(name)
        return wants

    monkeypatch.setattr(j_fq2i_tests, "from_onnx", both_import)
    monkeypatch.setattr(j_fq2i_tests, "fq2i", both_fq2i)
    monkeypatch.setattr(j_fq2i_tests, "run_graph", both_run)
    fn = getattr(j_fq2i_tests, name)
    fn(**({"rng": np.random.default_rng(0)} if "rng" in inspect.signature(fn).parameters
          else {}))
    assert len(runs) == 2       # the QDQ simulation and the integer graph


@pytest.mark.parametrize("case", sorted(QDQ_CASES))
def test_jax_free_copies_fuse_and_run_on_the_kernels(case, monkeypatch):
    """The QDQ models of tests/torch_import_cases.py are the JAX tests'
    (same bytes from the same seed); rewritten they hold integer ops only
    between the input's quantize and the output's dequantize, fuse as the
    JAX package fuses them onto K1 / K2 (here their plain versions), and
    == the JAX oracle."""
    model, shape = QDQ_CASES[case](np.random.default_rng(0))
    jbuild = {"qdq_conv": lambda r: j_fq2i_tests._qdq_conv_model(r)[0]}.get(case)
    if jbuild is not None:
        assert encode(model, "ModelProto") == encode(jbuild(np.random.default_rng(0)),
                                                     "ModelProto")
    g, jg = from_onnx(model), j_from_onnx(model)
    ig, jig = fq2i(g), j_fq2i(jg)
    assert same_graph(ig, jig)
    ops = {n.op for n in ig.nodes}
    assert not ops & FLOAT_OPS and ops & {"qnn.conv2d", "qnn.dense"}
    assert [n.op for n in ig.nodes if n.op not in ("var", "const")][0] == "qnn.quantize"
    fused = fuse_qnn(ig)
    assert same_graph(fused, j_fuse_qnn(jig))
    kernel = "tk.dense_rq" if case == "qlinear_matmul" else "tk.conv2d_rq"
    assert kernel in {n.op for n in fused.nodes}
    calls = []
    for mod, fn in ((matmul_int8, "qgemm_rq"), (conv, "qconv_rq")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **k: (calls.append(_n),
                                                                       _o(*a, **k))[1])
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = TorchExecutor(fused, device="cpu").run([x])[0]
    assert calls == ["qgemm_rq" if case == "qlinear_matmul" else "qconv_rq"]
    _held(got, j_run_graph(jig, [x])[0], f"{case} fused")
    _held(got, np.asarray(run_graph_jax(j_fuse_qnn(jig), [x])[0]), f"{case} fused vs JaxExecutor")


def test_weights_are_the_models_exact_int8():
    model, _ = QDQ_CASES["qdq_conv"](np.random.default_rng(0))
    wq = np.random.default_rng(0).integers(-127, 127, (8, 4, 3, 3)).astype(np.int8)
    ig = fq2i(from_onnx(model))
    qw = [p for n, p in ig.params.items() if n.endswith("_qw")]
    assert len(qw) == 1 and qw[0].dtype == np.int8
    np.testing.assert_array_equal(qw[0], np.transpose(wq, (2, 3, 1, 0)))


def test_scale_resolution_and_float_fallback_as_the_reference():
    """_QDQScales finds the nearest downstream quantize through
    scale-transparent ops; a tensor with none raises ScaleUnresolved, and
    FQ2I keeps such a node in float (the boundary quantize restores int8)."""
    from tachikoma_tpu.ir.graph import Graph as JGraph
    from tachikoma_tpu.quantize.fq2i import _QDQScales as JScales

    b = GraphBuilder("t")
    x = b.var("x", (1, 4), "float32")
    q = b.call("qnn.quantize", x, scale=0.1, zero_point=2, out_dtype="int8")
    d = b.call("qnn.dequantize", q, scale=0.1, zero_point=2)
    s = b.call("sigmoid", d)
    r = b.call("nn.relu", b.call("reshape", s, newshape=(4, 1)))
    q2 = b.call("qnn.quantize", r, scale=0.02, zero_point=-5, out_dtype="int8")
    out = b.call("qnn.dequantize", q2, scale=0.02, zero_point=-5)
    g = b.build(out)
    from tachikoma_tpu_torch.ir.infer import infer_types

    g = infer_types(g)
    jg = JGraph.from_json(g.to_json())
    sc, jsc = _QDQScales(g, QConfig()), JScales(jg, None)
    assert sc.scale_zp(s) == jsc.scale_zp(s) == (0.02, -5)
    with pytest.raises(ScaleUnresolved):
        sc.scale_zp(out)
    ig = FQ2IQuantizer(g).run()
    assert same_graph(ig, j_fq2i(jg))
    xv = np.array([[-1.0, 0.0, 0.5, 3.0]], np.float32)
    _held(TorchExecutor(ig, device="cpu").run([xv])[0], j_run_graph(j_fq2i(jg), [xv])[0], "fb")
