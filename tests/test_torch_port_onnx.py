"""The port's ONNX import path on the CPU, against the JAX package's: the
protobuf codec, `from_onnx` on every model the JAX package's ONNX tests
build (run through those tests with both importers), on the six exporters'
fixtures (tests/fixtures/*_route.onnx, mxnet_lenet.onnx) and on ResNet-50
as torch.onnx.export lays it out (models/onnx_resnet.py), then quantize,
fuse, run, trace and the CLI.

Graphs compare by `Graph.to_json()` (equal bytes).  Runs compare with the
JAX package's oracle (`run_graph`): integers and bools with ==, floats
within rtol 1e-5, atol 1e-5 (torch's float32 sums and transcendentals
against numpy's; the JAX ONNX tests hold the oracle to torch at 1e-4 to
1e-6).  A float model also stays within the fixtures' rule, rtol 1e-4, atol
1e-4 of the exporters' expected outputs (tests/test_frontend_onnx_routes.py).
XLA's `nn.leaky_relu` is one ulp off the oracle on darknet's float input, so
the integers of that quantized graph after it differ between JaxExecutor and
the oracle; the port equals the oracle, and is held to XLA on the integer
outputs (the rule of tests/test_frontend_onnx_routes.py)."""

import inspect
import io
import os

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import test_fq2i as j_fq2i_tests
import test_frontend_onnx as j_onnx_tests
import test_frontend_onnx_tail as j_tail_tests
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend import onnx_proto as j_proto
from tachikoma_tpu.frontend.onnx import from_onnx as j_from_onnx
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import computational_nodes, run_graph_jax
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import run_graph
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.frontend import from_onnx
from tachikoma_tpu_torch.frontend import onnx_proto as proto
from tachikoma_tpu_torch.models.onnx_resnet import resnet50_onnx
from tachikoma_tpu_torch.ops.kernels import conv, matmul_int8
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = ("paddle_route", "oneflow_route", "caffe_route", "coreml_route", "darknet_route",
            "mxnet_lenet")
RTOL, ATOL = 1e-5, 1e-5          # the port's torch impls against the numpy oracle
ROUTE_RTOL, ROUTE_ATOL = 1e-4, 1e-4  # tests/test_frontend_onnx_routes.py:40


def _path(name: str) -> str:
    return os.path.join(FIX, f"{name}.onnx")


def _io(name: str):
    io_ = np.load(os.path.join(FIX, f"{name}_io.npz"))
    return io_["x"], io_["expected"]


def _held(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_codec_decodes_and_reencodes_as_the_references(name):
    blob = open(_path(name), "rb").read()
    ours, theirs = proto.decode(blob, "ModelProto"), j_proto.decode(blob, "ModelProto")
    assert ours == theirs
    assert proto.encode(ours, "ModelProto") == j_proto.encode(theirs, "ModelProto")
    assert proto.load_model(blob) == proto.load_model(_path(name)) == ours
    for t in ours["graph"]["initializer"]:
        np.testing.assert_array_equal(proto.tensor_to_np(t), j_proto.tensor_to_np(t))
    assert proto.ONNX_DTYPES == j_proto.ONNX_DTYPES and proto.SCHEMAS == j_proto.SCHEMAS


@pytest.mark.parametrize("dtype", ["float32", "int8", "uint8", "int32", "int64", "float64",
                                   "bool", "float16"])
def test_codec_tensor_round_trip(dtype):
    a = (np.random.default_rng(3).standard_normal((3, 4)) * 50).astype(dtype)
    t = proto.np_to_tensor("w", a)
    assert t == j_proto.np_to_tensor("w", a)
    blob = proto.encode(t, "TensorProto")
    assert blob == j_proto.encode(t, "TensorProto")
    back = proto.tensor_to_np(proto.decode(blob, "TensorProto"))
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    # a 0-d tensor keeps its shape (np_to_tensor reads it before the copy)
    s = proto.tensor_to_np(proto.decode(proto.encode(proto.np_to_tensor("s", a[0, 0]),
                                                     "TensorProto"), "TensorProto"))
    assert s.shape == () and s == a[0, 0]


def test_codec_reads_packed_and_unpacked_fields():
    """int64_data / float_data written packed (as exporters write them) and
    dims unpacked, through both decoders."""
    def varint(v):
        return proto._write_varint(v)

    payload = b"".join(varint(v) for v in (3, 1 << 40, 7))
    blob = (varint((1 << 3) | 0) + varint(3) + varint((2 << 3) | 0) + varint(7)
            + varint((7 << 3) | 2) + varint(len(payload)) + payload)
    for mod in (proto, j_proto):
        np.testing.assert_array_equal(mod.tensor_to_np(mod.decode(blob, "TensorProto")),
                                      np.array([3, 1 << 40, 7], np.int64))
    import struct
    fl = struct.pack("<3f", 1.5, -2.0, 0.25)
    blob = (varint((1 << 3) | 0) + varint(3) + varint((4 << 3) | 2) + varint(len(fl)) + fl)
    assert proto.decode(blob, "TensorProto") == j_proto.decode(blob, "TensorProto")
    np.testing.assert_array_equal(proto.tensor_to_np(proto.decode(blob, "TensorProto")),
                                  np.array([1.5, -2.0, 0.25], np.float32))


# ---------------------------------------------------------------------------
# from_onnx on every model the JAX package's ONNX tests build: each test is
# run with both importers behind its `from_onnx` and both runs behind its
# `run_graph`
# ---------------------------------------------------------------------------

def _builds_onnx(fn) -> bool:
    src = inspect.getsource(fn)
    return any(s in src for s in ("from_onnx(", "one_op(", "_qdq_conv_model("))


JAX_ONNX_TESTS = [(mod, name) for mod in (j_onnx_tests, j_tail_tests, j_fq2i_tests)
                  for name in sorted(dir(mod))
                  if name.startswith("test_") and _builds_onnx(getattr(mod, name))]


@pytest.mark.parametrize("mod,name", JAX_ONNX_TESTS,
                         ids=[f"{m.__name__.removeprefix('test_')}.{n}"
                              for m, n in JAX_ONNX_TESTS])
def test_jax_onnx_test_models_import_and_run_as_the_references(mod, name, monkeypatch):
    paired, runs = {}, []

    def both_import(model, input_shapes=None):
        jg = j_from_onnx(model, input_shapes)
        g = from_onnx(model, input_shapes)
        assert g.to_json() == jg.to_json()
        paired[id(jg)] = (jg, g)
        return jg

    def both_run(jg, inputs, *a, **k):
        wants = j_run_graph(jg, inputs, *a, **k)
        if id(jg) in paired:
            g = paired[id(jg)][1]
            gots = TorchExecutor(g, device="cpu").run(inputs)
            for nm, got, want in zip(g.outputs, gots, wants):
                _held(got, want, f"{name} {nm} ({g[nm].op})")
            runs.append(name)
        return wants

    monkeypatch.setattr(mod, "from_onnx", both_import)
    monkeypatch.setattr(mod, "run_graph", both_run)
    fn = getattr(mod, name)
    fn(**({"rng": np.random.default_rng(0)} if "rng" in inspect.signature(fn).parameters
          else {}))
    assert paired
    # every imported graph but a fold-only one was run
    assert runs or name in ("test_dynamic_reshape_idiom_folds",)


def test_every_converter_is_the_references():
    """The port's importer has the JAX importer's converters, name for name."""
    from tachikoma_tpu.frontend.onnx import _OnnxImporter as JImporter
    from tachikoma_tpu_torch.frontend.onnx import _OnnxImporter

    ours = sorted(n for n in dir(_OnnxImporter) if n.startswith("op_"))
    theirs = sorted(n for n in dir(JImporter) if n.startswith("op_"))
    assert ours == theirs and len(ours) == 117


def test_unknown_onnx_op_and_symbolic_dims_are_refused():
    model = j_onnx_tests.make_model(
        nodes=[j_onnx_tests.node("NoSuchOp", ["x"], ["y"])], inputs={"x": (2, 3)},
        outputs={"y": (2, 3)}, initializers={})
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        from_onnx(model)
    model = j_onnx_tests.make_model(
        nodes=[j_onnx_tests.node("Relu", ["x"], ["y"])], inputs={"x": (2, 3)},
        outputs={"y": (2, 3)}, initializers={})
    model["graph"]["input"][0]["type"]["tensor_type"]["shape"]["dim"][0] = {"dim_param": "N"}
    with pytest.raises(ValueError, match="symbolic dim"):
        from_onnx(model)
    g = from_onnx(model, input_shapes={"x": (5, 3)})
    assert g.to_json() == j_from_onnx(model, input_shapes={"x": (5, 3)}).to_json()
    assert g.inputs[0].shape == (5, 3)


# ---------------------------------------------------------------------------
# the six exporters' fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_imports_and_runs_as_the_references(name):
    g, jg = from_onnx(_path(name)), j_from_onnx(_path(name))
    assert g.to_json() == jg.to_json()
    blob = open(_path(name), "rb").read()
    assert from_onnx(blob).to_json() == from_onnx(proto.load_model(blob)).to_json() == g.to_json()
    x, expected = _io(name)
    got = TorchExecutor(g, device="cpu").run([x])[0]
    _held(got, expected, name, ROUTE_RTOL, ROUTE_ATOL)
    _held(got, j_run_graph(jg, [x])[0], name)
    _held(got, np.asarray(run_graph_jax(jg, [x])[0]), name, ROUTE_RTOL, ROUTE_ATOL)
    _held(run_graph(g, [x])[0], expected, name, ROUTE_RTOL, ROUTE_ATOL)


@pytest.fixture(scope="module")
def quantized():
    """Each fixture quantized by both packages on its own input."""
    out = {}
    for name in FIXTURES:
        x, _ = _io(name)
        g, jg = from_onnx(_path(name)), j_from_onnx(_path(name))
        out[name] = (quantize(g, [x]), j_quantize(jg, [x]), x)
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_quantizes_as_the_references_every_node(quantized, name):
    qg, jqg, x = quantized[name]
    assert qg.to_json() == jqg.to_json()
    names = computational_nodes(qg)
    seen = {}
    j_run_graph(jqg, [x], intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    for nm, got in zip(names, TorchExecutor(qg, capture=names, device="cpu").run([x])):
        _held(got, seen[nm], f"{name} {nm} ({qg[nm].op})")
    for got, want in zip(TorchExecutor(qg, device="cpu").run([x]), run_graph_jax(jqg, [x])):
        want = np.asarray(want)
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want)
    # darknet keeps its leaky ReLUs in float; caffe its LRN
    ops = {n.op for n in qg.nodes}
    assert {"caffe_route": "nn.lrn", "darknet_route": "nn.leaky_relu"}.get(name, "qnn.conv2d") \
        in ops


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_fuses_onto_the_kernels_as_the_references(quantized, name, monkeypatch):
    """Fused: the JAX package's fused graph; the convs run K2 (K1 for a 1x1
    conv) and the denses K1, here through their plain versions; every output
    == the oracle's."""
    qg, jqg, x = quantized[name]
    fused = fuse_qnn(qg)
    assert fused.to_json() == j_fuse_qnn(jqg).to_json()
    assert not any(n.op in ("qnn.conv2d", "qnn.dense") for n in fused.nodes)
    calls = []
    for mod, attr in ((matmul_int8, "qgemm_rq"), (conv, "qconv_rq")):
        real = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _r=real, _n=attr, **k: (calls.append(_n),
                                                                          _r(*a, **k))[1])
    got = TorchExecutor(qg, device="cpu", fuse=True).run([x])
    heads = [n for n in fused.nodes if n.op in ("tk.conv2d_rq", "tk.dense_rq")]
    # a 1x1 conv runs K1's GEMM, every other conv K2
    assert len(calls) == len(heads) and "qconv_rq" in calls
    assert calls.count("qgemm_rq") >= sum(n.op == "tk.dense_rq" for n in heads)
    for a, b in zip(got, j_run_graph(jqg, [x])):
        _held(a, b, name)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_traces_as_the_references_numpy_trace(quantized, name):
    qg, jqg, x = quantized[name]
    blob = emit_trace(qg, [x], backend="torch", device="cpu")
    want = j_emit_trace(jqg, [x], backend="numpy")
    got_recs = list(fmt.TraceReader(io.BytesIO(blob)))
    want_recs = list(j_format.TraceReader(io.BytesIO(want)))
    assert len(got_recs) == len(want_recs)
    for a, b in zip(got_recs, want_recs):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        if all(t.to_array().dtype.kind in "iub" for t in a.tensors):
            assert a.encode() == b.encode(), a.name
            continue
        for ta, tb in zip(a.tensors, b.tensors):
            assert ta.role == tb.role
            _held(ta.to_array(), tb.to_array(), a.name)
    res = verify_trace(blob, qg)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got_recs)


# ---------------------------------------------------------------------------
# ResNet-50 as torch.onnx.export writes it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r50_32():
    blob = resnet50_onnx(1, 32)
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(np.float32)
    return blob, x


def test_resnet50_onnx_imports_as_the_reference_and_fuses_as_native_resnet50(r50_32):
    blob, x = r50_32
    m = proto.load_model(blob)
    ops = [n["op_type"] for n in m["graph"]["node"]]
    assert ops.count("Conv") == 53 and ops.count("Add") == 16 and ops.count("Gemm") == 1
    assert {"Relu", "MaxPool", "GlobalAveragePool", "Flatten"} <= set(ops)
    assert j_proto.load_model(blob) == m
    g, jg = from_onnx(blob), j_from_onnx(blob)
    assert g.to_json() == jg.to_json()
    qg, jqg = quantize(g, [x]), j_quantize(jg, [x])
    assert qg.to_json() == jqg.to_json()
    fused = fuse_qnn(qg)
    assert fused.to_json() == j_fuse_qnn(jqg).to_json()
    counts = {op: sum(n.op == op for n in fused.nodes)
              for op in ("tk.conv2d_rq", "tk.conv2d_chain", "tk.conv2d_block_stack",
                         "tk.dense_rq", "qnn.add", "clip", "transpose")}
    assert counts == {"tk.conv2d_rq": 14, "tk.conv2d_chain": 1, "tk.conv2d_block_stack": 4,
                      "tk.dense_rq": 1, "qnn.add": 3, "clip": 3, "transpose": 2}
    got = TorchExecutor(qg, device="cpu", fuse=True).run([x])
    for a, b in zip(got, j_run_graph(jqg, [x])):
        _held(a, b, "resnet50_onnx")
    # the float graph too, against the oracle: 53 convs summed in another
    # order, held within 1e-5 of the largest logit
    want = j_run_graph(jg, [x])[0]
    _held(TorchExecutor(g, device="cpu").run([x])[0], want, "float", 1e-4,
          1e-5 * np.abs(want).max())


def test_resnet50_onnx_is_seeded():
    assert resnet50_onnx(1, 32, num_classes=10, seed=1) == resnet50_onnx(1, 32, num_classes=10,
                                                                          seed=1)
    assert resnet50_onnx(1, 32, num_classes=10, seed=1) != resnet50_onnx(1, 32, num_classes=10,
                                                                          seed=2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_quantizes_and_runs_an_onnx_model_on_the_cpu(tmp_path, capsys):
    from tachikoma_tpu import cli as j_cli

    path = _path("darknet_route")
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    cli_main(["quantize", path, "-o", ours])
    j_cli.main(["quantize", path, "-o", theirs])
    assert open(ours).read() == open(theirs).read()
    x, _ = _io("darknet_route")
    xin, out = str(tmp_path / "x.npy"), str(tmp_path / "y.npz")
    np.save(xin, x)
    cli_main(["run", ours, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    from tachikoma_tpu.ir.graph import Graph as JGraph
    want = j_run_graph(JGraph.from_json(open(theirs).read()), [x])[0]
    _held(got[got.files[0]], want, "cli")
    cli_main(["run", path, "--device", "cpu", "--input", xin])
    assert "transpose_4: float32[1, 5, 16, 16]" in capsys.readouterr().out
    cli_main(["info", _path("caffe_route")])
    assert "nn.lrn" in capsys.readouterr().out


def test_cli_names_item_12_for_the_other_frontends(tmp_path, monkeypatch):
    """Item 12's frontends are ported (tests/test_torch_port_tf.py): a .pb
    is read by the in-tree codec (a missing one is a missing file), and a
    .keras / .h5 file needs TensorFlow, which the CLI names where it is
    missing."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "tensorflow" else real(name, *a))
    for suffix in (".keras", ".h5"):  # .pt is ported (test_torch_port_torch_fx.py)
        with pytest.raises(SystemExit, match="TensorFlow"):
            cli_main(["run", str(tmp_path / f"m{suffix}"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        cli_main(["run", str(tmp_path / "m.pb"), "--device", "cpu"])


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchExecutor(from_onnx(_path("mxnet_lenet")))
