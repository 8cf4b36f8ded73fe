"""The port's TFLite frontend on the CPU, against the JAX package's: the
in-tree flatbuffer reader, `from_tflite` in both `integer_lut` modes on the
three exporter-made fixtures (int8 small CNN, int8 MobileNetV2 96^2 with
per-channel weights and nonzero zero points on every conv, the 16x8 small
CNN on the W8A16 path), fusion, the fused and unfused executors, the trace
and the CLI.

Fixtures (tests/fixtures/): the models come from TensorFlow's
TFLiteConverter and the goldens (*_io.npz, mobilenet_v2_int8_batch.npz) from
the TFLite interpreter, which rounds its requantize in two steps: an int8
output may differ by one quantum (tests/test_frontend_tflite.py).  Within
the two packages integers are compared with ==, float outputs with
allclose(rtol=1e-5, atol=1e-6)."""

import io
import os

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend import tflite_fb as j_fb
from tachikoma_tpu.frontend.tflite import from_tflite as j_from_tflite
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import run_graph
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.frontend import from_tflite
from tachikoma_tpu_torch.frontend import tflite_fb as fb
from tachikoma_tpu_torch.ops.kernels import conv, matmul_int8
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
NAMES = ("small_cnn_int8", "small_cnn_16x8", "mobilenet_v2_int8")
RTOL, ATOL = 1e-5, 1e-6


def _path(name: str) -> str:
    return os.path.join(FIX, f"{name}.tflite")


def _io(name: str):
    return np.load(os.path.join(FIX, f"{name}_io.npz"))


def _held(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# the flatbuffer reader
# ---------------------------------------------------------------------------

def _tables(mod, buf):
    root = mod.root(memoryview(buf))
    return mod.Model(root.buf, root.pos)


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_what_the_references_reads(name):
    buf = open(_path(name), "rb").read()
    assert fb.file_identifier(buf) == j_fb.file_identifier(buf) == "TFL3"
    ours, theirs = _tables(fb, buf), _tables(j_fb, buf)
    assert ours.version() == theirs.version()
    assert [c.builtin_code() for c in ours.operator_codes()] == \
        [c.builtin_code() for c in theirs.operator_codes()]
    assert [b.data() for b in ours.buffers()] == [b.data() for b in theirs.buffers()]
    (sg,), (tsg,) = ours.subgraphs(), theirs.subgraphs()
    np.testing.assert_array_equal(sg.inputs(), tsg.inputs())
    np.testing.assert_array_equal(sg.outputs(), tsg.outputs())
    assert len(sg.tensors()) == len(tsg.tensors())
    for t, tt in zip(sg.tensors(), tsg.tensors()):
        assert (t.name(), t.type(), t.buffer()) == (tt.name(), tt.type(), tt.buffer())
        np.testing.assert_array_equal(t.shape(), tt.shape())
        q, tq = t.quantization(), tt.quantization()
        assert (q is None) == (tq is None)
        if q is not None:
            np.testing.assert_array_equal(q.scale(), tq.scale())
            np.testing.assert_array_equal(q.zero_point(), tq.zero_point())
            assert q.quantized_dimension() == tq.quantized_dimension()
    assert len(sg.operators()) == len(tsg.operators())
    for op, top in zip(sg.operators(), tsg.operators()):
        assert (op.opcode_index(), op.builtin_options_type()) == \
            (top.opcode_index(), top.builtin_options_type())
        np.testing.assert_array_equal(op.inputs(), top.inputs())
        np.testing.assert_array_equal(op.outputs(), top.outputs())
    assert fb.NP_DTYPE == j_fb.NP_DTYPE


def test_reader_refuses_what_is_not_a_tflite_file():
    with pytest.raises(ValueError, match="TFL3"):
        from_tflite(b"\x08\x00\x00\x00NOPE" + bytes(16))


# ---------------------------------------------------------------------------
# the importer: the JAX package's graph, its outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integer_lut", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_imported_and_fused_graphs_equal_the_references(name, integer_lut):
    g = from_tflite(_path(name), integer_lut=integer_lut)
    jg = j_from_tflite(_path(name), integer_lut=integer_lut)
    assert g.to_json() == jg.to_json()
    assert fuse_qnn(g).to_json() == j_fuse_qnn(jg).to_json()
    # a path, bytes and a buffer give the same graph
    buf = open(_path(name), "rb").read()
    assert from_tflite(buf, integer_lut=integer_lut).to_json() == g.to_json()
    assert from_tflite(memoryview(buf), integer_lut=integer_lut).to_json() == g.to_json()


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("integer_lut", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_every_node_equals_the_reference_oracle(name, integer_lut, fuse):
    g = from_tflite(_path(name), integer_lut=integer_lut)
    jg = j_from_tflite(_path(name), integer_lut=integer_lut)
    if fuse:
        g, jg = fuse_qnn(g), j_fuse_qnn(jg)
    x = _io(name)["x"]
    names = computational_nodes(g)
    seen = {}
    j_run_graph(jg, x, intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    own = TorchExecutor(g, capture=names, device="cpu").run(x)
    for nm, got in zip(names, own):
        _held(got, seen[nm], f"{name} {nm} ({g[nm].op})")
    for got, want in zip(run_graph(g, x), j_run_graph(jg, x)):
        _held(got, want, name)


def test_small_models_equal_jax_executor():
    """Every node of the int8 model == JaxExecutor's; the 16x8 model's output
    within tests/test_frontend_tflite.py's rtol 1e-6, atol 1e-7 of it (XLA
    quantizes the float input through another float32 division: an int16
    may differ by one there, which the oracle and the port do not)."""
    g, jg = from_tflite(_path("small_cnn_int8")), j_from_tflite(_path("small_cnn_int8"))
    x = _io("small_cnn_int8")["x"]
    names = computational_nodes(g)
    for nm, got, want in zip(names, TorchExecutor(g, capture=names, device="cpu").run(x),
                             JaxExecutor(jg, capture=names, fuse=False).run(x)):
        _held(got, want, nm)
    g, jg = from_tflite(_path("small_cnn_16x8")), j_from_tflite(_path("small_cnn_16x8"))
    x = _io("small_cnn_16x8")["x"]
    got = TorchExecutor(g, device="cpu", fuse=True).run(x)[0]
    np.testing.assert_allclose(got, JaxExecutor(jg, fuse=False).run(x)[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["small_cnn_int8", "mobilenet_v2_int8"])
def test_faithful_import_is_within_one_quantum_of_the_interpreter(name):
    io_ = _io(name)
    got = TorchExecutor(from_tflite(_path(name), integer_lut=False), device="cpu",
                        fuse=True).run(io_["x"])[0]
    want = io_["y"]
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.9


@pytest.mark.parametrize("name", ["small_cnn_int8", "mobilenet_v2_int8"])
def test_integer_lut_import_classifies_as_the_interpreter(name):
    io_ = _io(name)
    got = TorchExecutor(from_tflite(_path(name)), device="cpu", fuse=True).run(io_["x"])[0]
    assert np.argmax(got) == np.argmax(io_["y"])
    assert np.abs(got.astype(np.int32) - io_["y"].astype(np.int32)).max() <= 32


def test_16x8_fixture_is_within_one_int16_quantum_of_the_interpreter():
    g = from_tflite(_path("small_cnn_16x8"))
    dts = {n.dtype for n in g.nodes if n.dtype}
    assert {"int16", "int64"} <= dts
    convs = [n for n in g.nodes if n.op == "qnn.conv2d"]
    assert all(n.attrs["out_dtype"] == "int64" for n in convs)
    assert any(n.attrs.get("groups", 1) == 8 for n in convs)
    io_ = _io("small_cnn_16x8")
    got = TorchExecutor(g, device="cpu", fuse=True).run(io_["x"])[0]
    assert np.abs(got - io_["y"]).max() <= 1.0 / (1 << 15) + 1e-9


def _recorder(calls: list, name: str, fn, what):
    """fn, recording (name, what(args, kwargs)) of each call in `calls`."""
    def rec(*a, **k):
        calls.append((name, what(a, k)))
        return fn(*a, **k)

    return rec


@pytest.fixture(scope="module")
def mbv2_b16():
    """The exporter's MobileNetV2 imported at b16 for the interpreter's 16
    batch images (the port's and the JAX package's importer)."""
    batch = np.load(os.path.join(FIX, "mobilenet_v2_int8_batch.npz"))
    name = from_tflite(_path("mobilenet_v2_int8")).inputs[0].name
    shapes = {name: batch["x"].shape}
    graphs = {lut: (from_tflite(_path("mobilenet_v2_int8"), shapes, integer_lut=lut),
                    j_from_tflite(_path("mobilenet_v2_int8"), shapes, integer_lut=lut))
              for lut in (False, True)}
    return graphs, batch["x"], batch["y"]


@pytest.mark.parametrize("integer_lut", [False, True])
def test_b16_graph_equals_the_references_and_fuses_to_k1_k2_k5(mbv2_b16, integer_lut):
    (g, jg), xs, _ = mbv2_b16[0][integer_lut], *mbv2_b16[1:]
    assert g.to_json() == jg.to_json()
    assert g.inputs[0].shape == xs.shape
    fused = fuse_qnn(g)
    assert fused.to_json() == j_fuse_qnn(jg).to_json()
    heads = [n for n in fused.nodes if n.op in ("tk.conv2d_rq", "tk.dense_rq")]
    assert len(heads) == 53 and not any(n.op == "qnn.conv2d" for n in fused.nodes)
    # every conv and the dense has a nonzero input zero point; 25 at -128
    izps = [n.attrs["input_zero_point"] for n in heads]
    assert all(izps) and izps.count(-128) == 25
    dw = [n for n in heads if n.attrs.get("groups", 1) > 1]
    assert len(dw) == 17 and sum(n.attrs["input_zero_point"] == -128 for n in dw) == 14
    # TFLite's stride-2 SAME: only the bottom and right are padded
    s2 = [n for n in heads if tuple(n.attrs.get("strides", (1, 1))) == (2, 2)]
    assert [tuple(n.attrs["padding"]) for n in s2] == [(0, 0, 1, 1)] * 5
    assert s2[0].attrs["input_zero_point"] == -4 and s2[0].attrs.get("groups", 1) == 1


def test_b16_batch_within_one_quantum_of_the_interpreter_top1_16_of_16(mbv2_b16, monkeypatch):
    """The fused forward runs K1 (the 1x1 convs at M = 16 * H * W, the dense
    at M = 16), K2 (the stem) and K5 (the depthwise convs) through their
    plain versions, == the unfused graph and the JAX package's oracle."""
    (g, jg), xs, ys = mbv2_b16[0][False], *mbv2_b16[1:]
    calls = []
    for mod, attr in ((matmul_int8, "qgemm_rq"), (conv, "qconv_rq"), (conv, "qdwconv_rq")):
        monkeypatch.setattr(mod, attr, _recorder(calls, attr, getattr(mod, attr),
                                                 lambda a, k: a[0].shape[0]))
    fused = TorchExecutor(g, device="cpu", fuse=True).run(xs)[0]
    names = [n for n, _ in calls]
    assert names.count("qgemm_rq") == 35 and names.count("qconv_rq") == 1
    assert names.count("qdwconv_rq") == 17
    assert ("qgemm_rq", 16) in calls  # the dense at M = 16
    unfused = TorchExecutor(g, device="cpu").run(xs)[0]
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_array_equal(fused, j_run_graph(jg, xs)[0])
    diff = np.abs(fused.astype(np.int32) - ys.astype(np.int32))
    assert diff.max() <= 1
    assert (fused.argmax(-1) == ys.argmax(-1)).sum() == 16
    lut = TorchExecutor(mbv2_b16[0][True][0], device="cpu", fuse=True).run(xs)[0]
    assert (lut.argmax(-1) == ys.argmax(-1)).sum() == 16


# ---------------------------------------------------------------------------
# the trace and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_imported_graph_traces_as_the_references_numpy_trace(name):
    g, jg = from_tflite(_path(name)), j_from_tflite(_path(name))
    x = _io(name)["x"]
    blob = emit_trace(g, x, backend="torch", device="cpu")
    want = j_emit_trace(jg, x, backend="numpy")
    got_recs = list(fmt.TraceReader(io.BytesIO(blob)))
    want_recs = list(j_format.TraceReader(io.BytesIO(want)))
    assert len(got_recs) == len(want_recs)
    for a, b in zip(got_recs, want_recs):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        if all(t.to_array().dtype.kind in "iu" for t in a.tensors):
            assert a.encode() == b.encode(), a.name
            continue
        # a float tensor (the 16x8 softmax island): integers ==, floats allclose
        for ta, tb in zip(a.tensors, b.tensors):
            assert ta.role == tb.role
            _held(ta.to_array(), tb.to_array(), a.name)
    if name != "small_cnn_16x8":
        assert blob == want
    res = verify_trace(blob, g)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got_recs)


def test_unfused_trace_path_runs_k4_and_k5_raw_with_zero_points(monkeypatch):
    """The b1 unfused MobileNetV2 runs its 52 convs on K4 / K5's raw modes
    (their plain versions here) with the zero points the exporter chose."""
    g = from_tflite(_path("mobilenet_v2_int8"))
    izps = []
    for mod, attr in ((conv, "qconv_raw"), (conv, "qdwconv_raw"), (matmul_int8, "qgemm_raw")):
        monkeypatch.setattr(mod, attr, _recorder(izps, attr, getattr(mod, attr),
                                                 lambda a, k: k.get("izp")))
    x = _io("mobilenet_v2_int8")["x"]
    out = TorchExecutor(g, device="cpu").run(x)[0]
    np.testing.assert_array_equal(out, run_graph(g, x)[0])
    kinds = [n for n, _ in izps]
    assert kinds.count("qdwconv_raw") == 17 and kinds.count("qconv_raw") == 1
    assert kinds.count("qgemm_raw") == 35
    assert sum(z == -128 for n, z in izps if n == "qdwconv_raw") == 14


def test_cli_runs_traces_and_verifies_a_tflite_model(tmp_path, capsys):
    path = _path("small_cnn_16x8")
    xin = str(tmp_path / "x.npy")
    np.save(xin, _io("small_cnn_16x8")["x"])
    out, trace = str(tmp_path / "y.npz"), str(tmp_path / "t.bin")
    cli_main(["run", path, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    want = j_run_graph(j_from_tflite(path), _io("small_cnn_16x8")["x"])[0]
    np.testing.assert_allclose(got[got.files[0]], want, rtol=RTOL, atol=ATOL)
    cli_main(["run", _path("mobilenet_v2_int8"), "--device", "cpu"])
    assert "qnn_softmax: int8[1, 10]" in capsys.readouterr().out
    cli_main(["trace", path, "-o", trace, "--device", "cpu", "--input", xin])
    with pytest.raises(SystemExit) as e:
        cli_main(["verify", trace])
    assert e.value.code == 0
    # .onnx and .pt are ported (test_torch_port_onnx.py, test_torch_port_torch_fx.py)
    for suffix in (".keras", ".h5", ".pb"):
        with pytest.raises(SystemExit, match="Queue 1 item 12"):
            cli_main(["run", str(tmp_path / f"m{suffix}"), "--device", "cpu"])


def test_entry_points_refuse_a_missing_card():
    """The executor defaults to the card and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchExecutor(from_tflite(_path("small_cnn_int8")))
