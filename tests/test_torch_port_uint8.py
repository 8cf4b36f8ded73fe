"""Legacy uint8 TFLite models on the CPU, against the JAX package: uint8
data, uint8 weights with a nonzero zero point, uint8 outputs, and K5 with
dilation.

  * K1 / K4's GEMM (through `tk.dense_rq` / `qnn.dense`), K2 / K4's conv mode
    (`tk.conv2d_rq` / `qnn.conv2d`: the CIN-3 stem at padding (0, 0, 1, 1),
    a dilated 3x3, a 1x1, M off the tile) and K5 (depthwise at dilation 2
    and 4, stride 1 and 2): the port's op impls, on the kernels' plain
    versions, == the JAX package's numpy impls;
  * the kernels' arithmetic (`_rowsum_model`: x @ w less kzp[n] times the
    staged rows' sums, split over K, the bias folded with izp and kzp) ==
    the oracle, for a GEMM and a conv's izp-padded rows;
  * the exporter-made fixture `tests/fixtures/small_cnn_uint8.tflite`
    (tools/make_uint8_tflite_fixture.py, TF's legacy converter) and the
    uint8 MobileNetV2 of `models/tflite_mobilenet.py` at b1 96^2, full
    widths: the same graph JSON, every integer node of the fused and the
    unfused graph == the JAX oracle, the trace's integer records byte-equal
    to the JAX package's (the softmax island's float tensors, torch's
    float32 `exp` against numpy's, within rtol 1e-5, atol 1e-6) and
    verified; the fixture's activations within one quantum of TFLite's
    interpreter, op by op; the written file in TFLite's interpreter where
    TensorFlow imports;
  * what the other kernels refuse, by ROADMAP item.

Integers are compared with ==, float nodes (the softmax island) within
rtol 1e-5, atol 1e-6."""

import io
import os

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import tachikoma_tpu.runtime.fuse  # noqa: F401  (registers tk.conv2d_rq, tk.dense_rq)
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend.tflite import from_tflite as j_from_tflite
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.runtime.executor import computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace import format as j_fmt
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch.frontend import from_tflite
from tachikoma_tpu_torch.frontend import tflite_fb as fb
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.models.tflite_mobilenet import mobilenet_v2_input, mobilenet_v2_tflite
from tachikoma_tpu_torch.ops.kernels import conv, conv_direct, conv_layouts, matmul_int8
from tachikoma_tpu_torch.ops.kernels.requantize import channel_vector, plan_requantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

RTOL, ATOL = 1e-5, 1e-6
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE = os.path.join(FIX, "small_cnn_uint8.tflite")
SIDE = 96
# the fixture's activations as TFLite names them -> the importer's node
FIXTURE_NODES = {"Relu6;add;Conv2D;Const_11": "clip", "Relu6_1;add_1;depthwise;Const_31": "clip_1",
                 "add_2;Conv2D_1;Const_51": "qnn_requantize_2", "add_3": "qnn_add",
                 "AvgPool2D": "cast_1", "Reshape;FakeQuantWithMinMaxVars_8": "reshape",
                 "MatMul;add_4": "qnn_requantize_3"}
SOFTMAX_ISLAND = ("qnn_dequantize", "nn_softmax", "qnn_quantize")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path in one thread: the suite runs a worker a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _held(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _same_trace(blob: bytes, want: bytes, graph) -> int:
    """The port's trace against the JAX package's, record by record: a record
    of integer tensors byte-equal, a float tensor (the softmax island's)
    within rtol / atol, its integer tensors ==; then verified.  Returns the
    records."""
    got = list(fmt.TraceReader(io.BytesIO(blob)))
    ref = list(j_fmt.TraceReader(io.BytesIO(want)))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        if all(t.to_array().dtype.kind in "iu" for t in a.tensors):
            assert a.encode() == b.encode(), a.name
            continue
        for ta, tb in zip(a.tensors, b.tensors):
            assert ta.role == tb.role
            _held(ta.to_array(), tb.to_array(), a.name)
    res = verify_trace(blob, graph)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got)
    return len(got)


def _data(rng, shape, dtype):
    lo, hi = (0, 256) if dtype == "uint8" else (-128, 128)
    return rng.integers(lo, hi, shape).astype(dtype)


def _kzp(rng, n, kind, wdtype):
    """A weight zero point in the weights' own range: one for every column
    or one a column."""
    lo, hi = (0, 256) if wdtype == "uint8" else (-128, 128)
    return int(rng.integers(lo, hi)) if kind == "scalar" else rng.integers(lo, hi, n).tolist()


def _both(op, attrs, *args):
    """The port's torch impl and the JAX package's numpy impl of one node."""
    names = tuple(f"i{i}" for i in range(len(args)))
    got = get_op(op).torch_impl(*(torch.from_numpy(a) for a in args),
                                node=Node("n", op, names, attrs))
    want = j_get_op(op).np_impl(*args, node=JNode("n", op, names, attrs))
    return got.numpy(), want


def _epilogue(rng, n, out_dtype):
    m, s = plan_requantize(0.002 * (0.5 + rng.random(n)), 1.0)
    lo, hi = (0, 255) if out_dtype == "uint8" else (-128, 127)
    return dict(multiplier=m.tolist(), shift=s.tolist(), output_zero_point=lo + 90,
                rq_input_zero_point=3, out_dtype=out_dtype, a_min=lo + 1, a_max=hi - 2,
                rounding="TONEAREST", has_bias=True)


# ---------------------------------------------------------------------------
# the kernels' plain versions through the op impls
# ---------------------------------------------------------------------------

# (M, K, N), data, izp, weights, kzp kind, fused output
GEMM_CASES = [((37, 70, 13), "uint8", 128, "uint8", "scalar", "uint8"),
              ((37, 70, 13), "int8", 200, "int8", "channel", "int8"),
              ((5, 1280, 17), "uint8", 0, "uint8", "channel", "uint8"),
              ((130, 24, 144), "uint8", 255, "uint8", "scalar", "int8")]


@pytest.mark.parametrize("case", GEMM_CASES)
def test_k1_k4_gemm_equal_the_references_dense(case):
    (m, k, n), xd, izp, wd, kind, od = case
    rng = np.random.default_rng(m + k)
    x, w = _data(rng, (m, k), xd), _data(rng, (k, n), wd)
    b = rng.integers(-30000, 30000, n).astype(np.int32)
    attrs = dict(input_zero_point=izp, kernel_zero_point=_kzp(rng, n, kind, wd))
    got, want = _both("qnn.dense", dict(attrs, out_dtype="int32"), x, w)
    np.testing.assert_array_equal(got, want)
    got, want = _both("tk.dense_rq", dict(attrs, **_epilogue(rng, n, od)), x, w, b)
    assert got.dtype == np.dtype(od)
    np.testing.assert_array_equal(got, want)


# x shape, w shape, strides, padding, dilation, groups, data, izp, weights,
# kzp kind, output
CONV_CASES = [
    ((2, 17, 17, 3), (3, 3, 3, 8), 2, (0, 0, 1, 1), 1, 1, "uint8", 128, "uint8", "scalar",
     "uint8"),
    ((1, 12, 10, 16), (3, 3, 16, 24), 1, (2, 2, 2, 2), 2, 1, "uint8", 7, "uint8", "channel",
     "uint8"),
    ((2, 7, 7, 24), (1, 1, 24, 40), 1, (0, 0, 0, 0), 1, 1, "uint8", 255, "uint8", "scalar",
     "uint8"),
    ((3, 11, 9, 20), (5, 5, 20, 12), 2, (2, 1, 2, 1), 1, 1, "int8", -5, "int8", "channel",
     "int8"),
    *(((1, 13, 11, 24), (3, 3, 1, 24), s, (d,) * 4, d, 24, "uint8", 140, "uint8", "channel",
       "uint8") for d in (2, 4) for s in (1, 2)),
    ((2, 9, 9, 8), (3, 3, 1, 8), 1, (1, 1, 1, 1), 1, 8, "int8", -128, "int8", "scalar", "int8"),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_k2_k4_k5_convs_equal_the_references(case):
    xs, ws, s, pad, d, g, xd, izp, wd, kind, od = case
    rng = np.random.default_rng(sum(xs) + sum(ws))
    x, w = _data(rng, xs, xd), _data(rng, ws, wd)
    cout = ws[3]
    b = rng.integers(-30000, 30000, cout).astype(np.int32)
    attrs = dict(strides=(s, s), padding=pad, dilation=(d, d), groups=g, input_zero_point=izp,
                 kernel_zero_point=_kzp(rng, cout, kind, wd))
    got, want = _both("qnn.conv2d", dict(attrs, out_dtype="int32"), x, w)
    np.testing.assert_array_equal(got, want)
    got, want = _both("tk.conv2d_rq", dict(attrs, **_epilogue(rng, cout, od)), x, w, b)
    assert got.dtype == np.dtype(od)
    np.testing.assert_array_equal(got, want)


def _rowsum_model(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, kzp: torch.Tensor,
                  izp: int = 0, ks: int = 1) -> torch.Tensor:
    """The int32 sums K1 / K4 compute with a weight zero point, the way the
    kernels do (csrc/igemm_hopper.cuh): x (M, K) int8 or uint8 as staged
    (an image's rows padded with izp: the conv's A), w (K, N) int8, kzp
    int32 (N,); split into `ks` runs of whole 64-byte steps of K, each run
    x @ w less kzp[n] times the rows' sums over its steps, the runs added
    and the bias folded with izp and kzp (`fold_input_zero_point`) added,
    all in int32 wraparound; == (x - izp) @ (w - kzp) + bias."""
    mm = matmul_int8
    k = x.shape[1]
    span = -(-(-(-k // mm.KSTEP)) // ks) * mm.KSTEP
    acc = mm.fold_input_zero_point(bias, w, izp, kzp).to(torch.int64).expand(x.shape[0], -1)
    for k0 in range(0, k, span):
        xs, ws = x[:, k0:k0 + span], w[k0:k0 + span]
        part = mm.exact_int_matmul(xs, ws).to(torch.int64) - \
            kzp.to(torch.int64) * xs.to(torch.int64).sum(1, keepdim=True)
        acc = (acc + part).to(torch.int32).to(torch.int64)
    return acc.to(torch.int32)


def test_the_kernels_row_sums_equal_the_oracle():
    """_rowsum_model (the kernels' way: the bias folded with izp and kzp, x @ w
    less kzp[n] times the rows' sums, a split of K its own steps' part, in
    int32 wraparound) == (x - izp) @ (w - kzp) + bias: a GEMM at 1 to 3
    splits and a conv's rows padded with izp (K2's A); uint8 weights as
    int8 w - 128 with kzp - 128 (`legacy_weights`)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_data(rng, (33, 200), "uint8"))
    wu = torch.from_numpy(_data(rng, (200, 24), "uint8"))
    kz = rng.integers(0, 256, 24)
    b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 24, dtype=np.int64).astype(np.int32))
    w8, kzp = matmul_int8.legacy_weights(wu, kz, "cpu")
    assert w8.dtype == torch.int8 and torch.equal(w8.to(torch.int32), wu.to(torch.int32) - 128)
    want = matmul_int8.qgemm_raw_plain(x.to(torch.int32) - 77, wu.to(torch.int32),
                                       b, kzp=channel_vector(kz, 24, "cpu"))
    for ks in (1, 2, 3):
        got = _rowsum_model(x, w8, b, kzp, izp=77, ks=ks)
        assert torch.equal(got, want), ks
    # a 3x3 conv's implicit GEMM: rows of the image padded with izp
    xi = torch.from_numpy(_data(rng, (2, 6, 5, 16), "uint8"))
    wc = torch.from_numpy(_data(rng, (3, 3, 16, 8), "uint8"))
    wc8, kzc = matmul_int8.legacy_weights(wc, 150, "cpu")
    bc = torch.from_numpy(rng.integers(-5000, 5000, 8).astype(np.int32))
    cols = torch.nn.functional.pad(xi, (0, 0, 1, 1, 1, 1), value=201).unfold(1, 3, 1).unfold(
        2, 3, 1).permute(0, 1, 2, 4, 5, 3).reshape(2 * 6 * 5, 9 * 16)
    got = _rowsum_model(cols, wc8.reshape(9 * 16, 8), bc, kzc, izp=201, ks=2)
    want = conv.qconv_raw_plain(xi, wc8, bc, padding=(1, 1, 1, 1), izp=201, kzp=kzc)
    assert torch.equal(got.reshape(2, 6, 5, 8), want)


# ---------------------------------------------------------------------------
# the exporter-made fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_graphs():
    io_ = np.load(os.path.join(FIX, "small_cnn_uint8_io.npz"))
    g, jg = from_tflite(FIXTURE, integer_lut=False), j_from_tflite(FIXTURE, integer_lut=False)
    return g, jg, io_


def _every_node(g, jg, x):
    names = computational_nodes(g)
    seen = {}
    j_run_graph(jg, x, intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    own = TorchExecutor(g, capture=names, device="cpu").run(x)
    n_int = 0
    for nm, got in zip(names, own):
        _held(got, seen[nm], f"{nm} ({g[nm].op})")
        n_int += np.asarray(got).dtype.kind in "iu"
    return seen, n_int


@pytest.mark.parametrize("fuse", [False, True])
def test_fixture_every_node_equals_the_reference(fixture_graphs, fuse):
    g, jg, io_ = fixture_graphs
    assert g.to_json() == jg.to_json()
    if fuse:
        g, jg = fuse_qnn(g), j_fuse_qnn(jg)
        assert g.to_json() == jg.to_json()
        heads = [n for n in g.nodes if n.op in ("tk.conv2d_rq", "tk.dense_rq")]
        assert len(heads) == 4 and all(n.attrs["out_dtype"] == "uint8" for n in heads)
        assert all(np.asarray(n.attrs["kernel_zero_point"]).all() for n in heads)
        assert [tuple(n.attrs.get("dilation", (1, 1))) for n in heads] == [
            (1, 1), (2, 2), (1, 1), (1, 1)]
        # the reference chains no conv with a weight zero point
        assert not any(n.op == "tk.conv2d_chain" for n in g.nodes)
    _, n_int = _every_node(g, jg, io_["x"])
    assert n_int > 0


def test_fixture_is_within_one_quantum_of_the_interpreter_op_by_op(fixture_graphs):
    """TFLite rounds its uint8 requantize and ADD in two steps, the oracle in
    one (tests/test_frontend_tflite.py): each activation of the interpreter
    is within one quantum of the oracle's node, and the softmax island
    (dequantize, float softmax, quantize) run on the interpreter's own
    logits is within one quantum of its uint8 probabilities."""
    g, jg, io_ = fixture_graphs
    seen = {}
    j_run_graph(jg, io_["x"], intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    for tname, node in FIXTURE_NODES.items():
        want = io_[f"t_{tname}"]
        got = np.asarray(seen[node]).reshape(want.shape)
        assert got.dtype == want.dtype == np.uint8, tname
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, tname
    v = io_["t_MatMul;add_4"]
    for name in SOFTMAX_ISLAND:
        v = j_get_op(jg[name].op).np_impl(v, node=jg[name])
    diff = np.abs(v.astype(np.int32) - io_["y"].astype(np.int32))
    assert v.dtype == np.uint8 and diff.max() <= 1
    assert np.argmax(seen["qnn_quantize"]) == np.argmax(io_["y"])


def test_fixture_traces_byte_equal_and_verify(fixture_graphs):
    g, jg, io_ = fixture_graphs
    blob = emit_trace(g, io_["x"], backend="torch", device="cpu")
    assert _same_trace(blob, j_emit_trace(jg, io_["x"], backend="numpy"), g) == 22


# ---------------------------------------------------------------------------
# the writer's uint8 MobileNetV2, b1 96^2, full widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mbv2():
    blob = mobilenet_v2_tflite(1, SIDE, seed=0)
    return blob, mobilenet_v2_input(1, SIDE, seed=0), from_tflite(blob), j_from_tflite(blob)


def test_writer_lays_out_mobilenet_v2_as_tf1_does(mbv2):
    blob, x, g, jg = mbv2
    assert fb.file_identifier(blob) == "TFL3" and x.dtype == np.uint8
    m = fb.root(memoryview(blob))
    model = fb.Model(m.buf, m.pos)
    (sg,) = model.subgraphs()
    codes = [c.builtin_code() for c in model.operator_codes()]
    ops = [codes[op.opcode_index()] for op in sg.operators()]
    O = fb.Op
    assert [ops.count(c) for c in (O.CONV_2D, O.DEPTHWISE_CONV_2D, O.ADD, O.AVERAGE_POOL_2D,
                                   O.RESHAPE, O.SOFTMAX)] == [36, 17, 10, 1, 1, 1]
    tensors = sg.tensors()
    weights = [tensors[int(op.inputs()[1])] for op, c in zip(sg.operators(), ops)
               if c in (O.CONV_2D, O.DEPTHWISE_CONV_2D)]
    assert all(t.type() == fb.TType.UINT8 and t.quantization().zero_point()[0] != 0
               for t in weights)
    (inp,) = sg.inputs()
    q = tensors[int(inp)].quantization()
    assert (q.scale()[0], q.zero_point()[0]) == (1 / 128, 128)
    q = tensors[int(sg.outputs()[0])].quantization()
    assert (q.scale()[0], q.zero_point()[0]) == (1 / 256, 0)
    assert g.to_json() == jg.to_json()
    fused = fuse_qnn(g)
    assert fused.to_json() == j_fuse_qnn(jg).to_json()
    heads = [n for n in fused.nodes if n.op == "tk.conv2d_rq"]
    assert len(heads) == 53 and tuple(heads[0].attrs["padding"]) == (0, 0, 1, 1)
    assert all(n.attrs["out_dtype"] == "uint8" and n.attrs["kernel_zero_point"] for n in heads)
    assert sum(int(n.attrs.get("groups", 1)) > 1 for n in heads) == 17
    assert mobilenet_v2_tflite(1, SIDE, seed=0) == blob


@pytest.mark.parametrize("fuse", [False, True])
def test_mobilenet_every_node_equals_the_reference(mbv2, fuse):
    _, x, g, jg = mbv2
    if fuse:
        g, jg = fuse_qnn(g), j_fuse_qnn(jg)
    _, n_int = _every_node(g, jg, x)
    assert n_int >= (68 if fuse else 209)


def test_mobilenet_traces_byte_equal_and_verify(mbv2):
    _, x, g, jg = mbv2
    blob = emit_trace(g, x, backend="torch", device="cpu")
    assert _same_trace(blob, j_emit_trace(jg, x, backend="numpy"), g) == 211


def test_written_model_runs_in_tflites_interpreter(mbv2):
    """Where TensorFlow imports: TFLite's interpreter runs the written bytes,
    and the JAX oracle's uint8 probabilities are within one quantum of it."""
    tf = pytest.importorskip("tensorflow")
    blob, x, _, _ = mbv2
    it = tf.lite.Interpreter(model_content=blob)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    want = it.get_tensor(it.get_output_details()[0]["index"])
    got = j_run_graph(j_from_tflite(blob, integer_lut=False), x)[0]
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (1, 1001)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert np.argmax(got) == np.argmax(want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_kernels_without_legacy_operands_refuse_them_by_item():
    rng = np.random.default_rng(3)
    xu = torch.from_numpy(_data(rng, (1, 8, 8, 16), "uint8"))
    w = torch.from_numpy(_data(rng, (3, 3, 16, 16), "int8"))
    b = torch.zeros(16, dtype=torch.int32)
    m, s = (channel_vector(v, 16, "cpu") for v in plan_requantize(0.001, 1.0))
    item = "ROADMAP Queue 1 item 2"
    res = dict(lhs_scale=0.05, rhs_scale=0.05, output_scale=0.1)
    for call in (lambda: conv.qconv_rq_res(xu, w, b, m, s, xu, res, padding=(1,) * 4),
                 lambda: conv_layouts.qconv_rq_t(xu, w, b, m, s, padding=(1,) * 4),
                 lambda: conv_direct.qconv_direct(xu, w, b, m, s, padding=(1,) * 4),
                 lambda: conv_direct.qdwconv_direct(xu, w[:, :, :1], b, m, s),
                 lambda: matmul_int8.qbmm_rq(xu[0], xu[0], None, m[:8], s[:8]),
                 lambda: matmul_int8.qbmm_raw(xu[0], xu[0])):
        with pytest.raises(NotImplementedError, match=item):
            call()
    # a grouped conv other than depthwise with a weight zero point (K2 / K4
    # run it as a dense conv of a super-group, whose row sums span other
    # groups' channels)
    with pytest.raises(NotImplementedError, match=f"grouped conv with a weight zero point.*{item}"):
        conv.qconv2d_flat(xu, _data(rng, (3, 3, 8, 16), "uint8"), groups=2,
                          kernel_zero_point=3, padding=(1,) * 4)
    # W8A16's int64 products take no weight zero point and no uint8 data
    for x, attrs in ((xu, {}), (torch.from_numpy(_data(rng, (1, 8, 8, 16), "int8")).to(
            torch.int16), dict(kernel_zero_point=5))):
        node = Node("c", "qnn.conv2d", ("a", "b"), dict(attrs, out_dtype="int64"))
        with pytest.raises(NotImplementedError, match=item):
            get_op("qnn.conv2d").torch_impl(x, w, node=node)
    # the library route (torch._int_mm) takes int8 x int8 alone
    with pytest.raises(NotImplementedError, match=item):
        matmul_int8.qmatmul_int8(xu.reshape(64, 16), _data(rng, (16, 8), "uint8"),
                                 kernel_zero_point=9, blocks="xla")
    with pytest.raises(NotImplementedError, match="out_dtype int16"):
        conv.qconv2d_flat(xu, w, multiplier=0x40000000, shift=-3, out_dtype="int16")
    # the padding's fill is a value of the data's type
    with pytest.raises(NotImplementedError, match="input zero point 300 pads a torch.uint8"):
        conv.qconv_rq(xu, w, b, m, s, padding=(1,) * 4, izp=300)
    with pytest.raises(NotImplementedError, match="input zero point 200 pads a torch.int8"):
        conv.qconv2d_flat(xu.to(torch.int8), w[:, :, :1], groups=16, input_zero_point=200)
