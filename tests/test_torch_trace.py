"""The port's trace path on the CPU: the unfused int8 graph run by
TorchExecutor(fuse=False, device="cpu"), its K4 entries (raw int32
accumulator), the four op impls it needed, the TKTRACE1 format, the emitter,
the native writer and the CLI, each held against the JAX package on the same
numpy inputs.

Integers (and integer trace records, `OpRecord.encode()`) are compared with
==; float records (dequantize, softmax) with allclose(rtol=1e-5, atol=1e-6),
the JAX package's own rule for its traces (tests/test_trace.py).  The JAX
package's Pallas kernels run in interpret mode, as its own tests run them.
"""

import io
import struct

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu.cli import main as j_cli_main
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.ir.transforms import fuse_attention as j_fuse_attention
from tachikoma_tpu.models.transformer import bert as j_bert
from tachikoma_tpu.models.vision import resnet as j_resnet
from tachikoma_tpu.ops.pallas.conv_flat import qconv2d_flat as j_qconv2d_flat
from tachikoma_tpu.ops.pallas.matmul_int8 import qmatmul_int8 as j_qmatmul_int8
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu.trace.emitter import verify_trace as j_verify_trace
from tachikoma_tpu_torch import Node, run_graph
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.models.vision import resnet
from tachikoma_tpu_torch.ops.kernels import _lib
from tachikoma_tpu_torch.ops.kernels.conv import qconv2d_flat, qconv_raw
from tachikoma_tpu_torch.ops.kernels.matmul_int8 import qgemm_raw, qmatmul_int8
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace import native
from tachikoma_tpu_torch.trace import emitter
from tachikoma_tpu_torch.trace.emitter import TraceEmitter, emit_trace, verify_trace

RTOL, ATOL = 1e-5, 1e-6


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# (a) the TKTRACE1 format
# ---------------------------------------------------------------------------

def test_op_ids_dtypes_and_attrs_match_reference():
    assert fmt.OP_IDS == j_format.OP_IDS and fmt.DTYPE_CODES == j_format.DTYPE_CODES
    for name in [*j_format.OP_IDS, "tk.something_new", "qnn.unknown"]:
        assert fmt.op_id(name) == j_format.op_id(name)
    attrs = dict(strides=(2, 2), padding=[1, 1, 1, 1], scale=np.float32(0.0125),
                 zp=np.int64(-3), per_channel=np.arange(4, dtype=np.float64) / 7,
                 rounding="TONEAREST", nested={"b": 1, "a": (1.5, 2)})
    assert fmt.canonical_attrs(attrs) == j_format.canonical_attrs(attrs)


def _records(rng):
    """Records of every role, several dtypes, a scalar and a zero-element
    tensor."""
    recs = []
    for i, (dtype, shape) in enumerate([("int8", (2, 3, 4)), ("int32", (5,)), ("float32", ()),
                                        ("uint8", (0, 3)), ("int64", (3, 1)), ("bool", (4,))]):
        arr = rng.integers(-100, 100, shape).astype(dtype)
        tensors = [(fmt.ROLE_INPUT, arr), (fmt.ROLE_PARAM, arr[..., :1] if arr.ndim else arr),
                   (fmt.ROLE_OUTPUT, arr)]
        recs.append((i * 3 + 1, f"node{i}", ["qnn.conv2d", "clip", "tk.new_op"][i % 3],
                     dict(axis=-1, scale=0.5 * i, padding=(i, i)), tensors))
    return recs


def test_writer_and_reader_give_the_reference_bytes(rng):
    meta = {"model": "m.json", "batch": 1}
    blobs = []
    for mod in (fmt, j_format):
        buf = io.BytesIO()
        w = mod.TraceWriter(buf, bytes(range(32)), meta)
        recs = _records(np.random.default_rng(7))
        w.begin(len(recs))
        for nid, name, op, attrs, tensors in recs:
            w.write(mod.OpRecord(nid, name, op, attrs,
                                 [mod.TensorRecord.from_array(r, a) for r, a in tensors]))
        w.finish()
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    for reader in (fmt.TraceReader(io.BytesIO(blobs[0])), j_format.TraceReader(io.BytesIO(blobs[0]))):
        assert reader.meta == meta and reader.graph_hash == bytes(range(32))
        for rec, (nid, name, op, attrs, tensors) in zip(reader, _records(np.random.default_rng(7))):
            assert (rec.node_id, rec.name, rec.op_name) == (nid, name, op)
            for t, (role, arr) in zip(rec.tensors, tensors):
                assert t.role == role
                np.testing.assert_array_equal(t.to_array(), arr)
                assert t.to_array().dtype == arr.dtype and t.to_array().shape == arr.shape
    with pytest.raises(fmt.TraceCorrupt):
        fmt.TraceReader(io.BytesIO(blobs[0][:-40] + b"\x00" + blobs[0][-39:]))


# ---------------------------------------------------------------------------
# (b) K4's plain versions against the JAX package's raw Pallas kernels
# ---------------------------------------------------------------------------

# (M, K, N, with bias): M and K off the tile edges; the ragged N goes without a
# bias, which the JAX entry adds to its padded accumulator (ROADMAP Queue 3)
RAW_GEMMS = [(37, 80, 128, True), (37, 200, 13, False), (70, 300, 256, True)]


@pytest.mark.parametrize("m,k,n,with_bias", RAW_GEMMS)
def test_raw_gemm_plain_matches_reference(rng, m, k, n, with_bias):
    x, w = _i8(rng, (m, k)), _i8(rng, (k, n))
    bias = rng.integers(-40000, 40000, n).astype(np.int32) if with_bias else None
    want = np.asarray(j_qmatmul_int8(x, w, bias, blocks=(32, 128, 128)))
    got = qmatmul_int8(torch.from_numpy(x), w, bias).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    b = torch.zeros(n, dtype=torch.int32) if bias is None else torch.from_numpy(bias)
    np.testing.assert_array_equal(qgemm_raw(torch.from_numpy(x), torch.from_numpy(w), b), want)


RAW_CONVS = [
    # (x shape, k, stride, padding, cout, izp)
    ((2, 7, 7, 16), 1, (2, 2), (0, 0, 0, 0), 128, 2),     # 1x1 s2 downsample
    ((2, 9, 9, 16), 3, (1, 1), (1, 1, 1, 1), 24, 3),      # 3x3, padded
    ((2, 9, 9, 16), 3, (2, 2), (1, 1, 1, 1), 24, -4),     # strided 3x3
    ((1, 15, 15, 3), 7, (2, 2), (3, 3, 3, 3), 8, -5),     # 7x7 s2 stem, cin 3
    ((1, 6, 8, 8), 3, (1, 1), (0, 1, 0, 1), 8, -2),       # asymmetric padding
]


@pytest.mark.parametrize("case", RAW_CONVS)
def test_raw_conv_plain_matches_reference(rng, case):
    shape, k, strides, padding, cout, izp = case
    x, w = _i8(rng, shape), _i8(rng, (k, k, shape[3], cout))
    bias = rng.integers(-40000, 40000, cout).astype(np.int32)
    kw = dict(strides=strides, padding=padding, input_zero_point=izp)
    want = np.asarray(j_qconv2d_flat(x, w, bias, **kw))
    got = qconv2d_flat(torch.from_numpy(x), w, bias, **kw).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if k > 1:
        got = qconv_raw(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                        strides=strides, padding=padding, izp=izp)
        np.testing.assert_array_equal(got, want)


def test_raw_wrappers_count_no_launch_on_cpu_and_refuse_other_devices(rng):
    before = dict(_lib.LAUNCHES)
    x, w = torch.from_numpy(_i8(rng, (4, 32))), torch.from_numpy(_i8(rng, (32, 8)))
    qgemm_raw(x, w, torch.zeros(8, dtype=torch.int32))
    assert dict(_lib.LAUNCHES) == before
    meta = torch.empty((4, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        qgemm_raw(meta, w.to("meta"), torch.zeros(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        qconv_raw(meta.reshape(1, 2, 2, 32), w.reshape(1, 1, 32, 8).to("meta"),
                  torch.zeros(8, dtype=torch.int32, device="meta"))
    # a grouped conv runs on K4's conv mode and a dilated depthwise conv on
    # K5's raw mode (their plain versions here, no launch counted) == the
    # reference's grouped qnn.conv2d
    x8, w8 = _i8(rng, (1, 4, 4, 8)), _i8(rng, (3, 3, 4, 8))
    node = JNode("c", "qnn.conv2d", ("d", "w"), {"padding": (1, 1, 1, 1), "groups": 2,
                                                 "input_zero_point": 0, "kernel_zero_point": 0,
                                                 "out_dtype": "int32"})
    got = qconv2d_flat(torch.from_numpy(x8), w8, groups=2, padding=(1, 1, 1, 1))
    np.testing.assert_array_equal(got.numpy(), j_get_op("qnn.conv2d").np_impl(x8, w8, node=node))
    wd = _i8(rng, (3, 3, 1, 8))
    dnode = JNode("c", "qnn.conv2d", ("d", "w"), {"padding": (2, 2, 2, 2), "groups": 8,
                                                  "dilation": (2, 2), "input_zero_point": 0,
                                                  "kernel_zero_point": 0, "out_dtype": "int32"})
    got = qconv2d_flat(torch.from_numpy(x8), wd, groups=8, dilation=(2, 2), padding=(2, 2, 2, 2))
    np.testing.assert_array_equal(got.numpy(), j_get_op("qnn.conv2d").np_impl(x8, wd, node=dnode))
    assert dict(_lib.LAUNCHES) == before


# ---------------------------------------------------------------------------
# (c) the op impls of the unfused graph against jax_impl and np_impl
# ---------------------------------------------------------------------------

def _three_ways(op, attrs, *args):
    """(port torch impl, port oracle, JAX jax impl, JAX oracle) outputs."""
    node = Node("n", op, tuple(f"i{i}" for i in range(len(args))), attrs)
    jnode = JNode("n", op, tuple(f"i{i}" for i in range(len(args))), attrs)
    got = get_op(op).torch_impl(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args],
                                node=node).numpy()
    outs = [got, get_op(op).np_impl(*args, node=node),
            np.asarray(j_get_op(op).jax_impl(*args, node=jnode)),
            j_get_op(op).np_impl(*args, node=jnode)]
    for o in outs[1:]:
        assert o.dtype == got.dtype and o.shape == got.shape
    return outs


@pytest.mark.parametrize("attrs", [
    dict(strides=(2, 2), padding=(3, 3, 3, 3), input_zero_point=-5, kernel_zero_point=0,
         out_dtype="int32"),
    dict(strides=(1, 1), padding=(1, 1, 1, 1), input_zero_point=3, out_dtype="int32"),
    dict(strides=(2, 2), padding=(0, 0, 0, 0), input_zero_point=0),
])
def test_qnn_conv2d_torch_matches_jax_and_oracle(rng, attrs):
    k = 7 if attrs["padding"][0] == 3 else (3 if attrs["padding"][0] else 1)
    cin = 3 if k == 7 else 16
    x, w = _i8(rng, (1, 11, 11, cin)), _i8(rng, (k, k, cin, 12))
    got, *others = _three_ways("qnn.conv2d", attrs, x, w)
    for o in others:
        np.testing.assert_array_equal(got, o)


@pytest.mark.parametrize("izp", [0, 7])
def test_qnn_dense_torch_matches_jax_and_oracle(rng, izp):
    x, w = _i8(rng, (3, 70)), _i8(rng, (70, 10))
    got, *others = _three_ways("qnn.dense", dict(input_zero_point=izp, out_dtype="int32"), x, w)
    for o in others:
        np.testing.assert_array_equal(got, o)


@pytest.mark.parametrize("bad,match", [
    (dict(kernel_zero_point=2), "kernel_zero_point"),
])
def test_qnn_conv2d_and_dense_refuse_what_k4_cannot_run(rng, bad, match):
    """A weight zero point into int32 runs on K4 (legacy uint8 models) ==
    the JAX package's oracle; into int64 (W8A16's kernels) it is refused."""
    for op, x, w in [("qnn.conv2d", _i8(rng, (1, 4, 4, 8)), _i8(rng, (1, 1, 8, 4))),
                     ("qnn.dense", _i8(rng, (2, 8)), _i8(rng, (8, 4)))]:
        node = Node("layer3_conv", op, ("a", "b"), bad)
        got = get_op(op).torch_impl(torch.from_numpy(x), torch.from_numpy(w), node=node)
        want = j_get_op(op).np_impl(x, w, node=JNode("layer3_conv", op, ("a", "b"), bad))
        np.testing.assert_array_equal(got.numpy(), want)
        node = Node("layer3_conv", op, ("a", "b"), dict(bad, out_dtype="int64"))
        with pytest.raises(NotImplementedError, match=f"layer3_conv.*{match}"):
            get_op(op).torch_impl(torch.from_numpy(x.astype(np.int16)), torch.from_numpy(w),
                                  node=node)


@pytest.mark.parametrize("axis", [-1, 1])
def test_bias_add_torch_matches_jax_and_oracle(rng, axis):
    x = rng.integers(-(2 ** 31), 2 ** 31, (2, 5, 3, 4), dtype=np.int64).astype(np.int32)
    x[0, 0, 0, :] = 2 ** 31 - 1                         # wraps around
    b = rng.integers(-(2 ** 31), 2 ** 31, x.shape[axis], dtype=np.int64).astype(np.int32)
    got, *others = _three_ways("nn.bias_add", dict(axis=axis), x, b)
    for o in others:
        np.testing.assert_array_equal(got, o)
    xf = rng.standard_normal((2, 4)).astype(np.float32)
    got, *others = _three_ways("nn.bias_add", dict(axis=-1), xf, xf[0])
    for o in others:
        np.testing.assert_array_equal(got, o)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("rounding", ["UPWARD", "TONEAREST"])
def test_requantize_torch_matches_jax_and_oracle(rng, per_channel, rounding):
    x = rng.integers(-(2 ** 20), 2 ** 20, (2, 3, 3, 6)).astype(np.int32)
    x[0, 0, 0, :] = [2 ** 31 - 1, -(2 ** 31), 5, -5, 0, 1]
    scale = list(0.0004 * (1 + rng.random(6))) if per_channel else 0.00061
    attrs = dict(input_scale=scale, input_zero_point=3, output_scale=0.05,
                 output_zero_point=-2, axis=-1, rounding=rounding, out_dtype="int8")
    got, *others = _three_ways("qnn.requantize", attrs, x)
    for o in others:
        np.testing.assert_array_equal(got, o)


# ---------------------------------------------------------------------------
# (d) the slice: unfused quantized ResNet, executor and trace
# ---------------------------------------------------------------------------

def _quantized(layers, size):
    rng = np.random.default_rng(5)
    calib = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    jq = j_quantize(j_resnet(layers, batch_size=1, image_size=size), [calib])
    return jq, from_reference_graph(jq.to_json()), x, calib


@pytest.fixture(scope="module")
def r18():
    jq, q, x, calib = _quantized(18, 32)
    return jq, q, x, calib, emit_trace(q, x, backend="torch", device="cpu")


@pytest.mark.parametrize("layers,size", [(18, 32), (50, 64)])
def test_unfused_resnet_matches_jax_executor_and_oracle(layers, size):
    jq, q, x, _ = _quantized(layers, size)
    names = computational_nodes(jq)
    before = dict(_lib.LAUNCHES)
    got = TorchExecutor(q, capture=names, device="cpu", fuse=False).run(x)
    assert dict(_lib.LAUNCHES) == before
    want = JaxExecutor(jq, capture=names, fuse=False).run(x)
    oracle = {}
    run_graph(q, x, intercept=lambda name, op, args, out: oracle.__setitem__(name, out))
    n_int = 0
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{name} vs JaxExecutor")
            np.testing.assert_array_equal(a, oracle[name], err_msg=f"{name} vs oracle")
            n_int += 1
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    convs = sum(q[n].op in ("qnn.conv2d", "qnn.dense") for n in names)
    assert n_int == len(names) - 2 and convs == (21 if layers == 18 else 54)


def _assert_same_trace(blob, ref_blob, rtol=RTOL, atol=ATOL, n_float=2):
    """The port's trace against the reference's: hash, meta, ids, names, op
    names and attrs equal, integer records byte-equal, float tensors within
    rtol / atol; `n_float` float records (None: any number)."""
    r, ref = fmt.TraceReader(io.BytesIO(blob)), j_format.TraceReader(io.BytesIO(ref_blob))
    assert r.graph_hash == ref.graph_hash and len(r) == len(ref) and r.meta == ref.meta
    n_int = 0
    for a, b in zip(r, ref):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        assert fmt.op_id(a.op_name) == j_format.op_id(b.op_name)
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), f"record bytes differ: {a.name}"
            n_int += 1
        else:
            assert [t.role for t in a.tensors] == [t.role for t in b.tensors]
            for ta, tb in zip(a.tensors, b.tensors):
                np.testing.assert_allclose(ta.to_array(), tb.to_array(), rtol=rtol, atol=atol)
    assert n_float is None or n_int == len(r) - n_float
    return len(r)


def test_resnet18_trace_matches_reference(r18):
    jq, q, x, calib, blob = r18
    assert _assert_same_trace(blob, j_emit_trace(jq, x, backend="jax")) == 93
    j_oracle = j_emit_trace(jq, x, backend="oracle")
    assert _assert_same_trace(blob, j_oracle) == 93
    # both numpy oracles: the same bytes, float records included
    assert emit_trace(q, x, backend="oracle") == j_oracle
    # the port's own quantizer gives the same graph, so the same trace
    own = quantize(resnet(18, batch_size=1, image_size=32), [calib])
    assert emit_trace(own, x, backend="torch", device="cpu") == blob


@pytest.mark.parametrize("fused,records", [(False, 69), (True, 63)])
def test_float_bert_trace_matches_reference(fused, records):
    """A float BERT (2 layers, hidden 64, 4 heads), taken from the reference's
    graph JSON, unfused and fused by the reference's fuse_attention: both
    oracle backends give the same bytes; the port's torch backend against
    the reference's jax one at the float transformers' tolerance (PERF.md
    section 2: rtol 1e-4, atol 1e-4; float32 sums in another order), and
    the port's verify_trace accepts it."""
    jg = j_bert(1, 8, 64, 2, 4, 128, vocab=100)
    if fused:
        jg = j_fuse_attention(jg)
    g = from_reference_graph(jg.to_json())
    x = np.random.default_rng(0).integers(0, 100, (1, 8)).astype(np.int32)
    assert emit_trace(g, x, backend="oracle") == j_emit_trace(jg, x, backend="oracle")
    blob = emit_trace(g, x, backend="torch", device="cpu")
    assert _assert_same_trace(blob, j_emit_trace(jg, x, backend="jax"), rtol=1e-4, atol=1e-4,
                              n_float=None) == records
    res = verify_trace(blob)
    assert res["verified"] == res["records"] == records and not res["mismatches"]


def test_resnet50_trace_matches_reference():
    jq, q, x, _ = _quantized(50, 64)
    blob = emit_trace(q, x, backend="torch", device="cpu")
    assert _assert_same_trace(blob, j_emit_trace(jq, x, backend="oracle")) == 232


# ---------------------------------------------------------------------------
# (e) emit_to: streaming, the native writer and the Python writer
# ---------------------------------------------------------------------------

def test_emit_to_native_and_python_writers_give_the_same_bytes(r18, tmp_path, monkeypatch):
    _, q, x, _, blob = r18
    assert native.native_available()
    assert native.library_path().parent == native.BUILD_DIR
    em = TraceEmitter(q, backend="torch", device="cpu", meta={"model": "r18"})
    em.emit_to(x, tmp_path / "native.bin")
    timings = dict(em.last_timings)
    assert timings["writer"] == "native" and len(timings["group_waits"]) > 1
    assert timings["fetched_bytes"] == sum(
        t.numel() * t.element_size() for t in em._executor.run_device(x))
    native_path = str(tmp_path / "n2.bin")
    native.emit_trace_native(q, x, native_path, device="cpu", meta={"model": "r18"})
    monkeypatch.setattr(emitter, "native_available", lambda: False)
    em.emit_to(x, tmp_path / "python.bin")
    assert em.last_timings["writer"] == "python"
    want = TraceEmitter(q, device="cpu", meta={"model": "r18"}).emit_bytes(x)
    for name in ("native.bin", "n2.bin", "python.bin"):
        assert (tmp_path / name).read_bytes() == want, name
    assert native.native_verify(native_path) == 93
    em_oracle = TraceEmitter(q, backend="oracle")
    assert em_oracle.emit_to(x, tmp_path / "o.bin") == 93
    assert (tmp_path / "o.bin").read_bytes() == emit_trace(q, x, backend="oracle")
    assert blob[:8] == fmt.MAGIC


def test_packed_fetch_keeps_scalars_empties_bools_and_tuples():
    outs = [torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.tensor(2.5),
            torch.zeros((0, 4), dtype=torch.int8), torch.tensor([True, False, True]),
            [torch.tensor([7], dtype=torch.int64), torch.arange(3, dtype=torch.int16)]]
    names = ["a", "b", "c", "d", "e"]
    flat, spec, node_end = emitter._flatten(names, outs)
    values = {}
    emitter._slice(emitter._pack(flat, "cpu").numpy(), spec, values)
    for nm, o in zip(names, outs):
        for got, want in zip(values[nm] if isinstance(o, list) else [values[nm]],
                             o if isinstance(o, list) else [o]):
            np.testing.assert_array_equal(got, want.numpy())
            assert got.dtype == want.numpy().dtype and got.shape == tuple(want.shape)
    groups = emitter._pack_groups(spec, node_end, names, 3)
    assert groups[0][0] == 0 and groups[-1][1] == len(spec)
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(groups, groups[1:]))
    assert all(hi in node_end.values() for _, hi in groups)
    with pytest.raises(TypeError, match="cannot pack"):
        emitter._flatten(["a"], [np.zeros(3)])


def test_emitter_refuses_unported_backends_and_a_missing_card(r18, monkeypatch):
    _, q, _, _, _ = r18
    # the JAX package's backend names are not the port's: "jax-segmented" is
    # "torch-segmented" here
    with pytest.raises(ValueError, match="torch-segmented"):
        TraceEmitter(q, backend="jax-segmented")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TraceEmitter(q)


# ---------------------------------------------------------------------------
# (f) the JAX package's verifier and CLI accept the port's trace
# ---------------------------------------------------------------------------

def _tampered(blob: bytes) -> bytes:
    """The trace with one integer output value changed, CRCs made valid."""
    r = fmt.TraceReader(io.BytesIO(blob))
    out = io.BytesIO()
    w = fmt.TraceWriter(out, r.graph_hash, r.meta)
    w.begin(len(r))
    for i, rec in enumerate(r):
        if i == 5:
            t = rec.output
            arr = t.to_array().copy()
            arr.reshape(-1)[0] ^= 1
            t.data = arr.tobytes()
        w.write(rec)
    w.finish()
    return out.getvalue()


def test_reference_verifier_and_cli_accept_the_port_trace(r18, tmp_path):
    jq, q, x, _, blob = r18
    for verify in (j_verify_trace, verify_trace):
        res = verify(blob)
        assert res["verified"] == res["records"] == 93 and not res["mismatches"]
    path = tmp_path / "t.bin"
    path.write_bytes(blob)
    graph = tmp_path / "g.json"
    graph.write_text(q.to_json())
    with pytest.raises(SystemExit) as e:
        j_cli_main(["verify", str(path), "--graph", str(graph)])
    assert e.value.code == 0
    bad = _tampered(blob)
    for verify in (j_verify_trace, verify_trace):
        res = verify(bad)
        assert res["verified"] == 92 and len(res["mismatches"]) == 1
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0xFF
    for mod in (fmt, j_format):
        with pytest.raises(mod.TraceCorrupt):
            mod.TraceReader(io.BytesIO(bytes(flipped)))
    path.write_bytes(bytes(flipped))
    with pytest.raises(fmt.TraceCorrupt, match="CRC"):
        native.native_verify(str(path))
    assert struct.unpack_from("<Q", blob, 48)[0] == 93


# ---------------------------------------------------------------------------
# (g) the port's CLI
# ---------------------------------------------------------------------------

def test_cli_quantize_trace_verify(tmp_path, capsys):
    graph, trace = str(tmp_path / "r18.json"), str(tmp_path / "r18.bin")
    cli_main(["quantize", "resnet18", "--image-size", "32", "-o", graph])
    cli_main(["trace", graph, "-o", trace, "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli_main(["verify", trace, "--graph", graph])
    assert e.value.code == 0
    cli_main(["info", graph])
    out = capsys.readouterr().out
    assert "93 records" in out and "verified 93/93 records" in out and "qnn.conv2d" in out
    for argv, match in [(["bench", graph], "Queue 1 item 3"),
                        (["quantize", "alexnet", "-o", graph], "unknown zoo model"),
                        (["run", str(tmp_path / "m.txt"), "--device", "cpu"], "not a graph")]:
        with pytest.raises(SystemExit, match=match):
            cli_main(argv)
