"""The port's TensorFlow and Keras import path on the CPU, against the JAX
package's: the GraphDef codec (frontend/tf_proto.py) against TensorFlow's
own protobuf, `from_tf_graphdef` on every model tests/test_frontend_tf.py
builds (run through those tests with both importers), the port's
`from_tf_function` / `from_keras` / `from_saved_model`, Keras's ResNet-50 as
models/keras_resnet.py writes it (against Keras's own frozen graph and
TensorFlow's run of the written one), then quantize, fuse, run, trace and
the CLI.

Graphs compare by `Graph.to_json()` (equal bytes).  Float runs compare with
the JAX package's oracle within tests/test_frontend_tf.py's RTOL, ATOL =
2e-4, 2e-5; integers with ==.  Only the cases that need TensorFlow import it
(`pytest.importorskip`); Keras is seeded (`keras.utils.set_random_seed(0)`)
before every model it builds, so no case depends on an unseeded
initializer."""

import ast
import collections
import inspect
import io
import os
import struct
import sys

import numpy as np
import pytest

import tachikoma_tpu.frontend.tensorflow as j_tf
import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
import tachikoma_tpu.quantize.quantizer as j_quantizer
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import computational_nodes, run_graph_jax
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import infer_types
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.frontend import (from_keras, from_saved_model, from_tf_function,
                                          from_tf_graphdef)
from tachikoma_tpu_torch.frontend import tensorflow as port_tf
from tachikoma_tpu_torch.frontend import tf_proto as proto
from tachikoma_tpu_torch.models.keras_resnet import resnet50_keras
from tachikoma_tpu_torch.ops.kernels import conv, matmul_int8
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 2e-4, 2e-5  # tests/test_frontend_tf.py
# the op histogram of keras.applications.ResNet50's frozen graph at b2 32^2
# (and at b8 224^2): the BatchNormalization of Keras 3 unfolded
KERAS_R50_OPS = {"Placeholder": 1, "Const": 641, "Identity": 321, "Conv2D": 53, "BiasAdd": 54,
                 "Reshape": 265, "Squeeze": 53, "Rsqrt": 53, "Mul": 159, "Sub": 53,
                 "AddV2": 122, "Relu": 49, "Pad": 2, "MaxPool": 1, "Mean": 1, "MatMul": 1,
                 "Softmax": 1, "NoOp": 1}


def _tf():
    tf = pytest.importorskip("tensorflow")
    import keras

    keras.utils.set_random_seed(0)
    return tf


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

def _varint(v):
    return proto._write_varint(v)


def _field(no, wire, payload=b""):
    if wire == 2:
        return _varint((no << 3) | 2) + _varint(len(payload)) + payload
    return _varint((no << 3) | wire) + payload


def _tf_graph(tf, name):
    """A frozen tf.function with the constant kinds of a small model
    (float, int32 shapes, float16) or a Keras model's frozen graph."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    w = np.random.RandomState(0).randn(3, 3, 3, 8).astype(np.float32)

    @tf.function
    def f(x):
        s = tf.shape(x)
        y = tf.nn.conv2d(x, w, strides=[1, 2, 2, 1], padding="SAME")
        y = tf.reshape(y, [s[0], -1])
        half = tf.cast(tf.constant([1.5, -2.0, 0.25], tf.float16), tf.float32)
        return tf.concat([y, tf.zeros([2, 3]) + half], axis=-1)

    if name == "tf_function":
        return convert_variables_to_constants_v2(f.get_concrete_function(
            tf.TensorSpec((2, 9, 9, 3), tf.float32))).graph.as_graph_def()
    L = tf.keras.layers
    m = tf.keras.Sequential([L.Input((8, 8, 3)), L.Conv2D(4, 3), L.BatchNormalization(),
                             L.Flatten(), L.Dense(5, activation="softmax")])
    fm = tf.function(lambda x: m(x, training=False))
    return convert_variables_to_constants_v2(fm.get_concrete_function(
        tf.TensorSpec((1, 8, 8, 3), tf.float32))).graph.as_graph_def()


@pytest.mark.parametrize("name", ["tf_function", "keras"])
def test_codec_round_trips_tensorflows_graphs(name):
    """Decode TensorFlow's bytes, re-encode them: TensorFlow parses the
    result to a message == the original (map order is free, so messages,
    not bytes, are compared), and every constant decodes as
    tf.make_ndarray decodes it."""
    tf = _tf()
    gd = _tf_graph(tf, name)
    m = proto.parse_graph_def(gd.SerializeToString())
    back = tf.compat.v1.GraphDef()
    back.ParseFromString(proto.encode(m))
    assert back == gd
    assert [n.name for n in m.node] == [n.name for n in gd.node]
    for ours, theirs in zip(m.node, gd.node):
        assert (ours.op, list(ours.input), sorted(ours.attr)) == \
            (theirs.op, list(theirs.input), sorted(theirs.attr))
        if ours.op == "Const":
            a, b = proto.make_ndarray(ours.attr["value"].tensor), \
                tf.make_ndarray(theirs.attr["value"].tensor)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_codec_reads_negative_varints_as_tensorflow_writes_them():
    """A negative AttrValue.i, list.i and dim size: ten-byte two's
    complement varints, both ways."""
    tf = _tf()
    from tensorflow.core.framework import attr_value_pb2, node_def_pb2

    nd = node_def_pb2.NodeDef(name="n", op="Foo")
    nd.attr["i"].CopyFrom(attr_value_pb2.AttrValue(i=-7))
    nd.attr["l"].CopyFrom(attr_value_pb2.AttrValue(
        list=attr_value_pb2.AttrValue.ListValue(i=[-1, 2, -(1 << 40)])))
    nd.attr["shape"].CopyFrom(attr_value_pb2.AttrValue(
        shape=tf.TensorShape([None, 3]).as_proto()))
    blob = nd.SerializeToString()
    assert _varint(-7) == b"\xf9" + b"\xff" * 8 + b"\x01"
    m = proto.decode(blob, "NodeDef")
    assert m.attr["i"].i == -7
    assert m.attr["l"].list.i == [-1, 2, -(1 << 40)]
    assert [d.size for d in m.attr["shape"].shape.dim] == [-1, 3]
    back = node_def_pb2.NodeDef()
    back.ParseFromString(proto.encode(m))
    assert back == nd


def test_codec_reads_packed_and_unpacked_scalars():
    """int_val written unpacked (one record a value) and packed, float_val
    packed, dims one record each: the same array through the codec and
    tf.make_ndarray."""
    tf = _tf()
    from tensorflow.core.framework import tensor_pb2

    shape = _field(2, 2, _field(2, 2, _field(1, 0, _varint(3))))
    unpacked = _field(1, 0, _varint(3)) + shape + b"".join(
        _field(7, 0, _varint(v)) for v in (5, -2, 9))
    packed = _field(1, 0, _varint(3)) + shape + _field(
        7, 2, b"".join(_varint(v) for v in (5, -2, 9)))
    floats = _field(1, 0, _varint(1)) + shape + _field(5, 2, struct.pack("<3f", 1.5, -2.0, .25))
    for blob, want in ((unpacked, [5, -2, 9]), (packed, [5, -2, 9]),
                       (floats, np.float32([1.5, -2.0, 0.25]))):
        t = tensor_pb2.TensorProto()
        t.ParseFromString(blob)
        got = proto.make_ndarray(proto.decode(blob, "TensorProto"))
        np.testing.assert_array_equal(got, tf.make_ndarray(t))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == tf.make_ndarray(t).dtype


@pytest.mark.parametrize("dtype,vals,shape", [
    ("float32", [2.5], (2, 3)),          # a splat: one value fills the shape
    ("int32", [1, 2], (2, 2)),           # shorter than the shape: the last value repeats
    ("int64", [], (3,)),                 # empty: zeros
    ("bool", [True], (2, 2)),
    ("float64", [0.1, -3.0], (2,)),
    ("float16", [1.5, -0.25, 65504.0], (3,)),   # half_val: bit patterns in int32
    ("bfloat16", [1.5, -3.0], (2, 2)),
    ("uint8", [200, 7], (2,)),
    ("int8", [-128, 127], (2,)),
    ("uint32", [4000000000], (1,)),
    ("uint64", [1 << 63], (1,)),
], ids=["float_splat", "int32_short", "int64_empty", "bool", "float64", "float16", "bfloat16",
        "uint8", "int8", "uint32", "uint64"])
def test_make_ndarray_is_tensorflows(dtype, vals, shape):
    tf = _tf()
    tp = tf.make_tensor_proto(np.asarray(vals, dtype=tf.as_dtype(dtype).as_numpy_dtype)
                              if vals else [], dtype=tf.as_dtype(dtype), shape=shape)
    # tf.make_tensor_proto writes tensor_content for some inputs: rewrite the
    # values into the typed list so that the *_val path is what is read
    arr = np.asarray(vals, dtype=tf.as_dtype(dtype).as_numpy_dtype)
    tp.ClearField("tensor_content")
    if dtype in ("float16", "bfloat16"):
        tp.half_val[:] = [int(v) for v in arr.view(np.uint16)]
    elif vals:
        field = {"float32": "float_val", "float64": "double_val", "int64": "int64_val",
                 "bool": "bool_val", "uint32": "uint32_val", "uint64": "uint64_val"}.get(
            dtype, "int_val")
        getattr(tp, field)[:] = arr.tolist()
    blob = tp.SerializeToString()
    want = tf.make_ndarray(tp)
    got = proto.make_ndarray(proto.decode(blob, "TensorProto"))
    assert str(got.dtype) == str(want.dtype) == dtype and got.shape == want.shape == shape
    np.testing.assert_array_equal(got.astype(np.float64) if dtype == "bfloat16" else got,
                                  want.astype(np.float64) if dtype == "bfloat16" else want)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "uint8", "int32", "int64",
                                   "bool", "float16"])
def test_make_tensor_proto_round_trips(dtype):
    """The writer's constants: 0-d in the typed list, others in
    tensor_content, read back as written (and by TensorFlow)."""
    a = (np.random.default_rng(3).standard_normal((3, 4)) * 50).astype(dtype)
    for arr in (a, a[0, 0]):
        blob = proto.encode(proto.make_tensor_proto(arr))
        back = proto.make_ndarray(proto.decode(blob, "TensorProto"))
        assert back.dtype == arr.dtype and back.shape == arr.shape
        np.testing.assert_array_equal(back, arr)
    tf = _tf()
    from tensorflow.core.framework import tensor_pb2

    t = tensor_pb2.TensorProto()
    t.ParseFromString(proto.encode(proto.make_tensor_proto(a)))
    np.testing.assert_array_equal(tf.make_ndarray(t), a)


def test_dtypes_outside_the_table_raise_as_the_reference_does():
    """A string constant and a string placeholder: NotImplementedError
    naming the enum, in both importers."""
    string = proto.Message("TensorProto", dtype=7, tensor_shape=proto.shape_proto([1]))
    with pytest.raises(NotImplementedError, match="TF dtype enum 7"):
        proto.make_ndarray(string)
    gd = proto.Message("GraphDef", node=[proto.Message("NodeDef", name="x", op="Placeholder", attr={
        "dtype": proto.Message("AttrValue", type=7),
        "shape": proto.Message("AttrValue", shape=proto.shape_proto([2]))})])
    with pytest.raises(NotImplementedError, match="TF dtype enum 7"):
        from_tf_graphdef(gd)
    tf = _tf()
    jgd = tf.compat.v1.GraphDef()
    jgd.ParseFromString(gd.SerializeToString())
    with pytest.raises(NotImplementedError, match="TF dtype enum 7"):
        j_tf.from_tf_graphdef(jgd)


def test_codec_keeps_fields_outside_its_schema():
    """A node's device and a field the schema does not name (a debug-info
    record) survive a decode and an encode."""
    raw = (_field(1, 2, b"n") + _field(2, 2, b"Relu") + _field(3, 2, b"x")
           + _field(4, 2, b"/device:CPU:0") + _field(6, 2, _field(1, 2, b"orig")))
    m = proto.decode(raw, "NodeDef")
    assert (m.name, m.op, m.input, m.device) == ("n", "Relu", ["x"], "/device:CPU:0")
    assert m._unknown == [(6, 2, _field(1, 2, b"orig"))]
    assert proto.encode(m) == raw
    assert proto.decode(proto.encode(m), "NodeDef") == m


# ---------------------------------------------------------------------------
# the importer
# ---------------------------------------------------------------------------

def test_every_converter_is_the_references():
    """The port's importer has the JAX importer's converters, name for name:
    92 functions, 103 op names with their aliases."""
    from tachikoma_tpu.frontend.tensorflow import _GraphDefImporter as JImporter
    from tachikoma_tpu_torch.frontend.tensorflow import _GraphDefImporter

    ours = sorted(n for n in dir(_GraphDefImporter) if n.startswith("op_"))
    theirs = sorted(n for n in dir(JImporter) if n.startswith("op_"))
    assert ours == theirs and len(ours) == 103
    tree = ast.parse(inspect.getsource(port_tf))
    defs = [f.name for c in ast.walk(tree) if isinstance(c, ast.ClassDef)
            for f in c.body if isinstance(f, ast.FunctionDef) and f.name.startswith("op_")]
    assert len(defs) == 92


def _frontend_tf_cases():
    """(test name, index of its parameter set or None) for every case of
    tests/test_frontend_tf.py, read from its source (collecting it needs no
    TensorFlow)."""
    tree = ast.parse(open(os.path.join(HERE, "test_frontend_tf.py")).read())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        ids = [None]
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and getattr(dec.func, "attr", "") == "parametrize":
                ids = [k.value for k in dec.keywords if k.arg == "ids"][0]
                ids = [e.value for e in ids.elts]
        out += [(fn.name, i, name) for i, name in enumerate(ids)]
    return out


FRONTEND_TF_CASES = _frontend_tf_cases()


@pytest.mark.parametrize("name,index,pid", FRONTEND_TF_CASES,
                         ids=[n if p is None else f"{n}[{p}]" for n, _, p in FRONTEND_TF_CASES])
def test_frontend_tf_case_imports_and_runs_as_the_reference(name, index, pid, monkeypatch,
                                                            tmp_path):
    """The case runs with both importers behind the JAX package's
    `from_tf_graphdef` (every GraphDef it imports goes through both: equal
    JSON), both quantizers behind `quantize` (equal JSON), and the port's
    CPU path beside the oracle behind `run_graph` (within RTOL / ATOL)."""
    _tf()
    sys.path.insert(0, HERE)
    import test_frontend_tf as mod

    paired, runs = {}, []
    real_import, real_quantize = j_tf.from_tf_graphdef, j_quantizer.quantize

    def both_import(graph_def, input_specs=None, outputs=None):
        jg = real_import(graph_def, input_specs, outputs)
        g = from_tf_graphdef(graph_def, input_specs, outputs)
        assert g.to_json() == jg.to_json()
        paired[id(jg)] = g
        return jg

    def both_quantize(jg, data, *a, **k):
        jq = real_quantize(jg, data, *a, **k)
        if id(jg) in paired:
            q = quantize(paired[id(jg)], data, *a, **k)
            assert q.to_json() == jq.to_json()
            paired[id(jq)] = q
        return jq

    def both_run(jg, feeds, *a, **k):
        wants = j_run_graph(jg, feeds, *a, **k)
        if id(jg) in paired:
            g = paired[id(jg)]
            for nm, got, want in zip(g.outputs, TorchExecutor(g, device="cpu").run(feeds), wants):
                _held(got, want, f"{name} {nm} ({g[nm].op})")
            runs.append(name)
        return wants

    monkeypatch.setattr(j_tf, "from_tf_graphdef", both_import)
    monkeypatch.setattr(j_quantizer, "quantize", both_quantize)
    monkeypatch.setattr(mod, "run_graph", both_run)
    fn = getattr(mod, name)
    args = {}
    if "tmp_path" in inspect.signature(fn).parameters:
        args["tmp_path"] = tmp_path
    if index is not None and pid is not None:
        args["build"] = fn.pytestmark[0].args[1][index]
    fn(**args)
    assert paired and runs


def test_port_entry_points_equal_the_references(tmp_path):
    """The port's own from_tf_function, from_keras (a model, a .keras file)
    and from_saved_model give the JAX package's graphs."""
    tf = _tf()
    from tachikoma_tpu.frontend.keras import from_keras as j_from_keras

    w = np.random.RandomState(0).randn(16, 8).astype(np.float32)

    def f(x):
        return tf.nn.softmax(tf.matmul(x, w))

    assert from_tf_function(f, [((4, 16), "float32")]).to_json() == \
        j_tf.from_tf_function(f, [((4, 16), "float32")]).to_json()
    L = tf.keras.layers
    m = tf.keras.Sequential([L.Input((8, 8, 3)), L.Conv2D(4, 3, activation="relu"),
                             L.Flatten(), L.Dense(5)])
    assert from_keras(m, batch=2).to_json() == j_from_keras(m, batch=2).to_json()
    path = str(tmp_path / "m.keras")
    m.save(path)
    g = from_keras(path)
    assert g.to_json() == j_from_keras(path).to_json()
    x = np.random.RandomState(1).randn(1, 8, 8, 3).astype(np.float32)
    _held(TorchExecutor(g, device="cpu").run([x])[0], m(x, training=False).numpy(), "keras")
    sm = str(tmp_path / "sm")
    tf.saved_model.save(m, sm, signatures=tf.function(lambda x: m(x)).get_concrete_function(
        tf.TensorSpec((1, 8, 8, 3), tf.float32)))
    assert from_saved_model(sm).to_json() == j_tf.from_saved_model(sm).to_json()


def _mlp_graphdef():
    """A codec-built GraphDef: Placeholder -> MatMul(Const) -> BiasAdd ->
    Relu -> Identity, with a control input and an unconsumed Identity."""
    rng = np.random.default_rng(0)
    f32 = proto.Message("AttrValue", type=1)

    def node(name, op, inputs=(), **attr):
        return proto.Message("NodeDef", name=name, op=op, input=list(inputs), attr=attr)

    def const(name, arr):
        return node(name, "Const", value=proto.Message("AttrValue",
                                                       tensor=proto.make_tensor_proto(arr)),
                    dtype=proto.Message("AttrValue", type=1))

    return proto.Message("GraphDef", node=[
        node("x", "Placeholder", dtype=f32,
             shape=proto.Message("AttrValue", shape=proto.shape_proto([3, 8]))),
        const("w", rng.standard_normal((8, 4)).astype(np.float32)),
        const("b", rng.standard_normal(4).astype(np.float32)),
        node("mm", "MatMul", ["x", "w"], T=f32, transpose_a=proto.Message("AttrValue", b=False),
             transpose_b=proto.Message("AttrValue", b=False)),
        node("ba", "BiasAdd", ["mm", "b", "^w"], T=f32),
        node("relu", "Relu", ["ba:0"], T=f32),
        node("Identity", "Identity", ["relu"], T=f32)])


def test_from_tf_graphdef_reads_every_form_and_keeps_the_references_rules(tmp_path):
    """The codec's GraphDef, bytes, a .pb path and TensorFlow's GraphDef
    import to one graph, the JAX importer's; `^` inputs are control edges,
    the output is the unconsumed Identity, an unknown op raises naming it,
    and an unknown dim asks for input_specs."""
    gd = _mlp_graphdef()
    blob = gd.SerializeToString()
    path = tmp_path / "mlp.pb"
    path.write_bytes(blob)
    g = from_tf_graphdef(gd)
    assert [n.op for n in g.nodes if n.op not in ("var", "const")] == \
        ["nn.dense", "nn.bias_add", "nn.relu"]
    for form in (blob, str(path), path):
        assert from_tf_graphdef(form).to_json() == g.to_json()
    x = np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32)
    tf = _tf()
    tgd = tf.compat.v1.GraphDef()
    tgd.ParseFromString(blob)
    jg = j_tf.from_tf_graphdef(tgd)
    assert from_tf_graphdef(tgd).to_json() == g.to_json() == jg.to_json()
    _held(TorchExecutor(g, device="cpu").run({"x": x})[0], j_run_graph(jg, {"x": x})[0], "mlp")
    gd.node[4].op = "NoSuchOp"
    with pytest.raises(NotImplementedError, match=r"TF op NoSuchOp \(node ba\)"):
        from_tf_graphdef(gd)
    gd = _mlp_graphdef()
    gd.node[0].attr["shape"] = proto.Message("AttrValue", shape=proto.shape_proto([-1, 8]))
    with pytest.raises(ValueError, match="unknown dims"):
        from_tf_graphdef(gd)
    assert from_tf_graphdef(gd, input_specs={"x": (3, 8)}).to_json() == g.to_json()
    with pytest.raises(TypeError, match="GraphDef"):
        from_tf_graphdef(proto.Message("NodeDef"))


def test_mirror_pad_symmetric_follows_the_references_edge_pad():
    """A reference fault the port keeps (ROADMAP Queue 3): the JAX importer
    maps MirrorPad's SYMMETRIC to `nn.pad` mode "edge" (it repeats the
    border value), where TensorFlow mirrors the border too (numpy's
    "symmetric"); REFLECT is right.  Both importers give the same graph."""
    tf = _tf()
    x = np.arange(1, 5, dtype=np.float32).reshape(1, 4)
    for mode, want_mode in (("REFLECT", "reflect"), ("SYMMETRIC", "symmetric")):
        def f(t, mode=mode):
            return tf.pad(t, [[0, 0], [2, 2]], mode=mode)

        g, jg = from_tf_function(f, [((1, 4), "float32")]), \
            j_tf.from_tf_function(f, [((1, 4), "float32")])
        assert g.to_json() == jg.to_json()
        got = TorchExecutor(g, device="cpu").run([x])[0]
        np.testing.assert_array_equal(got, j_run_graph(jg, [x])[0])
        tf_out = f(tf.constant(x)).numpy()
        np.testing.assert_array_equal(tf_out, np.pad(x, [(0, 0), (2, 2)], mode=want_mode))
        if mode == "REFLECT":
            np.testing.assert_array_equal(got, tf_out)
        else:
            np.testing.assert_array_equal(got, np.pad(x, [(0, 0), (2, 2)], mode="edge"))
            assert not np.array_equal(got, tf_out)


# ---------------------------------------------------------------------------
# Keras's ResNet-50 as models/keras_resnet.py writes it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r50():
    """The writer's ResNet-50 at b2 32^2, both packages' imports, quantized
    graphs and fused graphs, on one seeded input."""
    blob = resnet50_keras(2, 32)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    g = from_tf_graphdef(blob)
    pytest.importorskip("tensorflow")
    import tensorflow as tf

    tgd = tf.compat.v1.GraphDef()
    tgd.ParseFromString(blob)
    jg = j_tf.from_tf_graphdef(tgd)
    q, jq = quantize(g, [x]), j_quantize(jg, [x])
    return dict(blob=blob, tgd=tgd, x=x, g=g, jg=jg, q=q, jq=jq, fused=fuse_qnn(q))


def test_keras_resnet50_is_keras_frozen_graph_node_for_node(r50):
    """Keras's own frozen ResNet-50 (random init, the same shape): the same
    nodes in the same order, names, ops, inputs and attrs (the constants'
    values aside); the op histogram of the b8 224^2 graph."""
    tf = _tf()
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    m = tf.keras.applications.ResNet50(weights=None, input_shape=(32, 32, 3))
    fn = tf.function(lambda x: m(x, training=False))
    ref = convert_variables_to_constants_v2(fn.get_concrete_function(
        tf.TensorSpec((2, 32, 32, 3), tf.float32))).graph.as_graph_def()
    ours = r50["tgd"]
    assert collections.Counter(n.op for n in ours.node) == \
        collections.Counter(n.op for n in ref.node) == KERAS_R50_OPS
    assert len(ours.node) == len(ref.node) == 1831
    for a, b in zip(ours.node, ref.node):
        assert (a.name, a.op, list(a.input), sorted(a.attr)) == \
            (b.name, b.op, list(b.input), sorted(b.attr))
        for k in a.attr:
            if k == "value":
                ta, tb = tf.make_ndarray(a.attr[k].tensor), tf.make_ndarray(b.attr[k].tensor)
                assert (ta.dtype, ta.shape) == (tb.dtype, tb.shape), a.name
                if ta.dtype != np.float32 or ta.ndim == 0:  # shapes, paddings, eps
                    np.testing.assert_array_equal(ta, tb, err_msg=a.name)
            else:
                assert a.attr[k] == b.attr[k], (a.name, k)
    assert ours.versions == ref.versions
    assert collections.Counter(n.op for n in proto.parse_graph_def(resnet50_keras(8, 224)).node) \
        == KERAS_R50_OPS


def test_keras_resnet50_runs_in_tensorflow_as_on_the_ports_cpu_path(r50):
    """TensorFlow imports the written bytes and runs them; the port's float
    CPU path gives its probabilities."""
    tf = _tf()
    graph = tf.Graph()
    with graph.as_default():
        tf.graph_util.import_graph_def(r50["tgd"], name="")
    with tf.compat.v1.Session(graph=graph) as sess:
        want = sess.run("Identity:0", {"x:0": r50["x"]})
    got = TorchExecutor(r50["g"], device="cpu").run([r50["x"]])[0]
    _held(got, want, "ResNet-50 probabilities")
    assert 0.01 < want.max() < 0.99  # logits of the order of 1-10: no saturated softmax


def test_keras_resnet50_imports_quantizes_and_fuses_as_the_reference(r50, monkeypatch):
    """Import, quantized and fused graphs == the JAX package's; the fused
    graph keeps each batch norm as a qnn.mul and a qnn.add between its conv
    and the ReLU, so no chain or block stack forms: 53 tk.conv2d_rq (the
    1x1 convs, strided ones too, on K1's GEMM; the 3x3 and the stem on K2)
    and a tk.dense_rq, with every output == the oracle's."""
    g, jg, q, jq, fused, x = (r50[k] for k in ("g", "jg", "q", "jq", "fused", "x"))
    assert g.to_json() == jg.to_json()
    ops = collections.Counter(n.op for n in g.nodes)
    assert {k: ops[k] for k in ("nn.conv2d", "nn.bias_add", "rsqrt", "multiply", "subtract",
                                "add", "nn.relu", "nn.pad", "const")} == {
        "nn.conv2d": 53, "nn.bias_add": 54, "rsqrt": 53, "multiply": 159, "subtract": 53,
        "add": 69, "nn.relu": 49, "nn.pad": 2, "const": 320}
    assert q.to_json() == jq.to_json()
    assert fused.to_json() == j_fuse_qnn(jq).to_json()
    counts = collections.Counter(n.op for n in fused.nodes)
    assert {k: counts[k] for k in ("tk.conv2d_rq", "tk.conv2d_chain", "tk.conv2d_block_stack",
                                   "tk.dense_rq", "qnn.mul", "qnn.add")} == {
        "tk.conv2d_rq": 53, "tk.conv2d_chain": 0, "tk.conv2d_block_stack": 0, "tk.dense_rq": 1,
        "qnn.mul": 53, "qnn.add": 69}
    calls = []
    for mod, attr in ((matmul_int8, "qgemm_rq"), (conv, "qconv_rq"), (conv, "qconv_rq_res")):
        real = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _r=real, _n=attr, **k: (calls.append(_n),
                                                                          _r(*a, **k))[1])
    got = TorchExecutor(q, device="cpu", fuse=True).run([x])
    c = collections.Counter(calls)
    assert c == {"qgemm_rq": 37, "qconv_rq": 17}  # 36 1x1 convs + the dense; 16 3x3 + the stem
    names = computational_nodes(q)
    seen = {}
    j_run_graph(jq, [x], intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    for nm, out in zip(names, TorchExecutor(q, capture=names, device="cpu").run([x])):
        _held(out, seen[nm], f"{nm} ({q[nm].op})")
    for a, b in zip(got, j_run_graph(jq, [x])):
        _held(a, b, "fused")
    for a, b in zip(TorchExecutor(q, device="cpu").run([x]), run_graph_jax(jq, [x])):
        if np.asarray(b).dtype.kind in "iu":
            np.testing.assert_array_equal(a, np.asarray(b))


def test_keras_resnet50_b1_trace_is_the_references_numpy_trace():
    """The b1 32^2 graph (a 1 x 1 map at conv5: its residual adds are
    BiasAdds of the squeezed branch, as Keras writes them), unfused: every
    integer record byte-equal to the JAX package's numpy trace, floats
    within RTOL / ATOL, and verify_trace passes."""
    _tf()
    import tensorflow as tf

    blob = resnet50_keras(1, 32, seed=3)
    ops = collections.Counter(n.op for n in proto.parse_graph_def(blob).node)
    assert (ops["BiasAdd"], ops["AddV2"], ops["Squeeze"]) == (57, 119, 56)
    tgd = tf.compat.v1.GraphDef()
    tgd.ParseFromString(blob)
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    g, jg = from_tf_graphdef(blob), j_tf.from_tf_graphdef(tgd)
    assert g.to_json() == jg.to_json()
    q, jq = quantize(g, [x]), j_quantize(jg, [x])
    assert q.to_json() == jq.to_json()
    blob_t = emit_trace(q, [x], backend="torch", device="cpu")
    want = j_emit_trace(jq, [x], backend="numpy")
    got_recs = list(fmt.TraceReader(io.BytesIO(blob_t)))
    want_recs = list(j_format.TraceReader(io.BytesIO(want)))
    assert len(got_recs) == len(want_recs)
    n_int = 0
    for a, b in zip(got_recs, want_recs):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        if all(t.to_array().dtype.kind in "iub" for t in a.tensors):
            assert a.encode() == b.encode(), a.name
            n_int += 1
            continue
        for ta, tb in zip(a.tensors, b.tensors):
            _held(ta.to_array(), tb.to_array(), a.name)
    assert n_int > 300
    res = verify_trace(blob_t, q)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got_recs)


def test_keras_resnet50_is_seeded_and_sized():
    a = resnet50_keras(1, 32, num_classes=10, seed=1)
    assert a == resnet50_keras(1, 32, num_classes=10, seed=1)
    assert a != resnet50_keras(1, 32, num_classes=10, seed=2)
    g = infer_types(from_tf_graphdef(a))
    assert g.inputs[0].shape == (1, 32, 32, 3) and g[g.outputs[0]].shape == (1, 10)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_runs_and_quantizes_a_pb_as_the_reference(tmp_path, r50):
    """`run model.pb` reads the file with the codec; `quantize model.pb`
    writes the JAX CLI's bytes (which reads it with TensorFlow)."""
    from tachikoma_tpu import cli as j_cli
    from tachikoma_tpu.ir.graph import Graph as JGraph

    path = str(tmp_path / "r50.pb")
    with open(path, "wb") as f:
        f.write(r50["blob"])
    xin, out = str(tmp_path / "x.npy"), str(tmp_path / "y.npz")
    np.save(xin, r50["x"])
    cli_main(["run", path, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    _held(got[got.files[0]], j_run_graph(r50["jg"], [r50["x"]])[0], "cli run")
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    cli_main(["quantize", path, "-o", ours, "--calib-batches", "1"])
    j_cli.main(["quantize", path, "-o", theirs, "--calib-batches", "1"])
    assert open(ours).read() == open(theirs).read()
    cli_main(["run", ours, "--device", "cpu", "--input", xin, "-o", out])
    got = np.load(out)
    _held(got[got.files[0]],
          j_run_graph(JGraph.from_json(open(theirs).read()), [r50["x"]])[0], "cli int8")


def test_cli_reads_keras_files_and_saved_models(tmp_path, capsys):
    tf = _tf()
    L = tf.keras.layers
    m = tf.keras.Sequential([L.Input((8, 8, 3)), L.Conv2D(4, 3), L.Flatten(), L.Dense(5)])
    for name in ("m.keras", "m.h5"):
        path = str(tmp_path / name)
        m.save(path)
        cli_main(["run", path, "--device", "cpu"])
        assert "float32[1, 5]" in capsys.readouterr().out
    sm = str(tmp_path / "sm")
    tf.saved_model.save(m, sm, signatures=tf.function(lambda x: m(x)).get_concrete_function(
        tf.TensorSpec((1, 8, 8, 3), tf.float32)))
    cli_main(["run", sm, "--device", "cpu"])
    assert "float32[1, 5]" in capsys.readouterr().out


def test_cli_names_tensorflow_where_it_is_missing(tmp_path, monkeypatch):
    """Without TensorFlow a .keras / .h5 file or a SavedModel directory
    exits naming it (no silent substitute); a .pb needs none."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "tensorflow" else real(name, *a))
    for target in (tmp_path / "m.keras", tmp_path / "m.h5", tmp_path):
        with pytest.raises(SystemExit, match="TensorFlow, which is not installed"):
            cli_main(["run", str(target), "--device", "cpu"])
    path = tmp_path / "mlp.pb"
    path.write_bytes(_mlp_graphdef().SerializeToString())
    cli_main(["run", str(path), "--device", "cpu"])
