"""The dynamic-shape, control-flow and training cases shared by
tests/test_torch_port_dyn.py, test_torch_port_control_flow.py and
test_torch_port_qat.py (the port against the JAX package on the CPU),
tests/test_torch_port_cuda.py and chip_smoke.py phase 24 (the port on the
card against its CPU path).  It imports neither jax nor the JAX package: a
builder takes the package's GraphBuilder (or Node), Graph and infer_types
as arguments.

- CASES: (id, build(GraphBuilder), feeds), the graphs and feeds of
  tests/test_dyn.py, one per dyn.* op and a few more, covering all 17;
- with_topk_head: a quantized classifier with a dyn.topk head on the int8
  logits its qnn.dequantize reads, k an int32 input;
- cond_heads / while_blocks: tk.cond choosing between two int8 heads
  (qnn.dense then qnn.requantize) and tk.while_loop applying an int8 block
  (qnn.dense, qnn.requantize, clip) n times, weights from a seed;
- with_cross_entropy: a float classifier's softmax replaced by a
  log_softmax and nn.cross_entropy_with_logits against a labels input, the
  scalar loss quantization-aware training descends; one_hot_labels.
"""

import numpy as np


def i32(v):
    return np.asarray(v, np.int32)


def f32(v):
    return np.asarray(v, np.float32)


def rand_f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the 17 dyn.* ops (tests/test_dyn.py's graphs and feeds) and a chain
# ---------------------------------------------------------------------------

def one_op(op, vars_, attrs=None, outputs=1):
    """A graph of one dyn op over `vars_` ((name, shape, dtype), ...); with
    two outputs each is taken by tuple_get_item."""
    def build(B):
        b = B("d")
        names = [b.var(n, s, d) for n, s, d in vars_]
        y = b.call(op, *names, name="d0", **(attrs or {}))
        if outputs == 1:
            return b.build([y])
        return b.build([b.call("tuple_get_item", y, index=i, name=f"o{i}")
                        for i in range(outputs)])
    return build


def _chain(B):
    b = B("dmix")
    x = b.var("x", (2, 6), "float32")
    s = b.var("shape", (2,), "int32")
    r = b.var("reps", (2,), "int32")
    y = b.call("dyn.reshape", x, s, name="r0")
    return b.build([b.call("abs", b.call("dyn.tile", y, r, name="t0"), name="out")])


_NZ = ((np.random.default_rng(0).random((4, 6)) < 0.3).astype(np.int32)
       * np.random.default_rng(1).integers(1, 9, (4, 6)).astype(np.int32))
_X26 = np.arange(6, dtype=np.float32).reshape(2, 3)

# (id, build, feeds)
CASES = [
    ("nonzero", one_op("dyn.nonzero", [("x", (4, 6), "int32")], {"max_count": 16}, 2),
     {"x": _NZ}),
    ("nonzero_overflow", one_op("dyn.nonzero", [("x", (8,), "int32")], {"max_count": 3}, 2),
     {"x": np.ones(8, np.int32)}),
    ("nonzero_3d_bool", one_op("dyn.nonzero", [("x", (2, 3, 4), "bool")], {"max_count": 30}, 2),
     {"x": np.random.default_rng(2).random((2, 3, 4)) < 0.5}),
    ("reshape", one_op("dyn.reshape", [("x", (2, 12), "float32"), ("shape", (3,), "int32")]),
     {"x": np.arange(24, dtype=np.float32).reshape(2, 12), "shape": i32([4, 3, 2])}),
    ("tile", one_op("dyn.tile", [("x", (2, 3), "float32"), ("reps", (2,), "int32")]),
     {"x": _X26, "reps": i32([2, 3])}),
    ("broadcast_to", one_op("dyn.broadcast_to", [("x", (1, 4), "int32"), ("shape", (3,), "int32")]),
     {"x": np.arange(4, dtype=np.int32).reshape(1, 4), "shape": i32([2, 5, 4])}),
    ("full", one_op("dyn.full", [("fill", (1,), "float32"), ("shape", (2,), "int32")]),
     {"fill": f32([2.5]), "shape": i32([3, 4])}),
    ("one_hot", one_op("dyn.one_hot", [("idx", (5,), "int32"), ("depth", (1,), "int32")],
                     {"on_value": 1, "off_value": 0, "dtype": "int32"}),
     {"idx": i32([0, 2, 3, -1, 9]), "depth": i32([4])}),
    ("strided_slice", one_op("dyn.strided_slice", [("x", (6, 8), "float32"), ("begin", (2,), "int32"),
                                                 ("end", (2,), "int32"),
                                                 ("strides", (2,), "int32")]),
     {"x": np.arange(48, dtype=np.float32).reshape(6, 8), "begin": i32([1, 0]),
      "end": i32([5, 8]), "strides": i32([2, 3])}),
    ("topk", one_op("dyn.topk", [("x", (3, 7), "float32"), ("k", (1,), "int32")],
                  {"ret_type": "both"}, 2),
     {"x": rand_f32((3, 7), 0), "k": i32([3])}),
    ("topk_int8_values", one_op("dyn.topk", [("x", (2, 9), "int8"), ("k", (1,), "int32")],
                              {"ret_type": "values", "axis": 1}),
     {"x": np.array([[3, -128, 5, 5, 127, -1, 0, -128, 9]] * 2, np.int8), "k": i32([4])}),
    ("ones", one_op("dyn.ones", [("shape", (2,), "int32")], {"dtype": "int8"}),
     {"shape": i32([2, 5])}),
    ("zeros", one_op("dyn.zeros", [("shape", (2,), "int32")], {"dtype": "int8"}),
     {"shape": i32([2, 5])}),
    ("expand_dims", one_op("dyn.expand_dims", [("x", (2, 3), "float32"), ("axis", (1,), "int32")]),
     {"x": _X26, "axis": i32([1])}),
    ("squeeze", one_op("dyn.squeeze", [("x", (2, 1, 3, 1), "float32"), ("axes", (2,), "int32")]),
     {"x": _X26.reshape(2, 1, 3, 1), "axes": i32([1, 3])}),
    ("sparse_to_dense", one_op("dyn.sparse_to_dense", [("idx", (3, 2), "int32"),
                                                     ("vals", (3,), "float32"),
                                                     ("dflt", (), "float32"),
                                                     ("oshape", (2,), "int32")]),
     {"idx": i32([[0, 0], [1, 2], [2, 3]]), "vals": f32([1., 2., 3.]),
      "dflt": np.asarray(-1., np.float32), "oshape": i32([3, 4])}),
    ("nn_pad", one_op("dyn.nn.pad", [("x", (2, 3), "int32"), ("pw", (2, 2), "int32"),
                                   ("pv", (), "int32")]),
     {"x": np.arange(6, dtype=np.int32).reshape(2, 3), "pw": i32([[1, 0], [2, 1]]),
      "pv": np.asarray(7, np.int32)}),
    ("nn_upsampling", one_op("dyn.nn.upsampling", [("x", (1, 2, 3, 4), "float32"),
                                                 ("sh", (), "float32"), ("sw", (), "float32")]),
     {"x": rand_f32((1, 2, 3, 4), 0), "sh": np.asarray(2.0, np.float32),
      "sw": np.asarray(3.0, np.float32)}),
    ("nn_upsampling3d", one_op("dyn.nn.upsampling3d", [("x", (1, 2, 2, 3, 4), "float32"),
                                                     ("sd", (), "float32"), ("sh", (), "float32"),
                                                     ("sw", (), "float32")]),
     {"x": rand_f32((1, 2, 2, 3, 4), 1), "sd": np.asarray(2.0, np.float32),
      "sh": np.asarray(2.0, np.float32), "sw": np.asarray(1.0, np.float32)}),
    ("image_resize2d", one_op("dyn.image.resize2d", [("x", (1, 4, 4, 2), "float32"),
                                                   ("size", (2,), "int32")],
                            {"method": "nearest_neighbor"}),
     {"x": rand_f32((1, 4, 4, 2), 1), "size": i32([8, 8])}),
    ("reshape_then_tile", _chain,
     {"x": np.arange(12, dtype=np.float32).reshape(2, 6), "shape": i32([3, 4]),
      "reps": i32([2, 1])}),
]
DYN_OPS = {"dyn.nonzero", "dyn.reshape", "dyn.tile", "dyn.broadcast_to", "dyn.full",
           "dyn.one_hot", "dyn.strided_slice", "dyn.topk", "dyn.ones", "dyn.zeros",
           "dyn.expand_dims", "dyn.squeeze", "dyn.sparse_to_dense", "dyn.nn.pad",
           "dyn.nn.upsampling", "dyn.nn.upsampling3d", "dyn.image.resize2d"}


# ---------------------------------------------------------------------------
# a dyn.topk head on a quantized classifier
# ---------------------------------------------------------------------------

def with_topk_head(q, node_cls, graph_cls, k_name="k"):
    """`q` with a dyn.topk (axis -1, ret_type both) on the int8 logits that
    its qnn.dequantize reads, k an int32 (1,) input named `k_name`; its
    outputs: q's, then the values ("head_values") and the indices
    ("head_indices")."""
    deq = next(n for n in q.nodes if n.op == "qnn.dequantize")
    nodes = [*q.nodes,
             node_cls(k_name, "var", shape=(1,), dtype="int32"),
             node_cls("head_topk", "dyn.topk", (deq.inputs[0], k_name),
                      {"axis": -1, "ret_type": "both"}),
             node_cls("head_values", "tuple_get_item", ("head_topk",), {"index": 0}),
             node_cls("head_indices", "tuple_get_item", ("head_topk",), {"index": 1})]
    return graph_cls(nodes, [*q.outputs, "head_values", "head_indices"], dict(q.params),
                     q.name)


# ---------------------------------------------------------------------------
# control flow over int8 features
# ---------------------------------------------------------------------------

def _subgraph(builder, graph_cls, infer_types, outs) -> str:
    # no dead-code elimination: a loop's cond and body keep every state var
    g = graph_cls(list(builder.nodes), list(outs), dict(builder.params), builder.name)
    return infer_types(g).to_json()


def _int8_dense(b, x, w, name, features):
    """qnn.dense (int32) then qnn.requantize to int8: an int8 layer."""
    acc = b.call("qnn.dense", x, b.const(w, name=f"{name}_w"), input_zero_point=0,
                 kernel_zero_point=0, out_dtype="int32", name=f"{name}_dense")
    return b.call("qnn.requantize", acc, input_scale=1.0, input_zero_point=0,
                  output_scale=float(64 * np.sqrt(features)), output_zero_point=0,
                  out_dtype="int8", name=f"{name}_rq")


def cond_heads(builder_cls, graph_cls, infer_types, batch, features, classes, seed=0):
    """tk.cond on a bool flag ("flag", a scalar input) between two int8
    heads over the int8 "features" (batch, features): each a qnn.dense to
    `classes` then a qnn.requantize, weights from `seed`."""
    rng = np.random.default_rng(seed)

    def head(tag):
        w = rng.integers(-64, 64, (features, classes)).astype(np.int8)
        b = builder_cls(f"head_{tag}")
        a = b.var("a", (batch, features), "int8")
        return _subgraph(b, graph_cls, infer_types, [_int8_dense(b, a, w, tag, features)])

    b = builder_cls("cond_heads")
    p = b.var("flag", (), "bool")
    x = b.var("features", (batch, features), "int8")
    out = b.call("tk.cond", p, x, then_graph=head("a"), else_graph=head("b"), name="head")
    return infer_types(b.build([out]))


def while_blocks(builder_cls, graph_cls, infer_types, batch, features, seed=0):
    """tk.while_loop over the state (counter "i", bound "n", int8
    "features"): while i < n, i += 1 and the features go through an int8
    block (qnn.dense features -> features, qnn.requantize, clip to [0,
    127]), weights from `seed`; outputs the final counter and features."""
    w = np.random.default_rng(seed).integers(-64, 64, (features, features)).astype(np.int8)

    def state(b):
        return (b.var("i", (), "int32"), b.var("n", (), "int32"),
                b.var("x", (batch, features), "int8"))

    c = builder_cls("loop_cond")
    i, n, _ = state(c)
    cond_j = _subgraph(c, graph_cls, infer_types, [c.call("less", i, n, name="go")])
    bb = builder_cls("loop_body")
    i, n, x = state(bb)
    ni = bb.call("add", i, bb.const(np.int32(1), name="one"), name="next_i")
    nx = bb.call("clip", _int8_dense(bb, x, w, "block", features), a_min=0, a_max=127,
                 name="next_x")
    body_j = _subgraph(bb, graph_cls, infer_types, [ni, n, nx])

    b = builder_cls("while_blocks")
    i0, n0, x0 = b.var("i0", (), "int32"), b.var("n", (), "int32"), \
        b.var("features", (batch, features), "int8")
    loop = b.call("tk.while_loop", i0, n0, x0, cond_graph=cond_j, body_graph=body_j,
                  name="loop")
    outs = [b.call("tuple_get_item", loop, index=0, name="count"),
            b.call("tuple_get_item", loop, index=2, name="out")]
    return infer_types(b.build(outs))


# ---------------------------------------------------------------------------
# a training loss on a float classifier
# ---------------------------------------------------------------------------

def with_cross_entropy(g, node_cls, graph_cls, labels="labels"):
    """`g` (one output, a nn.softmax of the logits) with the softmax
    replaced by "log_probs" = nn.log_softmax(logits) and the output by the
    scalar "loss" = nn.cross_entropy_with_logits(log_probs, labels), labels
    a float32 (batch, classes) input."""
    sm = g[g.outputs[0]]
    assert sm.op == "nn.softmax", sm.op
    shape = g[sm.inputs[0]].shape
    nodes = [n for n in g.nodes if n.name != sm.name]
    nodes += [node_cls(labels, "var", shape=tuple(shape), dtype="float32"),
              node_cls("log_probs", "nn.log_softmax", (sm.inputs[0],), {"axis": -1}),
              node_cls("loss", "nn.cross_entropy_with_logits", ("log_probs", labels))]
    return graph_cls(nodes, ["loss"], dict(g.params), g.name)


def one_hot_labels(batch, classes, seed=0):
    """(batch, classes) float32 one-hot rows of classes drawn from `seed`."""
    cls = np.random.default_rng(seed).integers(0, classes, batch)
    return np.eye(classes, dtype=np.float32)[cls]
