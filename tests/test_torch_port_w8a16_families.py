"""W8A16 beyond the plain CNN on the CPU, against the JAX package: the
int16 x int16 batched product into int64 (`qbmm_wide`, the attention's
scores and context), and the W8A16 convs with a dilation and with groups
(`qconv_wide`'s new modes, `qdwconv_wide` dilated).

  * `qbmm_wide_plain` == the JAX package's oracle (`qnn.batch_matmul`'s
    np_impl, int64) at the int16 extremes, and == `_qbmm_jax` modulo 2^32
    on int16 operands: the JAX package's XLA route sums int16 x int16 in
    int32 (`ops/jax_ops.py _bmm`, preferred_element_type int32) and casts
    to int64 after, so it wraps where the oracle does not (an int8 lhs
    takes its float32 product there, which rounds against an int16 rhs: the
    mixes are held to the oracle alone).
  * `qbmm_wide_model`, the kernel's arithmetic (four byte-plane products in
    three int32 sums, the zero points folded through row and column sums),
    == the oracle, exact at BMM_K_BOUND and refusing past it; the plain
    version refuses past its float64 bound.
  * W8A16 tiny BERT, GPT-2 (causal) and ViT quantize to the JAX package's
    JSON; every node of the port's CPU path equals the JAX package's oracle
    where no float op (gelu, softmax, tanh: `runtime/crosscheck.py
    float_source_set`) reaches it, and inside that set equals the oracle's
    own op on the port's inputs (an ulp of torch's float gelu or softmax
    rounds a few int16 elements of the next qnn.quantize the other way).
    The port's torch trace has those records byte-equal to the JAX
    package's numpy trace and verifies under both packages' verifiers; the
    port's oracle-backend trace is byte-equal to the JAX package's whole.
  * `wide_conv_plain` and `wide_conv_model` dilated, grouped and dilated
    depthwise == `_qconv2d_jax`.
  * A narrow W8A16 DeepLabV3-ResNet-50 (output stride 8, ASPP 12 / 24 /
    36) and ResNeXt-50: every integer node of the port's CPU path == the
    JAX package's oracle.

Every input comes from a seeded numpy generator."""

import dataclasses
import io

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.frontend.onnx import from_onnx as j_from_onnx
from tachikoma_tpu.frontend.torch_fx import from_torch as j_from_torch
from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.ops.jax_ops import _qbmm_jax, _qconv2d_jax
from tachikoma_tpu.quantize.config import W8A16 as J_W8A16
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu.trace.emitter import verify_trace as j_verify_trace
from tachikoma_tpu_torch.frontend import from_onnx
from tachikoma_tpu_torch.frontend.torch_fx import from_torch
from tachikoma_tpu_torch.ir.graph import Node
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.models.onnx_deeplab import FLOAT_OPS, deeplabv3_onnx
from tachikoma_tpu_torch.models.torch_resnet import resnet_torch
from tachikoma_tpu_torch.ops.kernels import wide
from tachikoma_tpu_torch.quantize.config import W8A16
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.crosscheck import _node_inputs, float_source_set
from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

from test_torch_port_transformer import SMALL

I16_MIN, I16_MAX = -2 ** 15, 2 ** 15 - 1
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path in one thread: the suite runs a worker a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, shape, dtype):
    lo, hi = {"int8": (-128, 127), "uint8": (0, 255), "int16": (I16_MIN, I16_MAX)}[dtype]
    x = rng.integers(lo, hi + 1, shape).astype(dtype)
    flat = x.reshape(-1)
    flat[: flat.size // 4] = lo        # a quarter at each extreme
    flat[flat.size // 4: flat.size // 2] = hi
    rng.shuffle(flat)
    return x


# ---------------------------------------------------------------------------
# the batched product
# ---------------------------------------------------------------------------

BMM_CASES = [
    # (a shape, b shape, a dtype, b dtype, lhs zp, rhs zp, transpose_a, transpose_b)
    ((2, 3, 5, 64), (2, 3, 7, 64), "int16", "int16", 0, 0, False, True),     # scores, aligned K
    ((2, 3, 5, 13), (2, 3, 13, 7), "int16", "int16", 0, 0, False, False),    # context, odd K
    ((4, 9, 6), (4, 9, 5), "int16", "int16", 0, 0, True, False),             # transpose_a
    ((9, 6), (4, 5, 9), "int16", "int16", 0, 0, True, True),                 # both, broadcast
    ((1, 4, 6, 33), (3, 1, 33, 5), "int16", "int16", 0, 0, False, False),    # batches broadcast
    ((2, 7, 40), (2, 40, 3), "int16", "int16", -300, 12345, False, False),   # zero points
    ((2, 7, 40), (2, 3, 40), "int8", "int16", -128, 0, False, True),         # int8 x int16
    ((2, 7, 40), (2, 40, 3), "int16", "int8", 5, -7, False, False),          # int16 x int8
    ((3, 8, 17), (3, 17, 9), "uint8", "int8", 128, -128, False, False),      # uint8 x int8
    ((1, 3, 197), (1, 197, 4), "int16", "int16", I16_MIN, I16_MAX, False, False),  # ViT's S
]


@pytest.mark.parametrize("ash,bsh,adt,bdt,za,zb,ta,tb", BMM_CASES)
def test_qbmm_wide_plain_and_model_equal_the_reference(ash, bsh, adt, bdt, za, zb, ta, tb):
    rng = np.random.default_rng(sum(ash) + sum(bsh))
    a, b = _ints(rng, ash, adt), _ints(rng, bsh, bdt)
    attrs = dict(lhs_zero_point=za, rhs_zero_point=zb, transpose_a=ta, transpose_b=tb,
                 out_dtype="int64")
    jnode = JNode("bmm", "qnn.batch_matmul", ("a", "b"), attrs)
    want = j_get_op("qnn.batch_matmul").np_impl(a, b, node=jnode)
    assert want.dtype == np.int64
    kw = dict(lhs_zero_point=za, rhs_zero_point=zb, transpose_a=ta, transpose_b=tb)
    ta_, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    for fn in (wide.qbmm_wide_plain, wide.qbmm_wide, wide.qbmm_wide_model):
        got = fn(ta_, tb_, **kw).numpy()
        assert got.dtype == np.int64 and got.shape == want.shape, fn.__name__
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)
    node = Node("bmm", "qnn.batch_matmul", ("a", "b"), attrs)
    np.testing.assert_array_equal(
        get_op("qnn.batch_matmul").torch_impl(ta_, tb_, node=node).numpy(), want)
    if adt == bdt == "int16":  # XLA sums in int32 and casts after: equal modulo 2^32
        jax_out = np.asarray(_qbmm_jax(a, b, node=jnode)).astype(np.int64)
        assert ((jax_out - want) % 2 ** 32 == 0).all()


def test_qbmm_wide_bounds():
    """The model is exact at BMM_K_BOUND with every middle term at its
    extreme (a = b = -128 * 256 + 255: hi -128, lo 255) and raises one k
    past it, as the kernel's launch does; the plain version raises past its
    float64 bound; int16 zero points only."""
    k = wide.BMM_K_BOUND
    assert k == 32_896
    a = torch.full((1, 2, k), -128 * 256 + 255, dtype=torch.int16)
    b = torch.full((1, k, 3), -128 * 256 + 255, dtype=torch.int16)
    want = k * (-128 * 256 + 255) ** 2
    assert (wide.qbmm_wide_model(a, b) == want).all()
    assert (wide.qbmm_wide_plain(a, b) == want).all()
    a1, b1 = torch.cat([a, a[..., :1]], -1), torch.cat([b, b[:, :1]], 1)
    with pytest.raises(ValueError, match="above 32896"):
        wide.qbmm_wide_model(a1, b1)
    with pytest.raises(ValueError, match="above 32896"):
        wide._bmm_wide_launch(a1, b1, 0, 0, False, False)
    deep = torch.zeros((1, 1, wide.EXACT_F64_BMM_K), dtype=torch.int16)
    with pytest.raises(ValueError, match="qbmm_wide_plain: K 2097152"):
        wide.qbmm_wide_plain(deep, deep, transpose_b=True)
    with pytest.raises(ValueError, match="not an int16 value"):
        wide.qbmm_wide_plain(a[..., :4], b[:, :4], lhs_zero_point=40000)
    with pytest.raises(NotImplementedError, match="int8, uint8 or int16"):
        wide.qbmm_wide(a.to(torch.int32), b)
    with pytest.raises(NotImplementedError, match="out_dtype int16 is not ported"):
        get_op("qnn.batch_matmul").torch_impl(
            a[..., :4], b[:, :4], node=Node("bmm", "qnn.batch_matmul", ("a", "b"),
                                            dict(out_dtype="int16")))


def test_qbmm_wide_launch_reads_views_in_place():
    """The launch's operands and modes at BERT's head-split views and ViT's
    197-element rows: q and k read in place (k contiguous in K), v by rows,
    the softmax output unaligned; no operand is copied."""
    d, s = 64, 197
    qkv = torch.zeros((1, s, 3, 4, d), dtype=torch.int16)   # (B, S, 3, H, D)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, S, D)
    _, A, B, p = wide._bmm_wide_launch(q, k, 0, 0, False, True)
    assert A.data_ptr() == q.data_ptr() and B.data_ptr() == k.data_ptr()
    modes = {v: key for key, v in wide.BMM_WIDE_STAGES.items()}
    assert (modes[p["a_mode"]], modes[p["b_mode"]]) == ("kmajor8", "kmajor8")
    assert (p["a_sk"], p["b_sk"], p["bmm_nb"]) == (1, 1, 4)
    probs = torch.zeros((1, 4, s, s), dtype=torch.int16)
    _, A, B, p = wide._bmm_wide_launch(probs, v, 0, 0, False, False)
    assert B.data_ptr() == v.data_ptr() and (p["b_sn"], p["b_sk"]) == (1, 3 * 4 * d)
    assert (modes[p["a_mode"]], modes[p["b_mode"]]) == ("kmajor", "rows")


# ---------------------------------------------------------------------------
# dilated and grouped convs into int64
# ---------------------------------------------------------------------------

GEOMETRY_CONVS = [
    # (x shape, weight shape, strides, padding, dilation, groups, izp)
    ((1, 13, 13, 16), (3, 3, 16, 8), (1, 1), (2, 2, 2, 2), (2, 2), 1, 0),          # layer3 d2
    ((1, 13, 13, 16), (3, 3, 16, 8), (1, 1), (12,) * 4, (12, 12), 1, -300),       # ASPP d12
    ((1, 9, 11, 8), (3, 3, 8, 16), (2, 2), (4, 3, 4, 3), (4, 3), 1, 32767),       # d4 x d3 s2
    ((2, 8, 8, 16), (3, 3, 4, 16), (1, 1), (1, 1, 1, 1), (1, 1), 4, -32768),      # ResNeXt
    ((2, 8, 8, 32), (3, 3, 4, 32), (2, 2), (1, 1, 1, 1), (1, 1), 8, 7),           # s2 grouped
    ((1, 7, 7, 12), (1, 1, 6, 24), (1, 1), (0, 0, 0, 0), (1, 1), 2, 1),           # 1x1 grouped
    ((1, 9, 9, 16), (3, 3, 2, 16), (1, 1), (2, 2, 2, 2), (2, 2), 8, -5),          # dilated grouped
    ((1, 9, 9, 8), (3, 3, 1, 8), (1, 1), (2, 2, 2, 2), (2, 2), 8, 0),             # atrous dw d2
    ((1, 9, 9, 8), (3, 3, 1, 8), (1, 1), (4, 4, 4, 4), (4, 4), 8, -12345),        # atrous dw d4
    ((1, 8, 8, 4), (3, 3, 1, 8), (1, 1), (1, 1, 1, 1), (1, 1), 4, 3),             # multiplier 2
]


@pytest.mark.parametrize("xs,ws,strides,padding,dilation,groups,izp", GEOMETRY_CONVS)
def test_dilated_and_grouped_int64_convs_equal_the_reference(xs, ws, strides, padding,
                                                             dilation, groups, izp):
    rng = np.random.default_rng(sum(xs) + sum(ws) + groups)
    x, w = _ints(rng, xs, "int16"), _ints(rng, ws, "int8")
    attrs = dict(strides=strides, padding=padding, dilation=dilation, groups=groups,
                 input_zero_point=izp, kernel_zero_point=0, out_dtype="int64")
    want = np.asarray(_qconv2d_jax(x, w, node=JNode("c", "qnn.conv2d", ("d", "w"), attrs)))
    oracle = j_get_op("qnn.conv2d").np_impl(x, w, node=JNode("c", "qnn.conv2d", ("d", "w"),
                                                               attrs))
    np.testing.assert_array_equal(want, oracle)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    kw = dict(strides=strides, padding=padding, dilation=dilation, groups=groups, izp=izp)
    for fn in (wide.wide_conv_plain, wide.wide_conv, wide.wide_conv_model):
        got = fn(tx, tw, **kw).numpy()
        assert got.dtype == np.int64, fn.__name__
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)
    node = Node("c", "qnn.conv2d", ("d", "w"), attrs)
    np.testing.assert_array_equal(get_op("qnn.conv2d").torch_impl(tx, tw, node=node).numpy(),
                                  want)
    kernel = wide.qdwconv_wide if wide._is_depthwise(xs, ws, groups) else wide.qconv_wide
    kw.pop("groups") if kernel is wide.qdwconv_wide else None
    np.testing.assert_array_equal(kernel(tx, tw, **kw).numpy(), want)


def test_grouped_plan_keeps_a_tile_in_one_super_group():
    """A grouped qconv_wide call runs at GROUPED_BN columns, its super-group
    of `group_span` groups a whole number of tiles (ResNeXt-50's 32 groups
    of 4 / 8 / 16 / 32 output channels: 16 / 8 / 4 / 2 groups a tile)."""
    from tachikoma_tpu_torch.ops.kernels.conv import group_span

    for cout_g, span in ((4, 16), (8, 8), (16, 4), (32, 2)):
        assert group_span(32, cout_g, wide.GROUPED_BN) == span
        plan = wide.wide_plan(8 * 28 * 28, 9 * span * cout_g, 32 * cout_g, 132,
                              wide.GROUPED_BN)
        assert plan["bn"] == wide.GROUPED_BN and span * cout_g % plan["bn"] == 0


# ---------------------------------------------------------------------------
# W8A16 transformers
# ---------------------------------------------------------------------------

def _transformer_input(name, kw, rng):
    if name == "vit":
        return rng.standard_normal((kw["batch_size"], kw["image_size"], kw["image_size"],
                                    3)).astype(np.float32)
    return rng.integers(0, kw["vocab"], (kw["batch_size"], kw["seq_len"])).astype(np.int32)


@pytest.fixture(scope="module", params=["bert", "gpt2", "vit"])
def w8a16_transformer(request):
    name, kw = request.param, SMALL[request.param]
    rng = np.random.default_rng(kw["seed"])
    calib, x = (_transformer_input(name, kw, rng) for _ in range(2))
    q = quantize(getattr(pt, name)(**kw), [calib], W8A16)
    jq = j_quantize(getattr(jt, name)(**kw), [calib], config=J_W8A16)
    return name, q, jq, x


def _oracle_nodes(graph, x):
    seen = {}
    j_run_graph(graph, x, intercept=lambda nm, op, args, out: seen.__setitem__(nm, out))
    return seen


def test_w8a16_transformer_every_node_equals_the_reference(w8a16_transformer):
    name, q, jq, x = w8a16_transformer
    assert q.to_json() == jq.to_json()
    bmm = [n for n in q.nodes if n.op == "qnn.batch_matmul"]
    assert len(bmm) == 2 * {"bert": 2, "gpt2": 3, "vit": 2}[name]
    assert all(n.dtype == "int64" and q[n.inputs[0]].dtype == "int16" for n in bmm)
    names = computational_nodes(q)
    got = dict(zip(names, TorchExecutor(q, capture=names, device="cpu").run(x)))
    want = _oracle_nodes(jq, x)
    cone = float_source_set(q)
    feeds = {q.inputs[0].name: x}
    held = {"int": 0, "cone": 0}
    for nm in names:
        a, b, node = got[nm], np.asarray(want[nm]), q[nm]
        assert a.dtype == b.dtype and a.shape == b.shape, nm
        if nm not in cone:
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b, err_msg=f"{nm} ({node.op})")
                held["int"] += 1
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=nm)
            continue
        # reached by a float op: the oracle's op on the port's own inputs
        args = [v.numpy() for v in _node_inputs(q, node, got, feeds)]
        own = j_get_op(node.op).np_impl(*args, node=jq[nm])
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, own, err_msg=f"{nm} ({node.op})")
            held["cone"] += 1
        else:
            np.testing.assert_allclose(a, own, rtol=RTOL, atol=ATOL, err_msg=nm)
    # the first scores product lies outside the set and is held end to end
    assert bmm[0].name not in cone and held["int"] > 10 and held["cone"] > 10


def test_w8a16_bert_jax_executor_wraps_its_products_in_int32():
    """The JAX package's XLA route (JaxExecutor) sums qnn.batch_matmul's
    int16 operands in int32: its first scores product equals the oracle's
    int64 modulo 2^32, and every node before it equals the oracle and the
    port's CPU path."""
    kw = SMALL["bert"]
    rng = np.random.default_rng(kw["seed"])
    calib, x = (_transformer_input("bert", kw, rng) for _ in range(2))
    q = quantize(pt.bert(**kw), [calib], W8A16)
    jq = j_quantize(jt.bert(**kw), [calib], config=J_W8A16)
    names = computational_nodes(q)
    first = next(n.name for n in q.nodes if n.op == "qnn.batch_matmul")
    upto = names[:names.index(first) + 1]
    jx = dict(zip(upto, JaxExecutor(jq, capture=upto, fuse=False).run(x)))
    own = dict(zip(upto, TorchExecutor(q, capture=upto, device="cpu").run(x)))
    want = _oracle_nodes(jq, x)
    for nm in upto[:-1]:
        if own[nm].dtype.kind in "iu":
            np.testing.assert_array_equal(np.asarray(jx[nm]), own[nm], err_msg=nm)
    np.testing.assert_array_equal(own[first], want[first])
    assert ((np.asarray(jx[first]).astype(np.int64) - want[first]) % 2 ** 32 == 0).all()


def test_w8a16_transformer_traces(w8a16_transformer):
    """The port's torch trace: every record outside the float-source set
    byte-equal to the JAX package's numpy trace; every record verified by
    both packages' verifiers (each re-runs the record's op on its own
    inputs).  The port's oracle-backend trace: byte-equal to the JAX
    package's whole."""
    _, q, jq, x = w8a16_transformer
    blob = emit_trace(q, x, backend="torch", device="cpu")
    want = j_emit_trace(jq, x, backend="numpy")
    assert emit_trace(q, x, backend="oracle") == want
    cone = float_source_set(q)
    got_recs = list(fmt.TraceReader(io.BytesIO(blob)))
    want_recs = list(j_format.TraceReader(io.BytesIO(want)))
    assert [r.name for r in got_recs] == [r.name for r in want_recs]
    dtypes = set()
    for a, b in zip(got_recs, want_recs):
        dtypes |= {t.dtype for t in a.tensors}
        if a.name not in cone:
            assert a.encode() == b.encode(), a.name
    assert {"int16", "int64"} <= dtypes
    res = verify_trace(blob, q)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got_recs)
    res = j_verify_trace(blob, jq)
    assert res["mismatches"] == [] and res["verified"] == res["records"] == len(got_recs)


# ---------------------------------------------------------------------------
# narrow W8A16 DeepLabV3 and ResNeXt
# ---------------------------------------------------------------------------

DEEPLAB_NARROW = dict(layers=(1, 1, 1, 2), width=8, aspp_channels=16)
DEEPLAB_SIDE = 56   # 7^2 maps at output stride 8: layer4's d2 / d4 taps inside, the ASPP's beyond
RESNEXT_NARROW = dict(layers=(1, 1, 1, 1), planes=(16, 32, 64, 128), groups=4,
                      width_per_group=16, num_classes=10, probe_size=32)
RESNEXT_SHAPE = (1, 3, 32, 32)


def _geometry(graph):
    return sorted({(tuple(n.attrs.get("dilation", (1, 1)))[0], int(n.attrs.get("groups", 1)))
                   for n in graph.nodes if n.op == "qnn.conv2d" and n.dtype == "int64"})


@pytest.mark.parametrize("model", ["deeplab", "resnext"])
def test_w8a16_dilated_and_grouped_models_every_integer_node(model):
    rng = np.random.default_rng(5)
    if model == "deeplab":
        shape = (1, 3, DEEPLAB_SIDE, DEEPLAB_SIDE)
        blob = deeplabv3_onnx(1, DEEPLAB_SIDE, **DEEPLAB_NARROW)
        g, jg = from_onnx(blob), j_from_onnx(blob)
        config = dataclasses.replace(W8A16, float_ops=FLOAT_OPS)
        jconfig = dataclasses.replace(J_W8A16, float_ops=frozenset(FLOAT_OPS))
        geometry = [(1, 1), (2, 1), (4, 1), (12, 1), (24, 1), (36, 1)]
    else:
        shape = RESNEXT_SHAPE
        m = resnet_torch(**RESNEXT_NARROW)
        g, jg = from_torch(m, {"x": shape}), j_from_torch(m, {"x": shape})
        config, jconfig = W8A16, J_W8A16
        geometry = [(1, 1), (1, 4)]
    calib, x = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q, jq = quantize(g, [calib], config), j_quantize(jg, [calib], config=jconfig)
    assert q.to_json() == jq.to_json()
    assert _geometry(q) == geometry
    names = computational_nodes(q)
    got = TorchExecutor(q, capture=names, device="cpu").run(x)
    want = _oracle_nodes(jq, x)
    n_int = 0
    for nm, a in zip(names, got):
        b = np.asarray(want[nm])
        assert a.dtype == b.dtype and a.shape == b.shape, nm
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{nm} ({q[nm].op})")
            n_int += 1
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5, err_msg=nm)
    assert n_int > 20
