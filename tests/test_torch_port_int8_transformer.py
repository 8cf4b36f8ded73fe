"""The int8 transformer set of the port on the CPU, against the JAX package.

Each op case runs as a one-op graph in both packages on the same numpy
inputs (made from a seed): the port's type relation, its numpy oracle and
its torch impl (`TorchExecutor(device="cpu")`, the kernels' plain versions)
equal the JAX package's oracle and `JaxExecutor`, compared with `==`.  The
four simplify passes that the port gained give the JAX package's JSON on a
graph where each fires.  Tiny BERT, GPT-2 and ViT quantize (TRANSFORMER_INT8
and the default QConfig) and fuse to the JAX package's graphs, every integer
node of the port's executor equals the JAX package's oracle, and the tiny
int8 BERT's unfused trace is byte-equal to the JAX package's and verified by
its verifier.  K1's batched mode (`qbmm_rq` / `qbmm_raw`) is held on the CPU
by emulating the kernel's reads through the strides its launch computes."""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir import transforms as jtr
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.ops import qnn as jqnn
from tachikoma_tpu.quantize.config import TRANSFORMER_INT8 as J_TRANSFORMER_INT8
from tachikoma_tpu.quantize.config import QConfig as JQConfig
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu.trace.emitter import verify_trace as j_verify_trace
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.ir import transforms as ptr
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.ops import qnn as pqnn
from tachikoma_tpu_torch.ops.kernels import matmul_int8 as mm
from tachikoma_tpu_torch.ops.kernels._lib import LAUNCHES
from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8, QConfig
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace.emitter import emit_trace

from test_torch_port_transformer import SMALL


def _i8(shape, seed, lo=-128, hi=128):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int8)


def _one_op(builder, infer, op, inputs, attrs):
    b = builder("t")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    return infer(b.build(b.call(op, *names, name="y", **attrs)))


def _check_op(op, inputs, attrs):
    """The port's relation, oracle and torch impl against the JAX package's
    oracle and JaxExecutor, with ==."""
    g = _one_op(GraphBuilder, infer_types, op, inputs, attrs)
    jg = _one_op(JGraphBuilder, j_infer_types, op, inputs, attrs)
    assert (g["y"].shape, g["y"].dtype) == (jg["y"].shape, jg["y"].dtype)
    feeds = {f"x{i}": x for i, x in enumerate(inputs)}
    want = j_run_graph(jg, feeds)[0]
    got = {"oracle": run_graph(g, feeds)[0],
           "torch": TorchExecutor(g, device="cpu", fuse=False).run(feeds)[0],
           "jax": np.asarray(JaxExecutor(jg, fuse=False).run(feeds)[0])}
    for key, v in got.items():
        assert v.dtype == want.dtype and v.shape == want.shape, key
        assert (v == want).all(), f"{op} {key}: {np.argwhere(v != want)[:4].tolist()}"
    return want


def _softmax_rows():
    x = _i8((2, 3, 17), 1)
    x[0, 0] = 9                    # a row of equal values
    x[0, 1] = -100
    x[0, 1, 5] = 127               # one dominant value
    x[1, 2, :8] = 127              # ties at the maximum
    return x


def _ln_attrs(n, seed, izp=0, negative_gamma=False):
    r = np.random.default_rng(seed)
    gamma = r.uniform(0.5, 1.5, n)
    if negative_gamma:
        gamma[::3] *= -1
    return {**jqnn.plan_layer_norm(gamma, r.normal(0, 0.3, n), 0.05, izp, 0.02, 3, n),
            "out_dtype": "int8"}


def _ln_input(shape, seed):
    x = _i8(shape, seed)
    x[0, 0] = 7                    # zero variance
    return x


_S = 197  # ViT-B/16's sequence


# (id, op, inputs, attrs)
OP_CASES = [
    ("softmax", "qnn.softmax", [_softmax_rows()], {"input_scale": 0.05, "axis": -1}),
    ("softmax_axis1_coarse", "qnn.softmax", [_softmax_rows()], {"input_scale": 0.7, "axis": 1}),
    ("softmax_fine_scale", "qnn.softmax", [_i8((4, 33), 2, -20, 20)], {"input_scale": 0.004}),
    ("lut", "qnn.lut", [np.arange(-128, 128, dtype=np.int8).reshape(4, 64)],
     {"table": _i8((256,), 3).tolist(), "out_dtype": "int8"}),
    ("layer_norm_k1_0", "qnn.layer_norm", [_ln_input((3, 5, 8), 4)], _ln_attrs(8, 5)),
    ("layer_norm_k1_pos", "qnn.layer_norm", [_ln_input((2, 4, 64), 6)], _ln_attrs(64, 7, izp=-3)),
    ("layer_norm_neg_gamma", "qnn.layer_norm", [_ln_input((2, 3, 768), 8)],
     _ln_attrs(768, 9, izp=5, negative_gamma=True)),
    ("bmm_scores", "qnn.batch_matmul", [_i8((2, 3, 16, 8), 10), _i8((2, 3, 16, 8), 11)],
     {"transpose_b": True, "out_dtype": "int32"}),
    ("bmm_ctx_za", "qnn.batch_matmul", [_i8((2, 3, 16, 16), 12), _i8((2, 3, 16, 8), 13)],
     {"lhs_zero_point": -128, "out_dtype": "int32"}),
    ("bmm_zb_both_t", "qnn.batch_matmul", [_i8((3, 9, 5), 14), _i8((3, 7, 9), 15)],
     {"lhs_zero_point": 11, "rhs_zero_point": -7, "transpose_a": True, "transpose_b": True,
      "out_dtype": "int32"}),
    ("bmm_broadcast", "qnn.batch_matmul", [_i8((2, 1, 6, 5), 16), _i8((1, 3, 5, 4), 17)],
     {"lhs_zero_point": -128, "rhs_zero_point": 3, "out_dtype": "int32"}),
    ("bmm_ragged_197", "qnn.batch_matmul", [_i8((1, 2, _S, _S), 18), _i8((1, 2, _S, 64), 19)],
     {"lhs_zero_point": -128, "out_dtype": "int32"}),
    ("attention", "qnn.attention", [_i8((1, 2, 8, 16), 20, -20, 20), _i8((1, 2, 8, 16), 21, -20, 20),
                                    _i8((1, 2, 8, 16), 22)],
     {"scores_scale": 0.01, "v_scale": 0.02, "output_scale": 0.05}),
    ("attention_u256", "qnn.attention", [_i8((2, 1, 12, 8), 23), _i8((2, 1, 12, 8), 24),
                                         _i8((2, 1, 12, 8), 25)],
     {"scores_scale": 1.0, "v_scale": 0.02, "output_scale": 0.04, "rounding": "TONEAREST"}),
    ("mul", "qnn.mul", [_i8((3, 8), 26), _i8((1, 8), 27)],
     {"lhs_scale": 0.05, "lhs_zero_point": 3, "rhs_scale": 0.02, "rhs_zero_point": -4,
      "output_scale": 0.01, "output_zero_point": 2, "out_dtype": "int8"}),
    ("subtract", "qnn.subtract", [_i8((3, 8), 28), _i8((3, 8), 29)],
     {"lhs_scale": 0.05, "lhs_zero_point": 1, "rhs_scale": 0.03, "rhs_zero_point": 0,
      "output_scale": 0.06, "output_zero_point": -5, "out_dtype": "int8"}),
    ("subtract_same_qparams", "qnn.subtract", [_i8((4, 4), 30), _i8((4, 4), 31)],
     {"lhs_scale": 0.05, "lhs_zero_point": 0, "rhs_scale": 0.05, "rhs_zero_point": 0,
      "output_scale": 0.05, "output_zero_point": 0, "out_dtype": "int8"}),
    ("concatenate", "qnn.concatenate", [_i8((2, 1, 8), 32), _i8((2, 5, 8), 33)],
     {"input_scales": [0.02, 0.05], "input_zero_points": [0, 3], "output_scale": 0.05,
      "output_zero_point": 3, "out_dtype": "int8", "axis": 1}),
    ("pad_int8_zp", "nn.pad", [_i8((1, 4, 4, 3), 34)],
     {"pad_width": [[0, 0], [1, 2], [2, 1], [0, 0]], "pad_value": -5}),
    ("pad_float", "nn.pad", [np.random.default_rng(35).standard_normal((2, 3, 4)).astype(np.float32)],
     {"pad_width": [[0, 0], [1, 1], [0, 3]], "pad_value": 0.5}),
    ("pad_edge", "nn.pad", [_i8((2, 5), 36)], {"pad_width": [[1, 0], [2, 3]], "pad_mode": "edge"}),
    ("pad_reflect", "nn.pad", [_i8((2, 5), 37)],
     {"pad_width": [[0, 1], [2, 2]], "pad_mode": "reflect"}),
]


@pytest.mark.parametrize("op,inputs,attrs", [c[1:] for c in OP_CASES], ids=[c[0] for c in OP_CASES])
def test_op_matches_reference_oracle_and_jax(op, inputs, attrs):
    _check_op(op, inputs, attrs)


def test_attention_case_reaches_u256():
    """The u == 256 term of qnn.attention's torch impl is exercised."""
    q, k, _ = OP_CASES[[c[0] for c in OP_CASES].index("attention_u256")][2]
    s = q.astype(np.int64) @ np.swapaxes(k.astype(np.int64), -1, -2)
    d = np.clip(s.max(-1, keepdims=True) - s, 0, 255)
    p = jqnn.softmax_exp_table(1.0)[d].astype(np.int64)
    ssum = p.sum(-1, keepdims=True)
    assert ((p * 256 + ssum // 2) // ssum == 256).any()


@pytest.mark.parametrize("scale", [0.004, 0.05, 0.7, 3.0])
def test_tables_equal_reference(scale):
    assert (pqnn.softmax_exp_table(scale) == jqnn.softmax_exp_table(scale)).all()
    for a, b in zip(pqnn.softmax_exp_factors(scale), jqnn.softmax_exp_factors(scale)):
        assert a.dtype == b.dtype and (a == b).all()
    assert (pqnn.rsqrt_table() == jqnn.rsqrt_table()).all()
    for n in (8, 64, 768, 3072):
        assert pqnn._ln_shift_plan(n) == jqnn._ln_shift_plan(n)
    r = np.random.default_rng(int(scale * 1000))
    gamma, beta = r.normal(size=16), r.normal(size=16)
    assert (pqnn.plan_layer_norm(gamma, beta, scale, 2, 0.03, -1, 16)
            == jqnn.plan_layer_norm(gamma, beta, scale, 2, 0.03, -1, 16))
    assert (pqnn.SOFTMAX_OUT_SCALE, pqnn.SOFTMAX_OUT_ZP) == (jqnn.SOFTMAX_OUT_SCALE,
                                                               jqnn.SOFTMAX_OUT_ZP)


@pytest.mark.parametrize("op", ["nn.gelu", "tanh"])
def test_build_lut_equals_reference(op):
    """build_lut over the port's own float oracles gives the JAX package's
    tables bit for bit."""
    from tachikoma_tpu.ir.graph import Node as JNode
    from tachikoma_tpu.ir.registry import get_op as j_get_op
    from tachikoma_tpu_torch import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    for scale, zp, oscale, ozp in ((0.05, 0, 0.02, 0), (0.11, -7, 0.03, 4)):
        mine = pqnn.build_lut(lambda x: get_op(op).np_impl(x, node=Node("n", op, ())),
                              scale, zp, oscale, ozp)
        ref = jqnn.build_lut(lambda x: j_get_op(op).np_impl(x, node=JNode("n", op, ())),
                             scale, zp, oscale, ozp)
        assert mine.dtype == ref.dtype and (mine == ref).all()


def test_bmm_rq_fused_matches_reference():
    attrs = {"lhs_zero_point": -128, "rhs_zero_point": 0, "multiplier": 1861313373,
             "shift": -9, "rq_input_zero_point": 0, "output_zero_point": 3,
             "rounding": "UPWARD", "out_dtype": "int8", "a_min": -100}
    _check_op("tk.bmm_rq", [_i8((2, 2, 24, 24), 40), _i8((2, 2, 24, 16), 41)], attrs)
    _check_op("tk.bmm_rq", [_i8((2, 3, 24, 16), 42), _i8((2, 3, 24, 16), 43)],
              {**attrs, "lhs_zero_point": 0, "transpose_b": True, "shift": -6})


# ---------------------------------------------------------------------------
# K1's batched mode: the launch's strides, modes and vectors, emulated
# ---------------------------------------------------------------------------

def _emulate(a, b, za, zb, ta, tb, plan):
    """What the kernel computes from `_bmm_launch`'s operands and parameters:
    each product's A and B read through the strides; an operand whose zero
    point is -128 read as uint8 with its sign bit flipped ((x ^ 0x80) as
    uint8 is x + 128) and its zero point dropped; the zero points left
    folded from the column and row sums (-za colsum(B) - zb rowsum(A) + K za
    zb); all in int32 wraparound."""
    shape, A, B, p = mm._bmm_launch("qbmm", a, b, za, zb, ta, tb, plan)
    n0, n1 = p["bmm_nb"] // p["bmm_nb1"], p["bmm_nb1"]
    m, k, n = p["n"], p["cin"], p["cout"]
    av = torch.as_strided(A, (n0, n1, m, k), (p["a_sb0"], p["a_sb1"], p["a_sm"], p["a_sk"]))
    bv = torch.as_strided(B, (n0, n1, k, n), (p["b_sb0"], p["b_sb1"], p["b_sk"], p["b_sn"]))

    def operand(v, z):  # (the values the kernel multiplies, the zero point left)
        if z == -128:
            return (v ^ -128).view(torch.uint8).to(torch.int64), 0
        return v.to(torch.int64), z

    (av, za_), (bv, zb_) = operand(av, p["bmm_za"]), operand(bv, p["bmm_zb"])
    acc = (av.to(torch.float64) @ bv.to(torch.float64)).to(torch.int64)
    acc = (acc - za_ * bv.sum(-2, keepdim=True) - zb_ * av.sum(-1, keepdim=True) + k * za_ * zb_)
    return acc.to(torch.int32).reshape(shape), p


SMALL_PLAN = {"path": "small"}
TILES_PLAN = {"path": "tiles", "bm": 64, "bn": 64}
BMM_LAUNCHES = [
    # (id, a shape, b shape, za, zb, ta, tb, view of a (B, S, H, D) tensor, plan, staging modes)
    ("scores_views", (2, 16, 3, 64), (2, 16, 3, 64), 0, 0, False, True, True, TILES_PLAN,
     ("kmajor16", "kmajor16")),
    ("ctx_views_u8_a", (2, 3, 16, 16), (2, 16, 3, 64), -128, 0, False, False, "b", TILES_PLAN,
     ("kmajor16", "rows")),
    ("ragged_197", (1, 2, _S, _S), (1, 2, _S, 64), -128, 0, False, False, False, TILES_PLAN,
     ("kmajor", "rows")),
    ("unaligned_rows_no_flip", (1, 2, 40, 24), (1, 2, 24, 8), 3, 0, False, False, False, TILES_PLAN,
     ("kmajor", "rows")),
    ("zb_both_t", (3, 9, 5), (3, 7, 9), 11, -7, True, True, False, TILES_PLAN, ("rows", "kmajor")),
    ("u8_b", (2, 24, 32), (2, 32, 16), 5, -128, False, False, False, TILES_PLAN, ("kmajor16", "rows")),
    ("u8_both_t", (2, 32, 24), (2, 16, 32), -128, -128, True, True, False, TILES_PLAN,
     ("rows", "kmajor16")),
    ("broadcast", (2, 1, 6, 32), (1, 3, 32, 16), -128, 3, False, False, False, TILES_PLAN,
     ("kmajor16", "rows")),
    ("three_batch_axes", (2, 2, 3, 8, 16), (2, 2, 3, 8, 16), 0, 0, False, True, False, TILES_PLAN,
     ("kmajor16", "kmajor16")),
    ("unmergeable_axes", (3, 2, 2, 8, 16), (2, 3, 2, 8, 16), 0, 0, False, True, "swap", TILES_PLAN,
     ("kmajor16", "kmajor16")),
    ("decode_scores", (1, 1, 12, 64), (1, 12, 128, 64), 0, 0, False, True, "a", SMALL_PLAN,
     ("kmajor16", "kmajor16")),
    ("decode_ctx_u8_a", (1, 12, 1, 128), (1, 12, 128, 64), -128, 0, False, False, False, SMALL_PLAN,
     ("kmajor16", "rows")),
    ("small_a_rows_copied", (3, 9, 5), (3, 9, 7), 11, -128, True, False, False, SMALL_PLAN,
     ("kmajor", "rows")),
    ("small_both_u8", (2, 4, 40), (2, 40, 24), -128, -128, False, False, False, SMALL_PLAN,
     ("kmajor", "rows")),
    ("tiles_u8_a_aligned", (2, 64, 32), (2, 32, 16), -128, 0, False, False, False,
     dict(TILES_PLAN, bn=256), ("kmajor16", "rows")),
]


@pytest.mark.parametrize("case", BMM_LAUNCHES, ids=[c[0] for c in BMM_LAUNCHES])
def test_bmm_launch_emulated_equals_plain(case):
    _, ash, bsh, za, zb, ta, tb, views, plan, modes = case
    a = torch.from_numpy(_i8(ash, 50))
    b = torch.from_numpy(_i8(bsh, 51))
    if views in (True, "a"):       # head-split views of (B, S, H, D) tensors, read in place
        a = a.permute(0, 2, 1, 3)
    if views in (True, "b"):
        b = b.permute(0, 2, 1, 3)
    if views == "swap":            # three batch axes that do not merge: copied first
        a = a.transpose(0, 1)
    got, p = _emulate(a, b, za, zb, ta, tb, plan)
    assert torch.equal(got, mm.exact_int_bmm(a, b, za, zb, ta, tb))
    names = {v: key for key, v in mm.BMM_STAGES.items()}
    assert (names[p["a_mode"]], names[p["b_mode"]]) == modes
    assert p["bmm_path"] == mm.BMM_PATHS[plan["path"]]


@pytest.mark.parametrize("offset", [1, 5, 8])
@pytest.mark.parametrize("side", ["a", "b"])
def test_bmm_launch_odd_base_pointer(side, offset):
    """An operand whose data starts off 16-byte alignment is staged by
    realigned loads (never cp.async), and its reads through the strides
    still give the plain product."""
    a, b = _i8((2, 3, 20, 32), 52), _i8((2, 3, 32, 48), 53)
    t = a if side == "a" else b
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.int8), t.ravel()]))
    v = flat[offset:].view(t.shape)
    a, b = (v, torch.from_numpy(b)) if side == "a" else (torch.from_numpy(a), v)
    for plan in (TILES_PLAN, SMALL_PLAN):
        if plan is SMALL_PLAN:
            a = a[..., :16, :]
        got, p = _emulate(a, b, 0, -7, False, False, plan)
        assert torch.equal(got, mm.exact_int_bmm(a, b, 0, -7))
        mode = p["a_mode"] if side == "a" else p["b_mode"]
        assert mode == mm.BMM_STAGES["kmajor" if side == "a" else "rows"]


def test_bmm_u8_flip_is_the_zero_point():
    """(x ^ 0x80) read as uint8 is x - (-128) for every int8 x: the flip the
    kernel stages is the zero point's subtraction."""
    x = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal((x ^ -128).view(torch.uint8).to(torch.int16), x.to(torch.int16) + 128)


# (nb, M, K, N) of the main path's calls -> the plan (NVIDIA H100: 132 SMs)
BMM_PLANS = [
    ((12, 1, 64, 128), SMALL_PLAN),                                # decode step: scores
    ((12, 1, 128, 64), SMALL_PLAN),                                # decode step: context
    ((48, 128, 64, 128), TILES_PLAN),                              # BERT-base b4 s128: scores
    ((48, 128, 128, 64), TILES_PLAN),                              # and context, K whole
    ((16, _S, 64, _S), TILES_PLAN),                                # ViT-L/16: 64 tiles a column
    ((16, _S, _S, 64), TILES_PLAN),                                # K 197 staged whole
    ((96, _S, 64, _S), dict(TILES_PLAN, bm=128, bn=256)),          # ViT-B/16 b8: N 197 one tile
    ((96, _S, _S, 64), dict(TILES_PLAN, bm=128)),
    ((12, 2048, 64, 2048), dict(TILES_PLAN, bm=128, bn=256)),      # ring sp 2: scores
    ((12, 2048, 2048, 64), dict(TILES_PLAN, bm=128)),              # and context, 8 chunks
    ((12, 1024, 64, 1024), dict(TILES_PLAN, bm=128, bn=256)),      # ring sp 4
    ((12, 1024, 1024, 64), dict(TILES_PLAN, bm=128)),
    ((2, 16, 4096, 8), SMALL_PLAN),                                # the small path: M <= 16
    ((2, 17, 64, 8), TILES_PLAN),
    ((2, 16, 4097, 8), SMALL_PLAN),                                # at any K
]


@pytest.mark.parametrize("shape,plan", BMM_PLANS, ids=["x".join(map(str, c[0])) for c in BMM_PLANS])
def test_bmm_plan_path_and_tile(shape, plan):
    assert mm.bmm_plan(*shape) == plan
    assert plan in mm.bmm_plans(shape[1])  # a launch the kernel is built for


@pytest.mark.parametrize("shape", [(3, 1, 64, 40), (2, 12, 200, 24), (2, 70, 300, 24)],
                         ids=["small_m1", "small_m12", "tiles_chunked"])
def test_bmm_plans_each_launch_emulated(shape):
    """Every launch `bmm_plans` lists is one the kernel takes (the small
    path only where M <= SMALL_M; tiles at each BM and BN, K in the chunks
    `bmm_kc` gives), and each, emulated through its launch, == plain."""
    nb, m, k, n = shape
    a = torch.from_numpy(_i8((nb, k, m), 54)).transpose(-1, -2)  # A with its rows contiguous
    b = torch.from_numpy(_i8((nb, k, n), 55))
    plans = mm.bmm_plans(m)
    assert ({"path": "small"} in plans) == (m <= mm.SMALL_M)
    assert {(p.get("bm"), p.get("bn")) for p in plans if p["path"] == "tiles"} == {
        (bm, bn) for bm in (64, 128) for bn in (64, 256)}
    for plan in plans:
        got, p = _emulate(a, b, -128, 5, False, False, plan)
        assert torch.equal(got, mm.exact_int_bmm(a, b, -128, 5))
        kmajor = plan["path"] == "small" or m == 1  # copied, or its one row has k contiguous
        names = ("kmajor16", "kmajor") if kmajor else ("rows",)
        assert p["a_mode"] in [mm.BMM_STAGES[x] for x in names]
        if plan["path"] == "tiles":  # K whole up to 256 bytes, else 256-byte chunks
            kc = mm.bmm_kc(k)
            assert kc in (64, 128, 256) and (kc >= k or kc == 256) and (kc == 64 or kc // 2 < k)
            assert f"kc {kc} ({-(-k // kc)} chunks)" in mm.launch_summary(
                "qbmm", a, b, lhs_zero_point=-128, rhs_zero_point=5, plan=plan)


def test_bmm_plan_and_plain_wrappers():
    assert mm.bmm_plan(48, 128, 64, 128) == {"path": "tiles", "bm": 64, "bn": 64}
    assert mm.bmm_plan(12, 1, 128, 64) == {"path": "small"}
    assert mm.bmm_plan(96, _S, 64, _S) == {"path": "tiles", "bm": 128, "bn": 256}
    a, b = torch.from_numpy(_i8((2, 5, 24), 60)), torch.from_numpy(_i8((2, 24, 7), 61))
    mult = torch.full((7,), 1500000000, dtype=torch.int32)
    shift = torch.full((7,), -8, dtype=torch.int32)
    before = dict(LAUNCHES)
    got = mm.qbmm_rq(a, b, None, mult, shift, lhs_zero_point=-128, out_zp=-3, qmin=-120)
    raw = mm.qbmm_raw(a, b, lhs_zero_point=-128)
    assert dict(LAUNCHES) == before  # a CPU tensor runs the plain version: no launch
    from tachikoma_tpu.ir.graph import Node as JNode
    from tachikoma_tpu.ops.fixed_point import q_multiply_shift_np

    want_raw = jqnn._qbmm_np(a.numpy(), b.numpy(),
                             node=JNode("n", "qnn.batch_matmul", attrs={"lhs_zero_point": -128}))
    assert (raw.numpy() == want_raw).all()
    want = np.clip(q_multiply_shift_np(want_raw, 1500000000, -8) - 3, -120, 127).astype(np.int8)
    assert (got.numpy() == want).all()
    with pytest.raises(ValueError, match="no kernel"):
        mm.qbmm_raw(a.to("meta"), b.to("meta"))
    for bad in ({"path": "small"}, {"path": "tiles", "bm": 96, "bn": 64},
                {"path": "tiles", "bm": 64, "bn": 128},
                {"path": "tiles", "bm": 64, "bn": 32}, {"bm": 64, "bn": 64}):
        with pytest.raises(ValueError, match="plan|small path"):
            mm._bmm_launch("qbmm", torch.from_numpy(_i8((2, 40, 8), 62)),
                           torch.from_numpy(_i8((2, 8, 4), 63)), 0, 0, False, False, bad)


# ---------------------------------------------------------------------------
# simplify: the passes the port gained
# ---------------------------------------------------------------------------

def _graph(builder, kind):
    r = np.random.default_rng(70)
    b = builder("g")
    if kind == "combine_parallel_dense":
        x = b.var("x", (2, 5, 16), "float32")
        outs = [b.call("nn.dense", x, b.const(r.normal(size=(16, w)).astype(np.float32),
                                              name=f"w{i}"), name=f"d{i}")
                for i, w in enumerate((16, 16, 8))]
        y = b.call("add", b.call("add", outs[0], outs[1], name="s0"),
                   b.call("concatenate", outs[2], outs[2], axis=-1, name="c"), name="s1")
    elif kind == "fold_scale_axis":
        x = b.var("x", (1, 6, 6, 4), "float32")
        s = b.const(r.uniform(0.5, 2, 4).astype(np.float32), name="s_in")
        m = b.call("multiply", x, s, name="m_in")
        c = b.call("nn.conv2d", m, b.const(r.normal(size=(3, 3, 4, 8)).astype(np.float32),
                                            name="w"), padding=(1, 1, 1, 1), name="conv")
        y = b.call("multiply", c, b.const(r.uniform(0.5, 2, 8).astype(np.float32), name="s_out"),
                   name="m_out")
        d = b.call("nn.dense", b.call("reshape", y, newshape=(1, 288), name="r"),
                   b.const(r.normal(size=(288, 5)).astype(np.float32), name="wd"), name="dense")
        y = b.call("multiply", b.const(np.float32(0.125)), d, name="m_scalar")
    elif kind == "fuse_pad_into_conv":
        x = b.var("x", (1, 6, 6, 3), "float32")
        p = b.call("nn.pad", x, pad_width=[[0, 0], [1, 2], [0, 1], [0, 0]], name="pad")
        y = b.call("nn.conv2d", p, b.const(r.normal(size=(3, 3, 3, 4)).astype(np.float32),
                                            name="w"), padding=(1, 0, 1, 0), name="conv")
    else:  # remove_identity
        x = b.var("x", (2, 8), "float32")
        r1 = b.call("reshape", x, newshape=(2, 8), name="same_shape")
        bt = b.call("broadcast_to", r1, shape=(2, 8), name="same_bcast")
        y = b.call("reshape", b.call("add", bt, x, name="a"), newshape=(16,), name="flat")
    return b.build(y)


@pytest.mark.parametrize("kind", ["remove_identity", "fold_scale_axis", "fuse_pad_into_conv",
                                  "combine_parallel_dense"])
def test_simplify_pass_fires_and_equals_reference(kind):
    g, jg = infer_types(_graph(GraphBuilder, kind)), j_infer_types(_graph(JGraphBuilder, kind))
    out, ref = getattr(ptr, kind)(g), getattr(jtr, kind)(jg)
    assert out.to_json() == ref.to_json()
    assert out.to_json() != g.to_json()  # the pass fired
    assert ptr.simplify(g).to_json() == jtr.simplify(jg).to_json()
    assert [p.__name__ for p in ptr.DEFAULT_SIMPLIFY] == [p.__name__ for p in jtr.DEFAULT_SIMPLIFY]


# ---------------------------------------------------------------------------
# the zoo's transformers: quantize, fuse, run, trace
# ---------------------------------------------------------------------------

def _calib(g, seeds=(0, 1)):
    inp = g.inputs[0]
    out = []
    for s in seeds:
        r = np.random.default_rng(s)
        out.append({inp.name: (r.integers(0, 60, inp.shape).astype(inp.dtype)
                               if inp.dtype.startswith("int")
                               else r.standard_normal(inp.shape).astype(inp.dtype))})
    return out


_QUANTIZED = {}


def _quantized(model, preset):
    key = (model, preset)
    if key not in _QUANTIZED:
        g, jg = getattr(pt, model)(**SMALL[model]), getattr(jt, model)(**SMALL[model])
        pc, jc = ((TRANSFORMER_INT8, J_TRANSFORMER_INT8) if preset == "int8"
                  else (QConfig(), JQConfig()))
        _QUANTIZED[key] = (quantize(g, _calib(g), pc), j_quantize(jg, _calib(jg), jc), g)
    return _QUANTIZED[key]


@pytest.mark.parametrize("preset", ["int8", "default"])
@pytest.mark.parametrize("model", sorted(SMALL))
def test_zoo_quantized_fused_and_run_equal_reference(model, preset):
    q, jq, g = _quantized(model, preset)
    assert ptr.simplify(g).to_json() == jtr.simplify(getattr(jt, model)(**SMALL[model])).to_json()
    assert q.to_json() == jq.to_json()
    f, jf = fuse_qnn(q), j_fuse_qnn(jq)
    assert f.to_json() == jf.to_json()
    ops = {n.op for n in f.nodes}
    assert "tk.bmm_rq" in ops
    assert ("qnn.softmax" in ops) == (preset == "int8") != ("nn.softmax" in ops)
    assert "qnn.layer_norm" in ops
    x = _calib(g, seeds=(9,))[0]
    for graph, jgraph in ((q, jq), (f, jf)):
        want = {}
        j_run_graph(jgraph, x, intercept=lambda name, op, args, out: want.__setitem__(name, out))
        names = computational_nodes(graph)
        got = TorchExecutor(graph, capture=names, device="cpu", fuse=False).run(x)
        n_int = 0
        for name, v in zip(names, got):
            w = want[name]
            assert v.dtype == w.dtype and v.shape == w.shape, name
            if w.dtype.kind in "iu":
                assert (v == w).all(), name
                n_int += 1
            else:
                np.testing.assert_allclose(v, w, rtol=1e-4, atol=1e-4, err_msg=name)
        assert n_int > len(names) // 2


def test_int8_bert_trace_is_byte_equal_and_verified():
    q, jq, g = _quantized("bert", "int8")
    x = _calib(g, seeds=(11,))[0]
    blob = emit_trace(q, x, backend="torch", device="cpu")
    ref = j_emit_trace(jq, x, backend="oracle")
    assert blob == ref
    res = j_verify_trace(blob)
    assert res["verified"] == res["records"] and not res["mismatches"]
    import io

    from tachikoma_tpu.trace.format import TraceReader

    ops = {r.op_name for r in TraceReader(io.BytesIO(blob))}
    assert {"qnn.softmax", "qnn.lut", "qnn.layer_norm", "qnn.batch_matmul"} <= ops
