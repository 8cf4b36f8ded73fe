"""The port's serving path, KV-cache decoding (models/decoding.py), on the CPU,
against the JAX package.

At tests/test_decoding.py's tiny size (B 2, L 12, hidden 32, 2 layers, 4
heads, FFN 64, vocab 50) the same seeded inputs go through the JAX package's
functions and the port's: the ops the step graph gained (the comparison
family, `where`, `dynamic_slice`, `dynamic_update_slice`) against the JAX
package's oracle and `JaxExecutor` with ==; the step graph, its int8 form
(TRANSFORMER_INT8) and the fused int8 graph equal to the JAX package's
JSON and params; the float step within 2e-4 of `JaxExecutor` and every
integer node of the int8 step == the JAX package's oracle; greedy, sampled,
prefilled, on-device and scanned generation equal to the JAX package's
tokens or to the port's own host loop; the int8 step's trace byte-equal to
the JAX package's and verified by its verifier."""

import io

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.models import decoding as jd
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.quantize.config import TRANSFORMER_INT8 as J_TRANSFORMER_INT8
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu.trace.emitter import verify_trace as j_verify_trace
from tachikoma_tpu_torch import GraphBuilder, infer_types, run_graph
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.ir.transforms import fuse_attention
from tachikoma_tpu_torch.models import decoding as pd
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace.emitter import emit_trace

B, L, HID, LAYERS, HEADS, FFN, VOCAB = 2, 12, 32, 2, 4, 64, 50
DIMS = dict(hidden=HID, layers=LAYERS, heads=HEADS, ffn_dim=FFN, vocab=VOCAB)
TOL = 2e-4  # tests/test_decoding.py's logits tolerance


# ---------------------------------------------------------------------------
# the ops the step graph gained
# ---------------------------------------------------------------------------

def _r(*shape, seed=0, lo=-3, hi=4, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _f(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _s(v):
    return np.int32(v).reshape(())


_CACHE = _f(2, 3, 12, 4, seed=5)
_ROW = _f(2, 3, 1, 4, seed=6)

# (id, op, inputs, attrs, dtype JaxExecutor gives where it differs from the relation's)
OP_CASES = [
    *((f"{op}_broadcast", op, [_r(3, 1, 5), _r(4, 5, seed=1)], {}, None)
      for op in ("equal", "not_equal", "less", "less_equal", "greater", "greater_equal")),
    ("less_equal_arange_pos", "less_equal", [np.arange(12, dtype=np.int32), _s(7)], {}, None),
    ("less_float", "less", [_f(2, 6), _f(1, 6, seed=1)], {}, None),
    ("equal_int8_int32", "equal", [_r(4, 5, dtype=np.int8), _r(4, 5, seed=1)], {}, None),
    ("logical_and", "logical_and", [_r(3, 4, lo=0, hi=2).astype(bool),
                                    _r(1, 4, seed=1, lo=0, hi=2).astype(bool)], {}, None),
    ("logical_or", "logical_or", [_r(3, 4, lo=0, hi=2).astype(bool),
                                  _r(3, 1, seed=1, lo=0, hi=2).astype(bool)], {}, None),
    ("logical_and_int", "logical_and", [_r(3, 4), _r(3, 4, seed=1)], {}, None),
    ("logical_not", "logical_not", [_r(3, 4, lo=0, hi=2).astype(bool)], {}, None),
    ("where_mask", "where", [np.arange(12) <= 4, np.zeros(12, np.float32),
                             np.full(12, -30.0, np.float32)], {}, None),
    ("where_broadcast", "where", [_r(3, 1, lo=0, hi=2).astype(bool), _f(1, 5), _f(3, 5, seed=1)],
     {}, None),
    ("where_int_condition", "where", [_r(2, 5), _f(2, 5), _f(2, 5, seed=1)], {}, None),
    ("where_int8_float32", "where", [_r(4, 3, lo=0, hi=2).astype(bool), _r(4, 3, dtype=np.int8),
                                     _f(4, 3)], {}, None),
    # numpy's promotion, the relation's (dt.promote): float64; JAX's executor gives float32
    ("where_int32_float32", "where", [_r(4, 3, lo=0, hi=2).astype(bool), _r(4, 3), _f(4, 3)], {},
     "float32"),
    *((f"dynamic_update_slice_{nm}", "dynamic_update_slice",
       [_CACHE, _ROW, _s(0), _s(0), _s(p), _s(0)], {}, None)
      for nm, p in (("start", 0), ("mid", 5), ("last", 11), ("beyond", 40))),
    ("dynamic_update_slice_all_axes", "dynamic_update_slice",
     [_CACHE, _f(1, 2, 5, 3, seed=7), _s(1), _s(9), _s(4), _s(3)], {}, None),
    ("dynamic_update_slice_int8", "dynamic_update_slice",
     [_r(6, 8, dtype=np.int8), _r(2, 3, seed=1, dtype=np.int8), _s(5), _s(6)], {}, None),
    *((f"dynamic_slice_{nm}", "dynamic_slice", [_CACHE, _s(0), _s(1), _s(p), _s(0)],
       {"sizes": (2, 2, 3, 4)}, None)
      for nm, p in (("start", 0), ("mid", 4), ("last", 9), ("beyond", 30))),
    ("dynamic_slice_all_axes", "dynamic_slice", [_f(5, 7, seed=8), _s(4), _s(3)],
     {"sizes": (2, 3)}, None),
]


def _one_op(builder, infer, op, inputs, attrs):
    b = builder("t")
    names = [b.var(f"x{i}", x.shape, str(x.dtype)) for i, x in enumerate(inputs)]
    return infer(b.build(b.call(op, *names, name="y", **attrs)))


@pytest.mark.parametrize("op,inputs,attrs,jax_dtype", [c[1:] for c in OP_CASES],
                         ids=[c[0] for c in OP_CASES])
def test_op_matches_reference_oracle_and_jax_impl(op, inputs, attrs, jax_dtype):
    """The port's relation, oracle and torch impl == the JAX package's oracle
    and JaxExecutor (which agrees in values, and in dtype but for `where`
    over an int32 and a float32 branch)."""
    g = _one_op(GraphBuilder, infer_types, op, inputs, attrs)
    jg = _one_op(JGraphBuilder, j_infer_types, op, inputs, attrs)
    assert g.to_json() == jg.to_json()
    feeds = {f"x{i}": x for i, x in enumerate(inputs)}
    want = j_run_graph(jg, feeds)[0]
    assert (want.shape, str(want.dtype)) == (g["y"].shape, g["y"].dtype)
    jax_out = np.asarray(JaxExecutor(jg, fuse=False).run(feeds)[0])
    assert str(jax_out.dtype) == (jax_dtype or str(want.dtype))
    assert (jax_out == want).all()
    for key, got in (("oracle", run_graph(g, feeds)[0]),
                     ("torch", TorchExecutor(g, device="cpu").run(feeds)[0])):
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert (got == want).all(), f"{op} {key}"


@pytest.mark.parametrize("op,inputs,attrs", [c[1:4] for c in OP_CASES if c[1].startswith("dyn")],
                         ids=[c[0] for c in OP_CASES if c[1].startswith("dyn")])
def test_dynamic_slices_read_no_start_on_the_host(op, inputs, attrs):
    """The torch impls run on meta tensors, which hold no values: any host
    read of a start index (int(), .item(), .tolist()) would raise."""
    from tachikoma_tpu_torch.ir.graph import Node
    from tachikoma_tpu_torch.ir.registry import get_op

    meta = [torch.from_numpy(np.asarray(x)).to("meta") for x in inputs]
    out = get_op(op).torch_impl(*meta, node=Node("y", op, (), attrs=attrs))
    assert out.device.type == "meta"
    assert tuple(out.shape) == _one_op(GraphBuilder, infer_types, op, inputs, attrs)["y"].shape


# ---------------------------------------------------------------------------
# the step graph, float and int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    full = pt.gpt2(batch_size=B, seq_len=L, seed=7, **DIMS)
    jfull = jt.gpt2(batch_size=B, seq_len=L, seed=7, **DIMS)
    step = pd.gpt2_decode_step(full, batch_size=B, max_len=L, **DIMS)
    jstep = jd.gpt2_decode_step(jfull, batch_size=B, max_len=L, **DIMS)
    return full, jfull, step, jstep


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, n)).astype(np.int32)


def _step_feeds(step, prompt, steps):
    """Feeds of positions 0 .. steps - 1 (the caches from the oracle's run of
    the previous steps), tests/test_decoding.py's calibration loop."""
    caches = {f"{kv}{i}": np.zeros((B, HEADS, L, HID // HEADS), np.float32)
              for kv in "kv" for i in range(LAYERS)}
    feeds = []
    for p in range(steps):
        f = {"token": prompt[:, p:p + 1], "pos": np.int32(p), **caches}
        feeds.append(dict(f))
        outs = run_graph(step, f)
        for i in range(LAYERS):
            caches[f"k{i}"] = np.asarray(outs[1 + i])
            caches[f"v{i}"] = np.asarray(outs[1 + LAYERS + i])
    return feeds


def _params_equal(p, q):
    assert sorted(p) == sorted(q)
    for k in p:
        a, b = np.asarray(p[k]), np.asarray(q[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def test_step_graph_equals_reference_and_shares_params(models):
    full, _, step, jstep = models
    assert step.to_json() == jstep.to_json()
    _params_equal(step.params, jstep.params)
    shared = [k for k in step.params if k.startswith(("block", "wte", "wpe", "ln_f", "lm_head"))]
    assert "block0_attn_q_w" in shared and "lm_head" in shared
    for k in shared:
        assert step.params[k] is full.params[k]


def test_reference_full_graph_through_json_builds_the_same_step(models):
    """A full graph the JAX package built, read through its JSON, gives the
    port the JAX package's step graph."""
    _, jfull, _, jstep = models
    full = from_reference_graph(jfull.to_json())
    step = pd.gpt2_decode_step(full, batch_size=B, max_len=L, **DIMS)
    assert step.to_json() == jstep.to_json()
    _params_equal(step.params, jstep.params)


def test_float_step_matches_jax_executor(models):
    _, _, step, jstep = models
    feeds = _step_feeds(step, _prompt(6), 5)[-1]
    got = TorchExecutor(step, device="cpu").run(feeds)
    want = JaxExecutor(jstep).run(feeds)
    assert len(got) == len(want) == 1 + 2 * LAYERS
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float32 and a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL, err_msg=f"output {i}")


def test_float_step_runs_on_meta_tensors(models):
    """The whole float step runs on meta tensors: no op of it reads a value
    on the host, so a card can capture it in a CUDA graph."""
    _, _, step, _ = models
    ex = TorchExecutor(step, device="cpu")
    ex._params = {k: v.to("meta") for k, v in ex._params.items()}
    ex.device = torch.device("meta")
    feeds = {k: torch.from_numpy(np.asarray(v)).to("meta")
             for k, v in _step_feeds(step, _prompt(2), 1)[0].items()}
    outs = ex.run_device(feeds)
    assert [tuple(o.shape) for o in outs] == [step[o].shape for o in step.outputs]


@pytest.fixture(scope="module")
def quantized(models):
    _, _, step, jstep = models
    calib = _step_feeds(step, _prompt(6), 4)
    q = quantize(step, calib, TRANSFORMER_INT8)
    jq = j_quantize(jstep, calib, config=J_TRANSFORMER_INT8)
    return q, jq, fuse_qnn(q), j_fuse_qnn(jq)


def test_int8_step_graph_equals_reference(quantized):
    q, jq, f, jf = quantized
    assert q.to_json() == jq.to_json()
    _params_equal(q.params, jq.params)
    assert f.to_json() == jf.to_json()
    _params_equal(f.params, jf.params)
    ops = [n.op for n in f.nodes]
    # the decode step's int8 kernels: the merged Q/K/V qnn.dense (K4), three
    # tk.dense_rq (K1) and two tk.bmm_rq (qbmm_rq) a layer; the LM head float
    assert (ops.count("qnn.dense"), ops.count("tk.dense_rq"), ops.count("tk.bmm_rq"),
            ops.count("nn.matmul")) == (LAYERS, 3 * LAYERS, 2 * LAYERS, 1)
    assert ops.count("dynamic_update_slice") == 2 * LAYERS


@pytest.mark.parametrize("form", ["unfused", "fused"])
def test_int8_step_integer_nodes_equal_reference_oracle(models, quantized, form):
    _, _, step, _ = models
    q, jq, f, jf = quantized
    g, jg = (q, jq) if form == "unfused" else (f, jf)
    feeds = _step_feeds(step, _prompt(6, seed=3), 6)[-1]
    want = {}
    j_run_graph(jg, feeds, intercept=lambda name, op, args, out: want.__setitem__(name, out))
    names = computational_nodes(g)
    got = TorchExecutor(g, capture=names, device="cpu").run(feeds)
    n_int = 0
    for name, v in zip(names, got):
        w = want[name]
        assert v.dtype == w.dtype and v.shape == w.shape, name
        if w.dtype.kind in "iub":
            assert (v == w).all(), name
            n_int += 1
        else:
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6, err_msg=name)
    assert n_int > len(names) // 2


def test_int8_step_trace_is_byte_equal_and_verified(models, quantized):
    _, _, step, _ = models
    q, jq, _, _ = quantized
    feeds = _step_feeds(step, _prompt(6, seed=4), 5)[-1]
    blob = emit_trace(q, feeds, backend="torch", device="cpu")
    assert blob == j_emit_trace(jq, feeds, backend="oracle")
    res = j_verify_trace(blob)
    assert res["verified"] == res["records"] > 0 and not res["mismatches"]
    from tachikoma_tpu.trace.format import TraceReader

    ops = {r.op_name for r in TraceReader(io.BytesIO(blob))}
    assert {"qnn.dense", "qnn.batch_matmul", "qnn.softmax", "qnn.layer_norm"} <= ops


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_reference(models):
    _, _, step, jstep = models
    prompt = _prompt(4, seed=1)
    toks, logits = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").generate(prompt, 5)
    jtoks, jlogits = jd.GreedyDecoder(jstep, layers=LAYERS).generate(prompt, 5)
    assert toks.dtype == np.int32 and toks.shape == (B, 5)
    np.testing.assert_array_equal(toks, jtoks)
    assert len(logits) == len(jlogits) == 4 + 5 - 1
    for p, (a, b) in enumerate(zip(logits, jlogits)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL, err_msg=f"position {p}")


def test_incremental_matches_full_recompute(models):
    full, _, step, _ = models
    prompt = _prompt(4, seed=2)
    n_new = 5
    toks, step_logits = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").generate(prompt, n_new)
    seq = np.zeros((B, L), np.int32)
    seq[:, :4] = prompt
    seq[:, 4:4 + n_new] = toks
    full_logits = TorchExecutor(full, device="cpu").run({"input_ids": seq})[0]
    for p in range(4 + n_new - 1):
        np.testing.assert_allclose(step_logits[p], full_logits[:, p, :], rtol=TOL, atol=TOL,
                                   err_msg=f"position {p}")
    for s in range(n_new):
        np.testing.assert_array_equal(toks[:, s], np.argmax(full_logits[:, 4 + s - 1], axis=-1))


def test_numpy_backend_agrees(models):
    _, _, step, _ = models
    prompt = _prompt(3, seed=3)
    tt, lt = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").generate(prompt, 3)
    tn, ln = pd.GreedyDecoder(step, layers=LAYERS, backend="numpy").generate(prompt, 3)
    np.testing.assert_array_equal(tt, tn)
    for a, b in zip(lt, ln):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unknown backend"):
        pd.GreedyDecoder(step, layers=LAYERS, backend="jax")


def test_host_loop_sampling_matches_reference_and_is_deterministic(models):
    _, _, step, jstep = models
    prompt = _prompt(3, seed=4)
    dec = pd.GreedyDecoder(step, layers=LAYERS, device="cpu")
    t1, _ = dec.generate(prompt, 6, temperature=0.8, top_k=5, seed=11)
    t2, _ = dec.generate(prompt, 6, temperature=0.8, top_k=5, seed=11)
    np.testing.assert_array_equal(t1, t2)
    jt1, _ = jd.GreedyDecoder(jstep, layers=LAYERS).generate(prompt, 6, temperature=0.8, top_k=5,
                                                             seed=11)
    np.testing.assert_array_equal(t1, jt1)
    t3, _ = dec.generate(prompt, 6, temperature=1.5, seed=12)
    jt3, _ = jd.GreedyDecoder(jstep, layers=LAYERS).generate(prompt, 6, temperature=1.5, seed=12)
    np.testing.assert_array_equal(t3, jt3)


@pytest.mark.parametrize("attention", ["unfused", "fuse_attention"])
def test_full_graph_prefill_matches_stepwise(models, attention):
    full, _, step, _ = models
    prefill = fuse_attention(full) if attention == "fuse_attention" else full
    assert ("tk.attention" in {n.op for n in prefill.nodes}) == (attention == "fuse_attention")
    prompt = _prompt(5, seed=5)
    t1, l1 = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").generate(prompt, 4)
    fast = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").attach_prefill(prefill)
    t2, l2 = fast.generate(prompt, 4)
    np.testing.assert_array_equal(t1, t2)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_ondevice_greedy_matches_host_loop(models):
    full, _, step, _ = models
    prompt = _prompt(5, seed=6)
    dec = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").attach_prefill(fuse_attention(full))
    t1, _ = dec.generate(prompt, 6)
    t2 = dec.generate_ondevice(prompt, 6)
    assert t2.dtype == np.int32
    np.testing.assert_array_equal(t1, t2)
    assert dec.cuda_graph is None and dec.replays == 0  # the CPU runs the loop eagerly
    np.testing.assert_array_equal(dec.generate_ondevice(prompt, 1), t1[:, :1])


def test_ondevice_sampling_deterministic(models):
    full, _, step, _ = models
    prompt = _prompt(3, seed=7)
    dec = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").attach_prefill(full)
    a = dec.generate_ondevice(prompt, 5, temperature=0.8, top_k=10, seed=3)
    b = dec.generate_ondevice(prompt, 5, temperature=0.8, top_k=10, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, 5) and (a >= 0).all() and (a < VOCAB).all()
    c = dec.generate_ondevice(prompt, 5, temperature=0.8, top_k=1, seed=4)
    np.testing.assert_array_equal(c, dec.generate_ondevice(prompt, 5))  # top-1 is greedy


def test_ondevice_up_front_errors(models):
    full, _, step, _ = models
    dec = pd.GreedyDecoder(step, layers=LAYERS, device="cpu")
    with pytest.raises(ValueError, match="attach_prefill"):
        dec.generate_ondevice(_prompt(3), 2)
    short = pt.gpt2(batch_size=B, seq_len=4, seed=7, **DIMS)
    dec.attach_prefill(short)
    with pytest.raises(ValueError, match="exceeds the attached prefill length"):
        dec.generate_ondevice(_prompt(5), 2)
    with pytest.raises(ValueError, match="torch backend"):
        pd.GreedyDecoder(step, layers=LAYERS, backend="numpy").generate_ondevice(_prompt(3), 2)


def test_scanned_generation_matches_host_loop_and_reference(models):
    full, jfull, step, _ = models
    prompt = _prompt(5, seed=8)
    host, _ = pd.GreedyDecoder(step, layers=LAYERS, device="cpu").attach_prefill(full).generate(
        prompt, 4)
    got = pd.gpt2_generate_scanned(full, prompt, 4, max_len=L, device="cpu", **DIMS)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        got, jd.gpt2_generate_scanned(jfull, prompt, 4, max_len=L, **DIMS))
    a = pd.gpt2_generate_scanned(full, prompt, 4, max_len=L, temperature=0.7, top_k=8, seed=5,
                                 device="cpu", **DIMS)
    b = pd.gpt2_generate_scanned(full, prompt, 4, max_len=L, temperature=0.7, top_k=8, seed=5,
                                 device="cpu", **DIMS)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError, match="exceeds max_len"):
        pd.gpt2_generate_scanned(full, prompt, 9, max_len=L, device="cpu", **DIMS)


def test_int8_greedy_tokens_match_reference(models, quantized):
    _, _, step, _ = models
    q, jq, f, jf = quantized
    prompt = _prompt(6, seed=9)
    want, _ = jd.GreedyDecoder(jq, layers=LAYERS).generate(prompt, 4)
    for g in (q, f):
        got, _ = pd.GreedyDecoder(g, layers=LAYERS, device="cpu").generate(prompt, 4)
        np.testing.assert_array_equal(got, want)
    got, _ = pd.GreedyDecoder(f, layers=LAYERS, backend="numpy").generate(prompt, 4)
    np.testing.assert_array_equal(got, np.asarray(jd.GreedyDecoder(jf, layers=LAYERS,
                                                                  backend="numpy")
                                                  .generate(prompt, 4)[0]))


def test_entry_points_without_a_card_raise(models, monkeypatch):
    full, _, step, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.GreedyDecoder(step, layers=LAYERS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.gpt2_generate_scanned(full, _prompt(3), 2, max_len=L, **DIMS)
