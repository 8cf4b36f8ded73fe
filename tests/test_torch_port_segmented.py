"""The port's segmented executor, TRANSFORMER_INT8_SCAN, the "torch-cpu"
calibration backend and the "torch-segmented" trace backend on the CPU,
against the JAX package (`tests/test_segmented.py`'s sizes).

The same graphs are built in both packages from the same seeds: the port's
`partition` cuts the same nodes, `n_programs` and the scan runs (start,
length, carry slot) equal the JAX package's, and the outputs equal JAX's
`SegmentedExecutor` and the oracle (integers with ==, floats at the JAX
tests' rtol 2e-5, atol 1e-5).  Tied layers with different weights share one
program and still give their own outputs; `run_stream` yields the JAX
package's values in its order; the "torch-segmented" trace is byte-equal to
the JAX package's "jax-segmented" and "numpy" traces."""

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import run_graph as j_run_graph
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.quantize.config import TRANSFORMER_INT8 as J_TRANSFORMER_INT8
from tachikoma_tpu.quantize.config import TRANSFORMER_INT8_SCAN as J_TRANSFORMER_INT8_SCAN
from tachikoma_tpu.quantize.config import QConfig as JQConfig
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import computational_nodes as j_computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.runtime.segmented import SegmentedExecutor as JSegmentedExecutor
from tachikoma_tpu.runtime.segmented import partition as j_partition
from tachikoma_tpu.runtime.segmented import run_stream as j_run_stream
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch import GraphBuilder, run_graph
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.quantize.calibrate import calibrate
from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8, TRANSFORMER_INT8_SCAN, QConfig
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor, computational_nodes
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.runtime.segmented import SegmentedExecutor, partition, run_stream
from tachikoma_tpu_torch.trace.emitter import TraceEmitter, emit_trace, verify_trace

RTOL, ATOL = 2e-5, 1e-5   # tests/test_segmented.py's float tolerance


def _bert_kw(layers):
    return dict(batch_size=2, seq_len=16, hidden=32, layers=layers, heads=4, ffn_dim=64,
                vocab=100, seed=0)


GPT2_KW = dict(batch_size=1, seq_len=16, hidden=32, layers=6, heads=4, ffn_dim=64, vocab=96,
               seed=1)


def _ids(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype.kind in "iub":
        assert (got == want).all(), what
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _describe(ex, jex, min_scan):
    """(segment node names, programs, scan runs) of both executors."""
    names = [[n.name for n in s.sub.nodes if not (n.is_var or n.is_const)] for s in ex.segments]
    jnames = [[n.name for n in s.sub.nodes if not (n.is_var or n.is_const)]
              for s in jex.segments]
    return ((names, ex.n_programs, ex.scan_runs),
            (jnames, jex.n_programs, jex._find_scan_runs(min_scan) if jex._scan_fns else []))


@pytest.fixture(scope="module")
def gpt2_int8():
    """Fused int8 GPT-2 (6 layers), tied (TRANSFORMER_INT8_SCAN) and untied,
    in both packages."""
    calib = [_ids(96, (1, 16))]
    out = {}
    for key, cfg, jcfg in (("tied", TRANSFORMER_INT8_SCAN, J_TRANSFORMER_INT8_SCAN),
                           ("untied", TRANSFORMER_INT8, J_TRANSFORMER_INT8)):
        out[key] = (fuse_qnn(quantize(pt.gpt2(**GPT2_KW), calib, cfg)),
                    j_fuse_qnn(j_quantize(jt.gpt2(**GPT2_KW), calib, jcfg)))
    return out, calib[0]


@pytest.mark.parametrize("layers,min_ops,max_ops", [(4, 10, 200), (4, 16, 120), (8, 16, 120),
                                                    (24, 16, 120), (24, 48, 640)])
def test_partition_equals_the_jax_package(layers, min_ops, max_ops):
    g, jg = pt.bert(**_bert_kw(layers)), jt.bert(**_bert_kw(layers))
    segs, jsegs = partition(g, min_ops, max_ops), j_partition(jg, min_ops, max_ops)
    assert [[n.name for n in s] for s in segs] == [[n.name for n in s] for s in jsegs]
    assert sum(len(s) for s in segs) == sum(1 for n in g.nodes if not (n.is_var or n.is_const))


@pytest.mark.parametrize("layers,scan", [(4, True), (6, False), (8, True)])
def test_float_bert_programs_scan_and_outputs(layers, scan):
    g, jg = pt.bert(**_bert_kw(layers)), jt.bert(**_bert_kw(layers))
    x = _ids(100, (2, 16))
    ex = SegmentedExecutor(g, min_ops=16, max_ops=120, scan=scan, device="cpu")
    jex = JSegmentedExecutor(jg, min_ops=16, max_ops=120, scan=scan)
    mine, theirs = _describe(ex, jex, 3)
    assert mine == theirs
    assert ex.n_programs < len(ex.segments)
    if scan and layers == 8:
        assert ex.scan_runs and sum(length for _, length, _ in ex.scan_runs) >= 4
    whole = TorchExecutor(g, device="cpu").run(x)
    for a, b, c in zip(ex.run(x), jex.run(x), whole):
        _same(a, np.asarray(b))
        assert (a == c).all()  # the same impls in the same order


@pytest.mark.parametrize("tied", ["tied", "untied"])
def test_fused_int8_gpt2_equals_the_jax_package(gpt2_int8, tied):
    graphs, x = gpt2_int8
    f, jf = graphs[tied]
    assert f.to_json() == jf.to_json()
    ex = SegmentedExecutor(f, min_ops=16, max_ops=120, device="cpu")
    jex = JSegmentedExecutor(jf, min_ops=16, max_ops=120)
    mine, theirs = _describe(ex, jex, 3)
    assert mine == theirs
    if tied == "tied":
        assert ex.scan_runs == [(1, 5, 0)] and ex.n_programs == 3
    else:
        assert ex.scan_runs == [] and ex.n_programs == len(ex.segments)
    oracle = run_graph(f, x)
    for a, b, o in zip(ex.run(x), jex.run(x), oracle):
        _same(a, np.asarray(b))
        _same(a, o)


def test_transformer_int8_scan_json_equals_the_jax_package():
    """The scale_group pooling of the port's calibrator and quantizer gives
    the JAX package's integer graph, unfused, on BERT and ViT."""
    for build, jbuild, x in (
            (pt.bert, jt.bert, _ids(100, (2, 16))),
            (pt.vit, jt.vit, np.random.default_rng(2).standard_normal((1, 32, 32, 3))
             .astype(np.float32))):
        kw = (_bert_kw(3) if build is pt.bert else
              dict(batch_size=1, image_size=32, patch=8, hidden=32, layers=3, heads=4,
                   ffn_dim=64, num_classes=10, seed=5))
        q = quantize(build(**kw), [x], TRANSFORMER_INT8_SCAN)
        jq = j_quantize(jbuild(**kw), [x], J_TRANSFORMER_INT8_SCAN)
        assert q.to_json() == jq.to_json()
        assert TRANSFORMER_INT8_SCAN.scale_group == J_TRANSFORMER_INT8_SCAN.scale_group


def _tied_mlp(builder, seed=3, layers=5):
    rng = np.random.default_rng(seed)
    b = builder()
    h = b.var("x", (2, 16), "float32")
    for i in range(layers):
        w = b.const(rng.standard_normal((16, 16)).astype(np.float32) * 0.4, f"layer{i}.w")
        h = b.call("nn.dense", h, w, name=f"layer{i}.fc")
        h = b.call("nn.relu", h, name=f"layer{i}.act")
    return b.build(h)


def test_tied_layers_with_different_weights_give_their_own_outputs():
    """Layers 1-4 share one program and form a scan: each layer's output,
    captured (no scan) or carried (scan), equals the oracle's, the layers'
    outputs differ, and a second input gives the oracle's values again
    (nothing computed from a weight is cached under a node)."""
    d = np.random.default_rng(4).standard_normal((2, 16)).astype(np.float32)
    q = fuse_qnn(quantize(_tied_mlp(GraphBuilder), [d], QConfig(scale_group=r"layer\d+")))
    jq = j_fuse_qnn(j_quantize(_tied_mlp(JGraphBuilder), [d], JQConfig(scale_group=r"layer\d+")))
    assert q.to_json() == jq.to_json()
    layers = [f"layer{i}.act_rq" for i in range(5)]
    shared = SegmentedExecutor(q, capture=layers, min_ops=1, max_ops=40, device="cpu")
    scanned = SegmentedExecutor(q, min_ops=1, max_ops=40, device="cpu")
    assert shared.n_programs == scanned.n_programs == 4 and len(shared.segments) == 7
    assert shared.scan_runs == [] and scanned.scan_runs == [(2, 4, 0)]
    names = computational_nodes(q)
    for seed in (5, 6):
        x = np.random.default_rng(seed).standard_normal((2, 16)).astype(np.float32)
        want = dict(zip(names, TorchExecutor(q, capture=names, device="cpu").run(x)))
        oracle = run_graph(q, x)[0]
        got = shared.run(x)
        for nm, v in zip(layers, got):
            assert (v == want[nm]).all(), nm
        assert all((a != b).any() for a, b in zip(got, got[1:]))
        _same(scanned.run(x)[0], oracle)
        _same(scanned.run(x)[0], np.asarray(j_run_graph(jq, x)[0]))
    # a scan member's params are views of its run's stacks, made once
    stacks = scanned._scans[2]["stacks"]
    for k in range(4):
        for p, st in zip(scanned._seg_params[2 + k], stacks):
            assert p._base is st and p.data_ptr() == st[k].data_ptr()
    assert scanned.stacked_bytes == sum(np.asarray(v).nbytes for k in range(2, 6)
                                        for v in scanned.segments[k].params_np.values())


def test_capture_and_run_stream_follow_the_jax_package():
    """Every node captured through the segmented executor equals the
    whole-graph executor's, and `run_stream` hands over the JAX package's
    names in its order with its values."""
    g, jg = pt.bert(**_bert_kw(2)), jt.bert(**_bert_kw(2))
    calib = [_ids(100, (2, 16))]
    q = quantize(g, calib, TRANSFORMER_INT8)
    jq = j_quantize(jg, calib, J_TRANSFORMER_INT8)
    names = computational_nodes(q)
    assert names == j_computational_nodes(jq)
    x = calib[0]
    seg = SegmentedExecutor(q, capture=names, min_ops=16, max_ops=120, device="cpu")
    whole = TorchExecutor(q, capture=names, device="cpu").run(x)
    for nm, a, b in zip(names, seg.run(x), whole):
        assert (a == b).all(), nm
    mine, theirs = [], []
    run_stream(seg, x, lambda nm, v: mine.append((nm, v)))
    jseg = JSegmentedExecutor(jq, capture=names, min_ops=16, max_ops=120)
    j_run_stream(jseg, x, lambda nm, v: theirs.append((nm, v)))
    assert [nm for nm, _ in mine] == [nm for nm, _ in theirs]
    for (nm, a), (_, b) in zip(mine, theirs):
        _same(a, b, nm)


def test_segmented_trace_is_byte_equal_to_the_jax_package():
    g, jg = pt.bert(**_bert_kw(2)), jt.bert(**_bert_kw(2))
    calib = [_ids(100, (2, 16))]
    q = quantize(g, calib, TRANSFORMER_INT8)
    jq = j_quantize(jg, calib, J_TRANSFORMER_INT8)
    x = calib[0]
    blob = emit_trace(q, x, backend="torch-segmented", device="cpu")
    assert blob == j_emit_trace(jq, x, backend="jax-segmented")
    assert blob == j_emit_trace(jq, x, backend="numpy")
    assert blob == emit_trace(q, x, backend="torch", device="cpu")
    assert verify_trace(blob, q)["mismatches"] == []
    em = TraceEmitter(q, backend="torch-segmented", device="cpu")
    assert isinstance(em._executor, SegmentedExecutor) and em._executor.scan_runs == []


def test_torch_cpu_calibration_matches_the_oracle(rng):
    """tests/test_quantize.py's rule for the JAX package's "xla-cpu": every
    scale within 1e-4 relative of the oracle's, and the quantized graph
    equals the oracle-calibrated one's integers on the executor."""
    from dataclasses import replace

    from tachikoma_tpu_torch.models.vision import lenet5

    g = lenet5(batch_size=2)
    data = [rng.standard_normal((2, 28, 28, 1)).astype(np.float32) for _ in range(2)]
    c1 = calibrate(g, data, QConfig())
    cfg = replace(QConfig(), calibrate_backend="torch-cpu")
    c2 = calibrate(g, data, cfg)
    assert set(c1.stats) == set(c2.stats)
    for k in c1.stats:
        s1, _ = c1.scale_zp(k)
        s2, _ = c2.scale_zp(k)
        assert abs(s1 - s2) / max(s1, 1e-12) < 1e-4, k
    qg = quantize(g, data, cfg)
    o = run_graph(qg, data[0])
    t = TorchExecutor(qg, device="cpu").run(data[0])
    for a, c in zip(o, t):
        _same(c, a)
    with pytest.raises(NotImplementedError, match="torch-cpu"):
        calibrate(g, data, replace(QConfig(), calibrate_backend="xla-cpu"))


def test_cli_run_segmented_and_trace_backend(tmp_path, capsys, gpt2_int8):
    graphs, x = gpt2_int8
    f, _ = graphs["tied"]
    path = str(tmp_path / "g.json")
    with open(path, "w") as fh:
        fh.write(f.to_json())
    np.save(tmp_path / "x.npy", x)
    out = str(tmp_path / "o.npz")
    cli_main(["run", path, "--segmented", "--device", "cpu", "--input",
              str(tmp_path / "x.npy"), "-o", out])
    got = np.load(out)[f.outputs[0]]
    _same(got, run_graph(f, x)[0])
    q = graphs["untied"][0]
    qpath, trace = str(tmp_path / "q.json"), str(tmp_path / "q.bin")
    with open(qpath, "w") as fh:
        fh.write(q.to_json())
    cli_main(["trace", qpath, "-o", trace, "--backend", "torch-segmented", "--device", "cpu",
              "--input", str(tmp_path / "x.npy")])
    with open(trace, "rb") as fh:
        assert fh.read() == emit_trace(q, x, backend="torch", device="cpu",
                                       meta={"model": qpath})
    assert "records" in capsys.readouterr().out


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegmentedExecutor(pt.bert(**_bert_kw(2)))
