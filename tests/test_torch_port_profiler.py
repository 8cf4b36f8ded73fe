"""The port's profiler on the CPU, against the JAX package's
(`tests/test_profiler.py`'s graphs): `graph_flops` equals the JAX package's
on float, quantized and fused graphs; the isolated per-op report and the
cut-point ablation (cuts at `segmented.partition`'s points, the JAX
package's) render their table, CSV and JSON; the CLI's `profile`."""

import json

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu import infer_types as j_infer_types
from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder
from tachikoma_tpu.models import transformer as jt
from tachikoma_tpu.models import vision as jv
from tachikoma_tpu.quantize.config import TRANSFORMER_INT8 as J_TRANSFORMER_INT8
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.runtime.profiler import graph_flops as j_graph_flops
from tachikoma_tpu.runtime.segmented import partition as j_partition
from tachikoma_tpu_torch import GraphBuilder, infer_types
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.models import transformer as pt
from tachikoma_tpu_torch.models import vision as pv
from tachikoma_tpu_torch.quantize.config import TRANSFORMER_INT8
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.runtime.profiler import (PEAKS, ablate_graph, graph_flops,
                                                  profile_graph)

BERT = dict(batch_size=2, seq_len=16, hidden=32, layers=2, heads=4, ffn_dim=64, vocab=100, seed=0)


@pytest.mark.parametrize("model", ["resnet18", "bert"])
def test_graph_flops_equal_the_jax_package(model):
    if model == "resnet18":
        g, jg = (pv.resnet(18, batch_size=1, image_size=32),
                 jv.resnet(18, batch_size=1, image_size=32))
        x = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(np.float32)
        q, jq = quantize(g, [x]), j_quantize(jg, [x])
    else:
        g, jg = pt.bert(**BERT), jt.bert(**BERT)
        x = np.random.default_rng(0).integers(0, 100, (2, 16)).astype(np.int32)
        q, jq = quantize(g, [x], TRANSFORMER_INT8), j_quantize(jg, [x], J_TRANSFORMER_INT8)
    for mine, theirs in ((g, jg), (q, jq), (fuse_qnn(q), j_fuse_qnn(jq))):
        assert graph_flops(mine) == j_graph_flops(theirs) > 0


@pytest.fixture(scope="module")
def report():
    g = pv.lenet5(batch_size=1)
    rng = np.random.default_rng(0)
    data = [rng.standard_normal((1, 28, 28, 1)).astype(np.float32) for _ in range(2)]
    qg = quantize(g, data)
    return profile_graph(qg, data[0], repeats=2, fuse=True, device="cpu")


def test_report_entries(report):
    assert len(report.entries) > 5
    assert "tk.conv2d_rq" in {e.op for e in report.entries}
    conv = next(e for e in report.entries if e.op == "tk.conv2d_rq")
    assert conv.flops > 0 and conv.time_s > 0 and conv.gops > 0 and conv.bytes > 0
    assert report.device == "cpu"


def test_report_formats(report):
    table = report.table(top=5)
    assert "time_ms" in table and "GOPS" in table and len(table.splitlines()) == 7
    assert report.csv().splitlines()[0].startswith("name,op")
    d = json.loads(report.json())
    assert d["total_time_ms"] > 0 and len(d["ops"]) == len(report.entries)
    assert report.whole_graph_time_s is not None and report.whole_graph_time_s > 0


def _conv_stack(builder, infer, seed=1):
    rng = np.random.default_rng(seed)
    b = builder()
    h = b.var("x", (2, 16, 16, 8), "float32")
    for i in range(4):
        w = b.const(rng.standard_normal((3, 3, 8, 8)).astype(np.float32) * 0.2, f"w{i}")
        h = b.call("nn.conv2d", h, w, padding=(1, 1, 1, 1), name=f"c{i}")
        h = b.call("nn.relu", h, name=f"r{i}")
    return infer(b.build(h))


def test_ablate_graph_cumulative():
    """Cumulative times are positive, deltas sum to the full-graph time, the
    cuts are the JAX package's partition points."""
    g = _conv_stack(GraphBuilder, infer_types)
    jg = _conv_stack(JGraphBuilder, j_infer_types)
    xin = np.random.default_rng(2).standard_normal((2, 16, 16, 8)).astype(np.float32)
    rep = ablate_graph(g, xin, min_ops=2, max_ops=4, repeats=1, device="cpu")
    cuts = [seg[-1].name for seg in j_partition(jg, min_ops=2, max_ops=4)]
    assert [e.label for e in rep.entries] == cuts and len(cuts) >= 2
    assert rep.entries[-1].label == g.outputs[0]
    cum = [e.cumulative_s for e in rep.entries]
    assert all(c > 0 for c in cum)
    assert abs(sum(e.delta_s for e in rep.entries) - cum[-1]) < 1e-9
    assert sum(e.n_ops for e in rep.entries) == 8
    assert "cum ms" in rep.table() and "cumulative_ms" in rep.csv()
    assert len(json.loads(rep.json())["entries"]) == len(cuts)


def test_profile_cli_and_peaks(tmp_path, capsys):
    rng = np.random.default_rng(3)
    b = GraphBuilder()
    x = b.var("x", (1, 8, 8, 4), "float32")
    w = b.const(rng.standard_normal((3, 3, 4, 4)).astype(np.float32), "w")
    h = b.call("nn.relu", b.call("nn.conv2d", x, w, padding=(1, 1, 1, 1)))
    p = tmp_path / "g.json"
    p.write_text(infer_types(b.build(h)).to_json())
    cli_main(["profile", str(p), "--mode=ablate", "--format=json", "--repeats", "1",
              "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"
    cli_main(["profile", str(p), "--mode", "isolated", "--top", "1", "--repeats", "1",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "total per-op" in out and "whole-graph" in out
    assert PEAKS["NVIDIA H100 80GB HBM3"]["int8_ops"] == 1979e12
    assert not any(k.lower().startswith("tpu") for k in PEAKS)


def test_profiler_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _conv_stack(GraphBuilder, infer_types)
    x = np.zeros((2, 16, 16, 8), np.float32)
    for fn in (profile_graph, ablate_graph):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(g, x)
