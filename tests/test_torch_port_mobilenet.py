"""MobileNetV2 through the port on the CPU, against the JAX package: the zoo
graph, quantize, fuse_qnn, the fused and unfused executors (K5's plain
versions), and the trace.

Integers are compared with ==; float nodes and float trace records with
rtol 1e-5, atol 1e-6 (tests/test_torch_trace.py's rule)."""

import io

import numpy as np
import pytest

from tachikoma_tpu.models.vision import mobilenet_v2 as j_mobilenet_v2
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace import format as j_format
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu.trace.emitter import verify_trace as j_verify_trace
from tachikoma_tpu_torch import run_graph
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.models.vision import mobilenet_v2
from tachikoma_tpu_torch.ops.kernels import conv
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace

RTOL, ATOL = 1e-5, 1e-6
BATCH, SIZE = 2, 64


@pytest.fixture(scope="module")
def mbv2():
    rng = np.random.default_rng(7)
    calib = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    jq = j_quantize(j_mobilenet_v2(batch_size=BATCH, image_size=SIZE), [calib])
    return jq, from_reference_graph(jq.to_json()), x, calib


@pytest.mark.parametrize("batch,size", [(2, 64), (1, 224)])
def test_zoo_graph_equals_reference(batch, size):
    g = mobilenet_v2(batch_size=batch, image_size=size, seed=3)
    ref = j_mobilenet_v2(batch_size=batch, image_size=size, seed=3)
    assert g.structural_hash() == ref.structural_hash()
    assert g.structural_hash(include_params=True) == ref.structural_hash(include_params=True)
    assert g.params.keys() == ref.params.keys()
    for k, v in ref.params.items():
        assert g.params[k].dtype == v.dtype and (g.params[k] == v).all(), k
    groups = [n.attrs["groups"] for n in g.nodes if n.op == "nn.conv2d"
              and n.attrs.get("groups", 1) > 1]
    assert len(groups) == 17


def test_quantize_and_fuse_equal_reference(mbv2):
    jq, q, x, calib = mbv2
    own = quantize(mobilenet_v2(batch_size=BATCH, image_size=SIZE), [calib])
    assert own.to_json() == jq.to_json()
    fused = fuse_qnn(q)
    assert fused.structural_bytes() == j_fuse_qnn(jq).structural_bytes()
    ops = [n.op for n in fused.nodes if n.op not in ("var", "const")]
    assert {op: ops.count(op) for op in set(ops)} == {
        "tk.conv2d_rq": 52, "qnn.add": 10, "tk.dense_rq": 1, "qnn.quantize": 1,
        "nn.global_avg_pool2d": 1, "qnn.dequantize": 1, "nn.softmax": 1}
    dw = [n for n in fused.nodes if n.op == "tk.conv2d_rq" and n.attrs.get("groups", 1) > 1]
    assert len(dw) == 17
    # ReLU6 folded into the requantize bounds, per-channel multipliers
    assert all(n.attrs["a_min"] >= -128 and n.attrs["a_max"] < 127 for n in dw)
    assert all(len(set(np.atleast_1d(n.attrs["multiplier"]))) > 1 for n in dw)


@pytest.mark.parametrize("fuse", [True, False])
def test_executor_matches_jax_executor_and_oracle(mbv2, monkeypatch, fuse):
    jq, q, x, _ = mbv2
    g = fuse_qnn(q) if fuse else q
    names = computational_nodes(g)
    calls = []
    for mode in ("qdwconv_rq", "qdwconv_raw"):
        fn = getattr(conv, mode)
        monkeypatch.setattr(conv, mode, lambda *a, _fn=fn, _m=mode, **k: (
            calls.append(_m), _fn(*a, **k))[1])
    got = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
    assert calls == ["qdwconv_rq" if fuse else "qdwconv_raw"] * 17
    want = JaxExecutor(jq, capture=names, fuse=fuse).run(x)
    oracle = {}
    run_graph(g, x, intercept=lambda name, op, args, out: oracle.__setitem__(name, out))
    n_int = 0
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{name} vs JaxExecutor")
            np.testing.assert_array_equal(a, oracle[name], err_msg=f"{name} vs oracle")
            n_int += 1
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert n_int == len(names) - 2 and len(names) == (67 if fuse else 208)


def test_trace_matches_reference_and_verifies(mbv2, tmp_path):
    jq, q, x, _ = mbv2
    blob = emit_trace(q, x, backend="torch", device="cpu")
    r = fmt.TraceReader(io.BytesIO(blob))
    ref = j_format.TraceReader(io.BytesIO(j_emit_trace(jq, x, backend="jax")))
    assert r.graph_hash == ref.graph_hash and len(r) == len(ref) == 208 and r.meta == ref.meta
    n_int = 0
    for a, b in zip(r, ref):
        assert (a.node_id, a.name, a.op_name, a.attrs) == (b.node_id, b.name, b.op_name, b.attrs)
        assert fmt.op_id(a.op_name) == j_format.op_id(b.op_name)
        if a.output.to_array().dtype.kind in "iu":
            assert a.encode() == b.encode(), f"record bytes differ: {a.name}"
            n_int += 1
        else:
            for ta, tb in zip(a.tensors, b.tensors):
                np.testing.assert_allclose(ta.to_array(), tb.to_array(), rtol=RTOL, atol=ATOL)
    assert n_int == 206
    assert sum(a.attrs.get("groups", 1) > 1 for a in r if a.op_name == "qnn.conv2d") == 17
    path = tmp_path / "mbv2.bin"
    path.write_bytes(blob)
    res = j_verify_trace(str(path), jq)
    assert res["verified"] == res["records"] == 208, res["mismatches"][:3]
