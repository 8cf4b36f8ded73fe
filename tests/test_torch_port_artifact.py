"""The `.tkmod` artifact and the trained MobileNetV2 fixture through the port
on the CPU, against the JAX package.

  * `.tkmod` files move both ways between the packages: same bytes, same
    structural hash, == params, the tuning file passed through;
  * `tests/fixtures/synth_mbv2.tkmod` (a trained MobileNetV2 imported from
    NCHW torch) and `tests/fixtures/synth_resnet.tkmod` (a trained ResNet)
    load in the port to the reference's hash, quantize to the reference's
    JSON, and run fused and unfused == `JaxExecutor` on every integer node;
  * the ops the fixture adds (`transpose`, `nn.batch_flatten`,
    `nn.adaptive_avg_pool2d`): the port's oracle and torch impl == the JAX
    package's oracle;
  * the CLI's `compile` and `.tkmod` inputs.
"""

import io
import pathlib
import tarfile

import numpy as np
import pytest
import torch

from tachikoma_tpu.ir.graph import Node as JNode
from tachikoma_tpu.ir.registry import get_op as j_get_op
from tachikoma_tpu.models.vision import mobilenet_v2 as j_mobilenet_v2
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.artifact import load_artifact as j_load_artifact
from tachikoma_tpu.runtime.artifact import save_artifact as j_save_artifact
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu_torch import Node
from tachikoma_tpu_torch.cli import main as cli_main
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.ir.registry import get_op
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.artifact import load_artifact, save_artifact
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "synth_mbv2.tkmod"
RESNET_FIXTURE = FIXTURE.with_name("synth_resnet.tkmod")
RTOL, ATOL = 1e-5, 1e-6


def _same_graph(a, b):
    assert a.structural_hash(include_params=True) == b.structural_hash(include_params=True)
    assert a.params.keys() == b.params.keys()
    for k, v in b.params.items():
        assert a.params[k].dtype == v.dtype and (a.params[k] == v).all(), k


@pytest.fixture(scope="module")
def small_q():
    rng = np.random.default_rng(2)
    calib = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    jq = j_quantize(j_mobilenet_v2(batch_size=1, image_size=32), [calib])
    return jq, from_reference_graph(jq.to_json())


def test_artifacts_move_both_ways(small_q, tmp_path):
    jq, q = small_q
    meta = {"source": "mobilenet_v2", "seed": 2}
    j_path, p_path = tmp_path / "j.tkmod", tmp_path / "p.tkmod"
    j_save_artifact(str(j_path), jq, meta=meta)
    save_artifact(str(p_path), q, meta=meta)
    assert p_path.read_bytes() == j_path.read_bytes()
    g, man = load_artifact(str(j_path))
    jg, jman = j_load_artifact(str(p_path))
    assert man == jman and man["meta"] == meta and "_tune_jsonl" not in man
    _same_graph(g, jq)
    _same_graph(jg, q)


def test_a_tuning_file_comes_back_in_the_manifest(small_q, tmp_path):
    """A .tkmod the JAX package wrote with its tuning database loads in the
    port, the database returned as the JAX package returns it."""
    jq, _ = small_q
    tune = tmp_path / "tune.jsonl"
    tune.write_text('{"workload": "w", "config": [1, 2]}\n')
    path = str(tmp_path / "j.tkmod")
    j_save_artifact(path, jq, tune_db_path=str(tune))
    g, man = load_artifact(path)
    assert man == j_load_artifact(path)[1] and man["_tune_jsonl"] == tune.read_text()
    _same_graph(g, jq)


def test_artifact_refuses_a_tampered_param(small_q, tmp_path):
    good, bad = tmp_path / "good.tkmod", tmp_path / "bad.tkmod"
    save_artifact(str(good), small_q[1])
    tampered = None
    with tarfile.open(good, "r:gz") as src, tarfile.open(bad, "w:gz") as dst:
        for m in src.getmembers():
            data = src.extractfile(m).read()
            if tampered is None and m.name.startswith("params/"):
                arr = np.load(io.BytesIO(data)).copy()
                arr.flat[0] += 1
                buf = io.BytesIO()
                np.save(buf, arr)
                data, tampered = buf.getvalue(), m.name
            dst.addfile(m, io.BytesIO(data))
    assert tampered is not None
    with pytest.raises(ValueError, match="hash mismatch"):
        load_artifact(str(bad))
    with pytest.raises(ValueError, match="hash mismatch"):
        j_load_artifact(str(bad))


@pytest.fixture(scope="module")
def fixture_graphs():
    jg, _ = j_load_artifact(str(FIXTURE))
    g, _ = load_artifact(str(FIXTURE))
    rng = np.random.default_rng(11)
    shape = g.inputs[0].shape
    calib = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return jg, g, j_quantize(jg, [calib]), quantize(g, [calib]), x


def test_fixture_loads_and_quantizes_as_the_reference(fixture_graphs):
    jg, g, jq, q, _ = fixture_graphs
    _same_graph(g, jg)
    assert tuple(g.inputs[0].shape) == (8, 3, 64, 64)
    assert q.to_json() == jq.to_json()
    ops = [n.op for n in q.nodes]
    assert ops.count("transpose") == 2 and "nn.adaptive_avg_pool2d" in ops
    assert "nn.batch_flatten" in ops
    dw = [n for n in q.nodes if n.op == "qnn.conv2d" and n.attrs.get("groups", 1) > 1]
    assert sorted(n.attrs["groups"] for n in dw) == [16, 64, 96, 96, 128, 128]


@pytest.mark.parametrize("fuse", [True, False])
def test_fixture_executors_match_jax_executor(fixture_graphs, fuse):
    _, _, jq, q, x = fixture_graphs
    names = computational_nodes(fuse_qnn(q) if fuse else q)
    got = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
    want = JaxExecutor(jq, capture=names, fuse=fuse).run(x)
    n_int = 0
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
            n_int += 1
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    # all but the float transpose at the input and the final dequantize
    assert n_int == len(names) - 2


@pytest.fixture(scope="module")
def resnet_fixture_graphs():
    jg, _ = j_load_artifact(str(RESNET_FIXTURE))
    g, _ = load_artifact(str(RESNET_FIXTURE))
    rng = np.random.default_rng(11)
    shape = g.inputs[0].shape
    calib = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return jg, g, j_quantize(jg, [calib]), quantize(g, [calib]), x


def test_resnet_fixture_loads_and_quantizes_as_the_reference(resnet_fixture_graphs):
    jg, g, jq, q, _ = resnet_fixture_graphs
    _same_graph(g, jg)
    assert q.to_json() == jq.to_json()
    assert sum(n.op == "qnn.add" for n in q.nodes) > 0


@pytest.mark.parametrize("fuse,n_nodes", [(True, 21), (False, 73)])
def test_resnet_fixture_executors_match_jax_executor(resnet_fixture_graphs, fuse, n_nodes):
    _, _, jq, q, x = resnet_fixture_graphs
    names = computational_nodes(fuse_qnn(q) if fuse else q)
    assert len(names) == n_nodes
    got = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
    want = JaxExecutor(jq, capture=names, fuse=fuse).run(x)
    n_int = 0
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
            n_int += 1
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert n_int >= len(names) - 2


def _port_and_reference(op, attrs, x):
    node = Node("n", op, ("i0",), attrs)
    want = j_get_op(op).np_impl(x, node=JNode("n", op, ("i0",), attrs))
    outs = [get_op(op).np_impl(x, node=node),
            get_op(op).torch_impl(torch.from_numpy(np.ascontiguousarray(x)), node=node).numpy()]
    for o in outs:
        assert o.dtype == want.dtype and o.shape == want.shape
    return outs, want


@pytest.mark.parametrize("axes", [(0, 2, 3, 1), (0, 3, 1, 2), None, (1, 0, 3, 2)])
def test_transpose_and_batch_flatten_match_reference(rng, axes):
    x = rng.integers(-128, 128, (2, 3, 4, 5)).astype(np.int8)
    outs, want = _port_and_reference("transpose", {} if axes is None else dict(axes=axes), x)
    for o in outs:
        np.testing.assert_array_equal(o, want)
    outs, want = _port_and_reference("nn.batch_flatten", {}, want)
    for o in outs:
        np.testing.assert_array_equal(o, want)


@pytest.mark.parametrize("output_size", [(1, 1), 1, (2, 3), (3, 2)])
def test_adaptive_avg_pool_matches_reference(rng, output_size):
    x = rng.integers(-128, 128, (2, 4, 6, 6)).astype(np.int8)
    x[0, :, :, :2] = 0
    x[0, 0, 0, :2] = [12, -12]     # +-12/24 in the (1, 1) pool: halves round away from 0
    outs, want = _port_and_reference("nn.adaptive_avg_pool2d",
                                     dict(output_size=output_size), x)
    for o in outs:
        np.testing.assert_array_equal(o, want)
    xf = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    outs, want = _port_and_reference("nn.adaptive_avg_pool2d",
                                     dict(output_size=output_size), xf)
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=RTOL, atol=ATOL)


def test_cli_compile_and_tkmod_inputs(tmp_path, capsys):
    art = str(tmp_path / "m.tkmod")
    cli_main(["compile", "mobilenet_v2", "--image-size", "32", "-o", art])
    jg, man = j_load_artifact(art)
    assert man["meta"] == {"source": "mobilenet_v2"} and "_tune_jsonl" not in man
    assert any(n.op == "qnn.conv2d" and n.attrs.get("groups", 1) == 96 for n in jg.nodes)
    cli_main(["info", art])
    cli_main(["run", art, "--device", "cpu"])
    trace = str(tmp_path / "m.bin")
    cli_main(["trace", art, "-o", trace, "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli_main(["verify", trace, "--graph", art])
    assert e.value.code == 0
    cli_main(["compile", str(FIXTURE), "-o", str(tmp_path / "f.tkmod")])
    out = capsys.readouterr().out
    assert "wrote" in out and "prob: float32[1, 1000]" in out and "verified 208/208" in out
    g, _ = load_artifact(str(tmp_path / "f.tkmod"))
    assert any(n.op == "qnn.conv2d" for n in g.nodes)
