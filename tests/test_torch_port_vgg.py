"""VGG through the port on the CPU, against the JAX package: the zoo graph,
quantize, fuse_qnn (five chains at VGG-16, the graph tuner's decisions) and
the fused and unfused executors, and the CLI's `quantize vgg16`.

Integers are compared with ==; the float softmax with rtol 1e-5, atol 1e-6
(tests/test_torch_trace.py's rule)."""

import numpy as np
import pytest

from tachikoma_tpu.models.vision import vgg as j_vgg
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu_torch.ir.graph import Graph
from tachikoma_tpu_torch.models import vgg
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

RTOL, ATOL = 1e-5, 1e-6
SIZE = 32
# fused op counts: VGG-11's first two stages have one conv each (no chain)
FUSED_OPS = {
    11: {"tk.conv2d_rq": 2, "tk.conv2d_chain": 3, "nn.max_pool2d": 5, "tk.dense_rq": 3,
         "qnn.quantize": 1, "nn.batch_flatten": 1, "qnn.dequantize": 1, "nn.softmax": 1},
    16: {"tk.conv2d_chain": 5, "nn.max_pool2d": 5, "tk.dense_rq": 3, "qnn.quantize": 1,
         "nn.batch_flatten": 1, "qnn.dequantize": 1, "nn.softmax": 1},
}


@pytest.fixture(scope="module", params=[11, 16])
def quantized(request):
    layers = request.param
    rng = np.random.default_rng(5)
    calib = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    x = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    g = vgg(layers, image_size=SIZE)
    jg = j_vgg(layers, image_size=SIZE)
    return layers, g, jg, quantize(g, [calib]), j_quantize(jg, [calib]), x


def test_zoo_graph_equals_reference(quantized):
    layers, g, jg, _, _, _ = quantized
    assert g.structural_hash() == jg.structural_hash()
    assert g.structural_hash(include_params=True) == jg.structural_hash(include_params=True)
    assert g.params.keys() == jg.params.keys()
    convs = [n for n in g.nodes if n.op == "nn.conv2d"]
    assert len(convs) == layers - 3
    assert all(tuple(g[n.inputs[1]].shape[:2]) == (3, 3) for n in convs)


def test_quantize_and_fuse_equal_reference(quantized):
    layers, _, _, q, jq, _ = quantized
    assert q.to_json() == jq.to_json()
    assert Graph.from_json(jq.to_json()).structural_bytes() == q.structural_bytes()
    fused = fuse_qnn(q)
    assert fused.structural_bytes() == j_fuse_qnn(jq).structural_bytes()
    ops = [n.op for n in fused.nodes if n.op not in ("var", "const")]
    assert {op: ops.count(op) for op in set(ops)} == FUSED_OPS[layers]


@pytest.mark.parametrize("fuse", [True, False])
def test_every_integer_node_equals_jax_executor(quantized, fuse):
    _, _, _, q, jq, x = quantized
    g = fuse_qnn(q) if fuse else q
    names = computational_nodes(g)
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
    assert n_int == len(names) - 2


def test_cli_quantizes_vgg16_as_the_jax_cli(tmp_path):
    from tachikoma_tpu import cli as j_cli
    from tachikoma_tpu_torch import cli

    ours, theirs = tmp_path / "vgg16.json", tmp_path / "vgg16_jax.json"
    cli.main(["quantize", "vgg16", "--image-size", str(SIZE), "-o", str(ours)])
    j_cli.main(["quantize", "vgg16", "--image-size", str(SIZE), "-o", str(theirs)])
    assert ours.read_text() == theirs.read_text()
    q = Graph.from_json(ours.read_text())
    assert sum(n.op == "qnn.conv2d" for n in q.nodes) == 13
    assert sum(n.op == "qnn.dense" for n in q.nodes) == 3
    with pytest.raises(SystemExit, match="unknown zoo model"):
        cli.main(["quantize", "alexnet", "-o", str(ours)])
