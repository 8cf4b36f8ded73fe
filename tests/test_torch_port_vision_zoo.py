"""The rest of the vision zoo (models/vision.py: mlp, lenet5, digits_cnn,
squeezenet, dqn, inception_v3_stem, densenet, dcgan_generator, lstm,
ssd_lite, resnet_3d) through the port on the CPU, against the JAX package.

For each builder, at a small size (the published widths where the graph
fixes them: DQN's 84^2 x 4, LeNet-5's 28^2, the DCGAN's latent 100):
- the zoo graph has the JAX builder's structural hash, with and without
  params, at that size and at the builder's published configuration;
- `quantize` (default QConfig) writes the JAX package's JSON and `fuse_qnn`
  its structural bytes, with the fused op counts below;
- every captured node of `TorchExecutor(device="cpu")`, fused and unfused,
  against `JaxExecutor`'s: integers with ==, floats within rtol 1e-5, atol
  1e-6 (tests/test_torch_trace.py's rule), those a float product or
  convolution reaches (nn.dense, nn.conv2d_transpose, nn.conv3d: another sum
  order) within rtol 1e-4, atol 1e-4 (the float transformers' rule).

The float ops computed outside the exact integer core that feed a
qnn.quantize (DenseNet's batch norms, the LSTM's sigmoid and tanh, SSD-lite's
exp, the 3D ResNet's conv3d and mean) flip no quantized element at these
sizes, so every integer node is held ==, NMS's selected indices included.
"""

import pathlib

import numpy as np
import pytest

from tachikoma_tpu.models import vision as jv
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu_torch.ir.graph import Graph
from tachikoma_tpu_torch.models import vision as pv
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.crosscheck import FLOAT_PRODUCTS, float_source_set
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn

RTOL, ATOL = 1e-5, 1e-6
CONE_RTOL, CONE_ATOL = 1e-4, 1e-4
DIGITS = str(pathlib.Path(__file__).resolve().parent / "fixtures" / "digits_cnn.npz")

# builder -> (small-size arguments, published-configuration arguments)
BUILDERS = {
    "mlp": ({}, {}),
    "lenet5": ({}, {}),
    "digits_cnn": ({"weights": DIGITS, "batch_size": 4}, {"weights": DIGITS}),
    "squeezenet": ({"image_size": 64}, {}),
    "dqn": ({}, {}),
    "inception_v3_stem": ({"image_size": 75}, {}),
    "densenet": ({"image_size": 32, "blocks": (2, 2, 2, 2), "growth": 8}, {}),
    "dcgan_generator": ({}, {}),
    "lstm": ({"seq_len": 4}, {}),
    "ssd_lite": ({"image_size": 64}, {}),
    "resnet_3d": ({"frames": 2, "image_size": 8}, {}),
}

# the fused graphs' op counts at the small sizes (var and const aside)
FUSED_OPS = {
    "mlp": {"nn.softmax": 1, "qnn.dequantize": 1, "qnn.quantize": 1, "tk.dense_rq": 3},
    "lenet5": {"nn.batch_flatten": 1, "nn.max_pool2d": 2, "nn.softmax": 1, "qnn.dequantize": 1,
               "qnn.quantize": 1, "tk.conv2d_rq": 2, "tk.dense_rq": 3},
    "digits_cnn": {"nn.batch_flatten": 1, "nn.max_pool2d": 2, "qnn.dequantize": 1,
                   "qnn.quantize": 1, "tk.conv2d_rq": 2, "tk.dense_rq": 1},
    "squeezenet": {"nn.global_avg_pool2d": 1, "nn.max_pool2d": 3, "nn.softmax": 1,
                   "qnn.concatenate": 8, "qnn.dequantize": 1, "qnn.quantize": 1,
                   "tk.conv2d_rq": 26},
    "dqn": {"nn.batch_flatten": 1, "qnn.dequantize": 1, "qnn.quantize": 1, "tk.conv2d_rq": 3,
            "tk.dense_rq": 2},
    "inception_v3_stem": {"nn.global_avg_pool2d": 1, "nn.max_pool2d": 2, "nn.softmax": 1,
                          "qnn.avg_pool2d": 2, "qnn.concatenate": 2, "qnn.dequantize": 1,
                          "qnn.quantize": 1, "tk.conv2d_chain": 4, "tk.conv2d_rq": 7,
                          "tk.dense_rq": 1},
    "densenet": {"nn.batch_norm": 12, "nn.global_avg_pool2d": 1, "nn.max_pool2d": 1,
                 "nn.relu": 12, "nn.softmax": 1, "qnn.avg_pool2d": 3, "qnn.concatenate": 8,
                 "qnn.dequantize": 13, "qnn.quantize": 21, "tk.conv2d_rq": 12, "tk.dense_rq": 1},
    "dcgan_generator": {"nn.batch_norm": 3, "nn.conv2d_transpose": 4, "nn.relu": 3,
                        "qnn.dequantize": 1, "qnn.quantize": 1, "reshape": 1, "tanh": 1,
                        "tk.dense_rq": 1},
    "lstm": {"nn.bias_add": 4, "nn.softmax": 1, "qnn.add": 8, "qnn.dequantize": 9, "qnn.mul": 12,
             "qnn.quantize": 27, "reshape": 4, "sigmoid": 12, "split": 4, "strided_slice": 4,
             "tanh": 8, "tk.dense_rq": 8, "tuple_get_item": 16},
    "ssd_lite": {"exp": 2, "max": 1, "nn.softmax": 1, "qnn.add": 10, "qnn.concatenate": 3,
                 "qnn.dequantize": 4, "qnn.mul": 4, "qnn.quantize": 3, "qnn.subtract": 2,
                 "reshape": 8, "strided_slice": 5, "tk.conv2d_rq": 56,
                 "vision.non_max_suppression": 1},
    "resnet_3d": {"clip": 8, "mean": 1, "nn.batch_norm": 20, "nn.conv3d": 20, "nn.relu": 9,
                  "nn.softmax": 1, "qnn.add": 8, "qnn.dequantize": 9, "qnn.quantize": 17,
                  "tk.dense_rq": 1},
}


def _feeds(graph, rng):
    return {n.name: rng.standard_normal(n.shape).astype(np.float32) for n in graph.inputs}


@pytest.fixture(scope="module", params=list(BUILDERS))
def zoo(request):
    name = request.param
    small = BUILDERS[name][0]
    g, jg = getattr(pv, name)(**small), getattr(jv, name)(**small)
    rng = np.random.default_rng(7)
    calib, x = _feeds(g, rng), _feeds(g, rng)
    return name, g, jg, quantize(g, [calib]), j_quantize(jg, [calib]), x


def test_zoo_graph_equals_reference(zoo):
    _, g, jg, _, _, _ = zoo
    assert g.structural_hash() == jg.structural_hash()
    assert g.structural_hash(include_params=True) == jg.structural_hash(include_params=True)
    assert g.params.keys() == jg.params.keys()


@pytest.mark.parametrize("name", list(BUILDERS))
def test_published_configuration_equals_reference(name):
    """The builder's default arguments (DenseNet-121, Inception's 299^2,
    ResNet3D-18 at 16 x 112^2, SSD-lite at 320^2, ...): same graph, same
    weights."""
    published = BUILDERS[name][1]
    g, jg = getattr(pv, name)(**published), getattr(jv, name)(**published)
    assert g.structural_hash(include_params=True) == jg.structural_hash(include_params=True)
    assert [(n.name, n.shape, n.dtype) for n in g.inputs] == \
        [(n.name, n.shape, n.dtype) for n in jg.inputs]


def test_quantize_and_fuse_equal_reference(zoo):
    name, _, _, q, jq, _ = zoo
    assert q.to_json() == jq.to_json()
    assert Graph.from_json(jq.to_json()).structural_bytes() == q.structural_bytes()
    fused = fuse_qnn(q)
    assert fused.structural_bytes() == j_fuse_qnn(jq).structural_bytes()
    ops = [n.op for n in fused.nodes if n.op not in ("var", "const")]
    assert {op: ops.count(op) for op in set(ops)} == FUSED_OPS[name]


@pytest.mark.parametrize("fuse", [True, False])
def test_every_integer_node_equals_jax_executor(zoo, fuse):
    name, _, _, q, jq, x = zoo
    g = fuse_qnn(q) if fuse else q
    names = [n for n in computational_nodes(g) if g[n].dtype != "tuple"]  # split's list aside
    cone = float_source_set(g, FLOAT_PRODUCTS, floats_only=True)
    got = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
    want = JaxExecutor(jq, capture=names, fuse=fuse).run(x)
    n_int = 0
    for nm, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, nm
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {nm} ({g[nm].op})")
            n_int += 1
        else:
            rtol, atol = (CONE_RTOL, CONE_ATOL) if nm in cone else (RTOL, ATOL)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{name} {nm}")
    assert n_int > 0 and n_int == sum(g[n].dtype.startswith(("int", "uint")) for n in names)
