"""The port's IR, model zoo, quantizer and fusion against the JAX
package's: the same seed and calibration batch give graphs with equal
structural bytes (params included)."""

import numpy as np
import pytest

from tachikoma_tpu.ir.graph import Graph as JGraph
from tachikoma_tpu.ir.transforms import simplify as j_simplify
from tachikoma_tpu.models.vision import resnet as j_resnet
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu_torch import GraphBuilder, infer_types
from tachikoma_tpu_torch.interop import from_reference_graph
from tachikoma_tpu_torch.ir.graph import Graph
from tachikoma_tpu_torch.ir.infer import TypeError_
from tachikoma_tpu_torch.ir.registry import OpNotRegistered
from tachikoma_tpu_torch.ir.transforms import simplify
from tachikoma_tpu_torch.models.vision import resnet
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn


@pytest.mark.parametrize("layers,size", [(18, 32), (50, 64)])
def test_resnet_graphs_match_reference(layers, size):
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    g, jg = resnet(layers, batch_size=2, image_size=size), j_resnet(layers, batch_size=2,
                                                                   image_size=size)
    assert g.structural_bytes(include_params=True) == jg.structural_bytes(include_params=True)
    assert (simplify(g).structural_bytes(include_params=True)
            == j_simplify(jg).structural_bytes(include_params=True))
    q, jq = quantize(g, [x]), j_quantize(jg, [x])
    assert q.structural_bytes(include_params=True) == jq.structural_bytes(include_params=True)
    f, jf = fuse_qnn(q), j_fuse_qnn(jq)
    assert f.structural_bytes(include_params=True) == jf.structural_bytes(include_params=True)
    ops = {n.op for n in f.nodes}
    assert {"tk.conv2d_rq", "tk.dense_rq", "tk.conv2d_chain"} <= ops


def test_graph_json_round_trips_between_packages():
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
    jq = j_quantize(j_resnet(18, batch_size=1, image_size=32), [x])
    want = jq.structural_bytes(include_params=True)
    # params embedded in the JSON, and handed over separately
    assert from_reference_graph(jq.to_json()).structural_bytes(include_params=True) == want
    g = from_reference_graph(jq.to_json(include_params=False), dict(jq.params))
    assert g.structural_bytes(include_params=True) == want
    for name, arr in jq.params.items():
        assert g.params[name].dtype == arr.dtype and g.params[name].tobytes() == arr.tobytes()
    # and back: the port's JSON loads in the JAX package
    assert JGraph.from_json(g.to_json()).structural_bytes(include_params=True) == want


def test_from_reference_graph_refuses_unported_ops():
    from tachikoma_tpu.ir.graph import GraphBuilder as JGraphBuilder

    b = JGraphBuilder()
    x = b.var("x", (1, 3), "float32")
    jg = b.build(b.call("argsort", x, axis=-1))
    with pytest.raises(OpNotRegistered):
        from_reference_graph(jg.to_json())


def test_infer_types_reports_the_node():
    b = GraphBuilder()
    x = b.var("x", (1, 8, 8, 4), "float32")
    w = b.const(np.zeros((3, 3, 5, 8), np.float32), name="w")
    g = b.build(b.call("nn.conv2d", x, w, name="bad_conv"))
    with pytest.raises(TypeError_, match="bad_conv"):
        infer_types(g)


def test_graph_rejects_unsorted_nodes():
    from tachikoma_tpu_torch.ir.graph import GraphError, Node

    with pytest.raises(GraphError):
        Graph([Node("a", "nn.relu", ("b",)), Node("b", "var", shape=(1,), dtype="float32")],
              ["a"])
