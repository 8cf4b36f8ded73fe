"""DeepLabV3-ResNet-50 (models/onnx_deeplab.py, written as torch.onnx.export
lays out torchvision's model) at a narrow width on the CPU, against the JAX
package: both packages' `from_onnx` import the same bytes into the same
graph JSON, quantize (the bilinear Resize left in float, `deeplab_qconfig`)
and fuse it alike, and the port's fused and unfused graphs equal one XLA run
of the JAX package's at every node (integers with ==, floats within rtol
1e-5, atol 1e-5); the port's TKTRACE1 trace is byte-equal to the JAX
package's oracle-backend trace and verifies (its XLA-backend trace differs
only in the logits' float Resize, by an ulp, while every integer node
equals XLA's above).  The narrow model keeps output
stride 8 on a 104^2 input (13^2 maps, where the outer taps of the rate-12
branch land at the corners) and two blocks in layer4 (dilations 2 and 4).
The writer's layout is checked at the published configuration."""

import io

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu.frontend.onnx import from_onnx as j_from_onnx
from tachikoma_tpu.quantize.config import QConfig as JQConfig
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch.frontend import from_onnx
from tachikoma_tpu_torch.frontend.onnx_proto import load_model
from tachikoma_tpu_torch.models.onnx_deeplab import FLOAT_OPS, deeplab_qconfig, deeplabv3_onnx
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

RTOL, ATOL = 1e-5, 1e-5
NARROW = dict(layers=(1, 1, 1, 2), width=8, aspp_channels=32)
SIDE = 104
# the fused graph's dilated tk.conv2d_rq (dilation, groups): layer4 at 2 and
# 4, the ASPP at 12, 24 and 36
GEOMETRY = [(2, 1), (4, 1), (12, 1), (24, 1), (36, 1)]


def _geometry(graph):
    out = []
    for n in graph.nodes:
        if n.op != "tk.conv2d_rq":
            continue
        d, g = tuple(n.attrs.get("dilation", (1, 1))), int(n.attrs.get("groups", 1))
        if d != (1, 1) or g != 1:
            out.append((d[0], g))
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path in one thread: the suite runs a worker a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(5)
    shape = (1, 3, SIDE, SIDE)
    blob = deeplabv3_onnx(1, SIDE, **NARROW)
    g, jg = from_onnx(blob), j_from_onnx(blob)
    calib, x = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return (g, jg, quantize(g, [calib], deeplab_qconfig()),
            j_quantize(jg, [calib], JQConfig(float_ops=FLOAT_OPS)), x)


def test_import_quantize_and_fuse_equal_reference(model):
    g, jg, q, jq, _ = model
    assert g.to_json() == jg.to_json()
    assert q.to_json() == jq.to_json()
    fused = fuse_qnn(q)
    assert fused.to_json() == j_fuse_qnn(jq).to_json()
    assert _geometry(fused) == GEOMETRY


@pytest.fixture(scope="module")
def reference(model):
    """Every computational node of the JAX package's unfused graph, from one
    XLA run.  Its fused graph names each fused node after the node it ends
    and computes the same integers there, so the one run holds both of the
    port's graphs."""
    _, _, q, jq, x = model
    names = computational_nodes(q)
    return dict(zip(names, JaxExecutor(jq, capture=names).run(x)))


@pytest.mark.parametrize("fuse", [True, False])
def test_every_integer_node_equals_jax_executor(model, reference, fuse):
    _, _, q, _, x = model
    g = fuse_qnn(q) if fuse else q
    names = computational_nodes(g)
    got = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
    n_int = 0
    for nm, a in zip(names, got):
        b = np.asarray(reference[nm])
        assert a.dtype == b.dtype and a.shape == b.shape, nm
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{nm} ({g[nm].op})")
            n_int += 1
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=nm)
    assert n_int == sum(g[n].dtype.startswith("int") for n in names) > 0


def test_traces_are_byte_equal_and_verify(model):
    _, _, q, jq, x = model
    blob = emit_trace(q, x, backend="torch", device="cpu")
    assert blob == j_emit_trace(jq, x, backend="oracle")
    r = fmt.TraceReader(io.BytesIO(blob))
    assert len(r) == len(computational_nodes(q))
    res = verify_trace(blob, q)
    assert res["verified"] == res["records"] == len(r), res["mismatches"][:3]


def test_deeplab_writer_lays_out_torchvision_deeplabv3():
    """The published configuration's layout at a narrow width: 61 convs (53
    in the backbone, six in the ASPP, two in the head), the eleven dilated
    ones at torchvision's dilations, the pooling branch and the logits
    resized bilinearly to static sizes; seeded."""
    blob = deeplabv3_onnx(1, 64, width=8, aspp_channels=16)
    nodes = load_model(blob)["graph"]["node"]
    convs = [n for n in nodes if n["op_type"] == "Conv"]

    def attr(n, key):
        a = next(a for a in n["attribute"] if a["name"] == key)
        return a.get("ints") or a.get("s") or a.get("i")

    dil = [attr(n, "dilations")[0] for n in convs]
    assert len(convs) == 61 and sorted(d for d in dil if d > 1) == [2] * 6 + [4] * 2 + [12, 24, 36]
    assert [d for d in dil if d > 1][:8] == [2, 2, 2, 2, 2, 2, 4, 4]
    assert all(attr(n, "pads") == [d] * 4 for n, d in zip(convs, dil) if d > 1)
    resizes = [n for n in nodes if n["op_type"] == "Resize"]
    assert len(resizes) == 2 and all(
        attr(n, "mode") == b"linear" and attr(n, "coordinate_transformation_mode")
        == b"pytorch_half_pixel" and n["input"][1:3] == ["", ""] for n in resizes)
    assert [n["op_type"] for n in nodes].count("Concat") == 1
    g = from_onnx(blob)
    assert g[g.outputs[0]].shape == (1, 21, 64, 64)  # NCHW, as torch.onnx writes it
    assert deeplabv3_onnx(1, 32, width=8, aspp_channels=16, seed=1) == deeplabv3_onnx(
        1, 32, width=8, aspp_channels=16, seed=1)
    assert deeplabv3_onnx(1, 32, width=8, aspp_channels=16, seed=1) != deeplabv3_onnx(
        1, 32, width=8, aspp_channels=16, seed=2)
