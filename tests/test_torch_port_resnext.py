"""ResNeXt-50 32x4d (models/torch_resnet.py, torchvision's `resnext50_32x4d`
layout) at a narrow width on the CPU, against the JAX package: both
packages' `from_torch` import the same module into the same graph JSON,
quantize and fuse it alike, and the port's fused and unfused graphs equal
one XLA run of the JAX package's at every node (integers with ==, floats
within rtol 1e-5, atol 1e-5); the port's TKTRACE1 trace is byte-equal to
the JAX package's oracle-backend trace and verifies.  The narrow model keeps
one block a stage and ResNeXt-50's group widths 4, 8, 16 and 32 (groups 4),
the stride on the grouped 3x3 of stages 2-4.  The module's structure is checked at the published configuration."""

import io

import numpy as np
import pytest
import torch

import tachikoma_tpu.ops.jax_ops  # noqa: F401  (registers the jax impls)
from tachikoma_tpu.frontend.torch_fx import from_torch as j_from_torch
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu.runtime.fuse import fuse_qnn as j_fuse_qnn
from tachikoma_tpu.trace.emitter import emit_trace as j_emit_trace
from tachikoma_tpu_torch.frontend.torch_fx import from_torch
from tachikoma_tpu_torch.models.torch_resnet import ResNet, resnet_torch
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor
from tachikoma_tpu_torch.runtime.fuse import fuse_qnn
from tachikoma_tpu_torch.trace import format as fmt
from tachikoma_tpu_torch.trace.emitter import emit_trace, verify_trace

RTOL, ATOL = 1e-5, 1e-5
NARROW = dict(layers=(1, 1, 1, 1), planes=(16, 32, 64, 128), groups=4, width_per_group=16,
              num_classes=10, probe_size=32)
SHAPE = (2, 3, 32, 32)
# the fused graph's grouped tk.conv2d_rq (dilation, groups)
GEOMETRY = [(1, 4)] * 4


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
    m = resnet_torch(**NARROW)
    g, jg = from_torch(m, {"x": SHAPE}), j_from_torch(m, {"x": SHAPE})
    calib, x = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    return g, jg, quantize(g, [calib]), j_quantize(jg, [calib]), x


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


def test_resnext50_32x4d_is_torchvisions():
    """torchvision's resnext50_32x4d: 25,028,904 parameters, grouped 3x3
    convs of 32 groups at widths 128, 256, 512 and 1024, the stride on the
    first of stages 2-4; the narrow model's weights are seeded."""
    m = ResNet(groups=32, width_per_group=4)
    assert sum(p.numel() for p in m.parameters()) == 25_028_904
    widths = [(blk.conv2.in_channels, blk.conv2.groups, blk.conv2.stride[0])
              for stage in (m.layer1, m.layer2, m.layer3, m.layer4) for blk in stage]
    assert widths == ([(128, 32, 1)] * 3 + [(256, 32, 2)] + [(256, 32, 1)] * 3 + [(512, 32, 2)]
                      + [(512, 32, 1)] * 5 + [(1024, 32, 2)] + [(1024, 32, 1)] * 2)
    a, b = resnet_torch(**NARROW, seed=3), resnet_torch(**NARROW, seed=3)
    assert all(torch.equal(u, v) for u, v in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    c = resnet_torch(**NARROW, seed=4)
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
