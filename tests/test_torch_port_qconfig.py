"""The port's quantizer under ten `QConfig` variants, against the JAX
package's, on ResNet-18 and MobileNetV2 at b2 32 px: the quantized graphs'
structural bytes (params included) are equal, and every integer node of
TorchExecutor(device="cpu"), fused and unfused, == JaxExecutor.  The float
softmax is held within rtol 1e-5, atol 1e-6 (tests/test_torch_trace.py's
rule)."""

import numpy as np
import pytest

from tachikoma_tpu.models.vision import mobilenet_v2 as j_mobilenet_v2
from tachikoma_tpu.models.vision import resnet as j_resnet
from tachikoma_tpu.quantize.config import QConfig as JQConfig
from tachikoma_tpu.quantize.quantizer import quantize as j_quantize
from tachikoma_tpu.runtime.executor import JaxExecutor, computational_nodes
from tachikoma_tpu_torch.models.vision import mobilenet_v2, resnet
from tachikoma_tpu_torch.quantize.config import QConfig
from tachikoma_tpu_torch.quantize.quantizer import quantize
from tachikoma_tpu_torch.runtime.executor import TorchExecutor

RTOL, ATOL = 1e-5, 1e-6
BATCH, SIZE = 2, 32
VARIANTS = {
    "asymmetric": dict(act_symmetric=False),
    "per_tensor_weights": dict(weight_per_channel=False),
    "tonearest": dict(rounding="TONEAREST"),
    "minmax": dict(calibrate_mode="minmax"),
    "percentile": dict(calibrate_mode="percentile"),
    "kl": dict(calibrate_mode="kl"),
    "integer_outputs": dict(dequantize_outputs=False),
    "scale_group_blocks": dict(scale_group=r"b\d+"),
    "scale_group_stages": dict(scale_group=r"s\d+b\d+|ir\d+"),
    "asymmetric_tonearest": dict(act_symmetric=False, rounding="TONEAREST"),
}
MODELS = {
    "resnet18": (lambda: resnet(18, batch_size=BATCH, image_size=SIZE),
                 lambda: j_resnet(18, batch_size=BATCH, image_size=SIZE)),
    "mobilenet_v2": (lambda: mobilenet_v2(batch_size=BATCH, image_size=SIZE),
                     lambda: j_mobilenet_v2(batch_size=BATCH, image_size=SIZE)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_qconfig_variant_equals_the_jax_package(model, variant):
    rng = np.random.default_rng(3)
    calib = [rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    build, j_build = MODELS[model]
    q = quantize(build(), calib, QConfig(**VARIANTS[variant]))
    jq = j_quantize(j_build(), calib, JQConfig(**VARIANTS[variant]))
    assert q.structural_bytes(include_params=True) == jq.structural_bytes(include_params=True)
    for fuse in (False, True):
        names = computational_nodes(q if not fuse else TorchExecutor(q, device="cpu",
                                                                     fuse=True).graph)
        got = TorchExecutor(q, capture=names, device="cpu", fuse=fuse).run(x)
        want = JaxExecutor(jq, capture=names, fuse=fuse).run(x)
        n_int = 0
        for name, a, b in zip(names, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, (fuse, name)
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b, err_msg=f"fuse={fuse} {name}")
                n_int += 1
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
        assert n_int >= len(names) - 2
