"""DeepLabV3-ResNet-50 written as an ONNX file, the way `torch.onnx.export`
lays out torchvision's `deeplabv3_resnet50` (torchvision/models/segmentation/
deeplabv3.py; `aux_loss` off) in eval mode: each Conv with its batch norm
folded, Relu, MaxPool, Add on the residual, GlobalAveragePool, Concat and
Resize (mode linear, `pytorch_half_pixel`, static `sizes`).

The backbone is ResNet-50 with `replace_stride_with_dilation=[False, True,
True]` (output stride 8): layer3 keeps its first block at dilation 1 and
runs the others at 2, layer4 runs its first block at 2 and the others at 4,
neither stage strides.  The head is `DeepLabHead`: ASPP(2048, [12, 24, 36])
(a 1x1 branch, three dilated 3x3 branches, and a pooling branch of
GlobalAveragePool, a 1x1 conv and a Resize back to the map's size;
concatenated, projected by a 1x1 conv; the dropout is gone in eval mode),
then a 3x3 256 -> 256 conv and a 1x1 conv to the classes.  The logits are
resized bilinearly to the input's size.  At torchvision's evaluation size,
b1 520^2 (references/segmentation), the dilated maps are 65^2.

Neither package has an integer bilinear resize (`image.resize2d` "linear"
takes float input), so the model is quantized with the Resize in float:
`FLOAT_OPS` adds it to the default `QConfig.float_ops` (`deeplab_qconfig`),
and the pooling branch and the logits are dequantized around it.

The weights are random from a seed, drawn as `models/onnx_resnet.py` draws
them (He-scaled convs, batch-norm statistics folded as the exporter folds
them, each residual branch's last batch norm scaled by 0.25).  It is written
with the port's own protobuf encoder (frontend/onnx_proto.py);
`frontend/onnx.py from_onnx` imports it.
"""

from __future__ import annotations

import numpy as np

from ..frontend.onnx_proto import encode
from ..quantize.config import QConfig
from .onnx_resnet import _node, _value_info, _Writer

RATES = (12, 24, 36)       # ASPP's atrous rates at output stride 8
ASPP_CHANNELS = 256
FLOAT_OPS = QConfig().float_ops | {"image.resize2d"}


def deeplab_qconfig() -> QConfig:
    """The default QConfig with the bilinear Resize left in float."""
    return QConfig(float_ops=FLOAT_OPS)


def _bottleneck(wr: _Writer, h: str, cin: int, width: int, stride: int, dilation: int,
                scope: str) -> tuple[str, int]:
    cout = width * 4
    r = wr.op("Relu", [wr.conv(h, cin, width, 1, 1, 0, f"{scope}/conv1")], f"{scope}/relu")
    r = wr.op("Relu", [wr.conv(r, width, width, 3, stride, dilation, f"{scope}/conv2",
                               dilation=dilation)], f"{scope}/relu_1")
    r = wr.conv(r, width, cout, 1, 1, 0, f"{scope}/conv3", gain=0.25)
    sc = h if (stride == 1 and cin == cout) else wr.conv(
        h, cin, cout, 1, stride, 0, f"{scope}/downsample/downsample.0")
    return wr.op("Relu", [wr.op("Add", [r, sc], scope)], f"{scope}/relu_2"), cout


def deeplabv3_onnx(batch_size: int = 1, image_size: int = 520, num_classes: int = 21,
                   seed: int = 0, layers=(3, 4, 6, 3), width: int = 64,
                   aspp_channels: int = ASPP_CHANNELS) -> bytes:
    """The serialized ModelProto of DeepLabV3-ResNet-50 at `batch_size` x 3 x
    `image_size`^2 (NCHW, input "input", output "output": the logits at the
    input's size).  `layers` (blocks a stage), `width` (layer1's bottleneck
    width; torchvision's 64) and `aspp_channels` narrow it for tests."""
    wr = _Writer(seed)
    s = "/backbone"
    h = wr.conv("input", 3, width, 7, 2, 3, f"{s}/conv1")
    h = wr.op("Relu", [h], f"{s}/relu")
    h = wr.op("MaxPool", [h], f"{s}/maxpool", ceil_mode=0, dilations=[1, 1],
              kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[2, 2])
    cin, dilation = width, 1
    for stage, nblocks in enumerate(layers):
        stride, previous = (2 if stage > 0 else 1), dilation
        if stage >= 2:  # replace_stride_with_dilation=[False, True, True]
            dilation, stride = dilation * stride, 1
        for i in range(nblocks):
            h, cin = _bottleneck(wr, h, cin, width << stage, stride if i == 0 else 1,
                                 previous if i == 0 else dilation,
                                 f"{s}/layer{stage + 1}/layer{stage + 1}.{i}")
    side = -(-image_size // 8)  # the maps at output stride 8
    a = "/classifier/classifier.0"
    branches = [wr.op("Relu", [wr.conv(h, cin, aspp_channels, 1, 1, 0,
                                       f"{a}/convs.0/convs.0.0")], f"{a}/convs.0/convs.0.2")]
    for i, rate in enumerate(RATES, 1):
        c = wr.conv(h, cin, aspp_channels, 3, 1, rate, f"{a}/convs.{i}/convs.{i}.0",
                    dilation=rate)
        branches.append(wr.op("Relu", [c], f"{a}/convs.{i}/convs.{i}.2"))
    p = f"{a}/convs.{len(RATES) + 1}"
    pooled = wr.op("GlobalAveragePool", [h], f"{p}/convs.{len(RATES) + 1}.0")
    pooled = wr.op("Relu", [wr.conv(pooled, cin, aspp_channels, 1, 1, 0, f"{p}/convs.1")],
                   f"{p}/convs.3")
    branches.append(_resize(wr, pooled, (batch_size, aspp_channels, side, side), p))
    h = wr.op("Concat", branches, a, axis=1)
    h = wr.op("Relu", [wr.conv(h, aspp_channels * len(branches), aspp_channels, 1, 1, 0,
                               f"{a}/project/project.0")], f"{a}/project/project.2")
    h = wr.op("Relu", [wr.conv(h, aspp_channels, aspp_channels, 3, 1, 1,
                               "/classifier/classifier.1")], "/classifier/classifier.3")
    cls_w = (wr.rng.standard_normal((num_classes, aspp_channels, 1, 1))
             * np.sqrt(2.0 / aspp_channels)).astype(np.float32)
    cls_b = (wr.rng.standard_normal(num_classes) * 0.01).astype(np.float32)
    h = _classifier(wr, h, cls_w, cls_b)
    out = _resize(wr, h, (batch_size, num_classes, image_size, image_size), "", "output")
    model = {
        "ir_version": 8,
        "producer_name": "pytorch",
        "producer_version": "2.1.0",
        "opset_import": [{"domain": "", "version": 17}],
        "graph": {
            "name": "main_graph",
            "node": wr.nodes,
            "initializer": wr.inits,
            "input": [_value_info("input", (batch_size, 3, image_size, image_size))],
            "output": [_value_info(out, (batch_size, num_classes, image_size, image_size))],
        },
    }
    return encode(model, "ModelProto")


def _classifier(wr: _Writer, h: str, w: np.ndarray, b: np.ndarray) -> str:
    """The last 1x1 conv, with its own bias and no batch norm."""
    out = "/classifier/classifier.4/Conv_output_0"
    wr.nodes.append(_node("Conv", [h, wr.param(w, "classifier.4.weight"),
                                   wr.param(b, "classifier.4.bias")], [out],
                          "/classifier/classifier.4/Conv", dilations=[1, 1], group=1,
                          kernel_shape=[1, 1], pads=[0, 0, 0, 0], strides=[1, 1]))
    return out


def _resize(wr: _Writer, x: str, shape, scope: str, out: str | None = None) -> str:
    """F.interpolate(mode="bilinear", align_corners=False) to `shape` (NCHW),
    as the exporter writes it at opset 17: Resize with empty roi and scales
    and a constant `sizes`."""
    sizes = wr.param(np.asarray(shape, np.int64), f"{scope}/Constant_output_0" if scope
                     else "/Constant_output_0")
    out = out or f"{scope}/Resize_output_0"
    wr.nodes.append(_node("Resize", [x, "", "", sizes], [out], f"{scope}/Resize",
                          coordinate_transformation_mode="pytorch_half_pixel",
                          cubic_coeff_a=-0.75, mode="linear", nearest_mode="floor"))
    return out
