"""ResNet, MobileNetV2 and VGG float graphs, NHWC (port of
`tachikoma_tpu/models/vision.py`).

The same functions with the same seeded random weights as the JAX package, so
the graphs are equal node for node and byte for byte.  `resnet`,
`mobilenet_v2` and `vgg` are ported; the other zoo models are not yet.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, GraphBuilder
from ..ir.infer import infer_types


def _rng(seed):
    return np.random.default_rng(seed)


def _conv(b, x, cin, cout, k, stride, pad, rng, name, groups=1, dtype=np.float32):
    fan_in = k * k * cin // groups
    w = (rng.standard_normal((k, k, cin // groups, cout)) * np.sqrt(2.0 / fan_in)).astype(dtype)
    wn = b.const(w, name=f"{name}_w")
    return b.call(
        "nn.conv2d", x, wn, strides=(stride, stride),
        padding=(pad, pad, pad, pad), groups=groups, name=name,
    )


def _bn(b, x, c, rng, name):
    gamma = b.const(np.abs(rng.standard_normal(c)).astype(np.float32) + 0.5, name=f"{name}_g")
    beta = b.const((rng.standard_normal(c) * 0.1).astype(np.float32), name=f"{name}_b")
    mean = b.const((rng.standard_normal(c) * 0.1).astype(np.float32), name=f"{name}_m")
    var = b.const(np.abs(rng.standard_normal(c)).astype(np.float32) + 0.5, name=f"{name}_v")
    return b.call("nn.batch_norm", x, gamma, beta, mean, var, name=name)


def _dense(b, x, cin, cout, rng, name, bias=True):
    w = (rng.standard_normal((cin, cout)) * np.sqrt(2.0 / cin)).astype(np.float32)
    y = b.call("nn.dense", x, b.const(w, name=f"{name}_w"), name=name)
    if bias:
        bb = b.const((rng.standard_normal(cout) * 0.01).astype(np.float32), name=f"{name}_b")
        y = b.call("nn.bias_add", y, bb, name=f"{name}_biased")
    return y


def _res_block(b, x, cin, cout, stride, rng, name):
    c1 = _conv(b, x, cin, cout, 3, stride, 1, rng, f"{name}_conv1")
    n1 = _bn(b, c1, cout, rng, f"{name}_bn1")
    r1 = b.call("nn.relu", n1, name=f"{name}_relu1")
    c2 = _conv(b, r1, cout, cout, 3, 1, 1, rng, f"{name}_conv2")
    n2 = _bn(b, c2, cout, rng, f"{name}_bn2")
    if stride != 1 or cin != cout:
        sc = _conv(b, x, cin, cout, 1, stride, 0, rng, f"{name}_down")
        sc = _bn(b, sc, cout, rng, f"{name}_bn_down")
    else:
        sc = x
    s = b.call("add", n2, sc, name=f"{name}_add")
    return b.call("nn.relu", s, name=f"{name}_out")


def _bottleneck(b, x, cin, cmid, cout, stride, rng, name):
    c1 = _conv(b, x, cin, cmid, 1, 1, 0, rng, f"{name}_conv1")
    n1 = _bn(b, c1, cmid, rng, f"{name}_bn1")
    r1 = b.call("nn.relu", n1, name=f"{name}_relu1")
    c2 = _conv(b, r1, cmid, cmid, 3, stride, 1, rng, f"{name}_conv2")
    n2 = _bn(b, c2, cmid, rng, f"{name}_bn2")
    r2 = b.call("nn.relu", n2, name=f"{name}_relu2")
    c3 = _conv(b, r2, cmid, cout, 1, 1, 0, rng, f"{name}_conv3")
    n3 = _bn(b, c3, cout, rng, f"{name}_bn3")
    if stride != 1 or cin != cout:
        sc = _conv(b, x, cin, cout, 1, stride, 0, rng, f"{name}_down")
        sc = _bn(b, sc, cout, rng, f"{name}_bn_down")
    else:
        sc = x
    s = b.call("add", n3, sc, name=f"{name}_add")
    return b.call("nn.relu", s, name=f"{name}_out")


def resnet(num_layers=18, batch_size=1, image_size=224, num_classes=1000, seed=0) -> Graph:
    """ResNet-18/34/50 float graph, NHWC, seeded random weights."""
    cfgs = {
        18: ("basic", [2, 2, 2, 2]),
        34: ("basic", [3, 4, 6, 3]),
        50: ("bottleneck", [3, 4, 6, 3]),
    }
    kind, blocks = cfgs[num_layers]
    rng = _rng(seed)
    b = GraphBuilder(f"resnet{num_layers}")
    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")
    c = _conv(b, x, 3, 64, 7, 2, 3, rng, "conv0")
    n = _bn(b, c, 64, rng, "bn0")
    r = b.call("nn.relu", n, name="relu0")
    h = b.call("nn.max_pool2d", r, pool_size=(3, 3), strides=(2, 2), padding=(1, 1, 1, 1), name="pool0")
    channels = [64, 128, 256, 512]
    cin = 64
    for stage, (nblocks, cw) in enumerate(zip(blocks, channels)):
        for i in range(nblocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            if kind == "basic":
                h = _res_block(b, h, cin, cw, stride, rng, f"s{stage}b{i}")
                cin = cw
            else:
                cout = cw * 4
                h = _bottleneck(b, h, cin, cw, cout, stride, rng, f"s{stage}b{i}")
                cin = cout
    gap = b.call("nn.global_avg_pool2d", h, keepdims=False, name="gap")
    out = _dense(b, gap, cin, num_classes, rng, "fc")
    sm = b.call("nn.softmax", out, name="prob")
    return infer_types(b.build(sm))


def _inverted_residual(b, x, cin, cout, stride, expand, rng, name):
    cmid = cin * expand
    h = x
    if expand != 1:
        h = _conv(b, h, cin, cmid, 1, 1, 0, rng, f"{name}_expand")
        h = _bn(b, h, cmid, rng, f"{name}_bn0")
        h = b.call("clip", h, a_min=0.0, a_max=6.0, name=f"{name}_relu6_0")
    # depthwise
    h = _conv(b, h, cmid, cmid, 3, stride, 1, rng, f"{name}_dw", groups=cmid)
    h = _bn(b, h, cmid, rng, f"{name}_bn1")
    h = b.call("clip", h, a_min=0.0, a_max=6.0, name=f"{name}_relu6_1")
    h = _conv(b, h, cmid, cout, 1, 1, 0, rng, f"{name}_project")
    h = _bn(b, h, cout, rng, f"{name}_bn2")
    if stride == 1 and cin == cout:
        h = b.call("add", h, x, name=f"{name}_add")
    return h


def mobilenet_v2(batch_size=1, image_size=224, num_classes=1000, width_mult=1.0,
                 seed=0) -> Graph:
    """MobileNetV2 float graph, NHWC, seeded random weights: 17 inverted
    residual blocks, each with a 3x3 depthwise conv, ReLU6 as clip."""
    rng = _rng(seed)
    b = GraphBuilder("mobilenet_v2")
    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")

    def c8(ch):
        return max(8, int(np.ceil(ch * width_mult / 8) * 8))

    h = _conv(b, x, 3, c8(32), 3, 2, 1, rng, "conv0")
    h = _bn(b, h, c8(32), rng, "bn0")
    h = b.call("clip", h, a_min=0.0, a_max=6.0, name="relu6_0")
    cin = c8(32)
    # t (expand), c (out), n (repeat), s (stride)
    cfg = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    idx = 0
    for t, c, nrep, s in cfg:
        for i in range(nrep):
            stride = s if i == 0 else 1
            h = _inverted_residual(b, h, cin, c8(c), stride, t, rng, f"ir{idx}")
            cin = c8(c)
            idx += 1
    h = _conv(b, h, cin, 1280, 1, 1, 0, rng, "conv_last")
    h = _bn(b, h, 1280, rng, "bn_last")
    h = b.call("clip", h, a_min=0.0, a_max=6.0, name="relu6_last")
    gap = b.call("nn.global_avg_pool2d", h, keepdims=False, name="gap")
    out = _dense(b, gap, 1280, num_classes, rng, "fc")
    sm = b.call("nn.softmax", out, name="prob")
    return infer_types(b.build(sm))


def vgg(num_layers=16, batch_size=1, image_size=224, num_classes=1000, seed=0) -> Graph:
    """VGG-11/13/16/19 float graph, NHWC, seeded random weights: 3x3 s1 convs
    with bias and ReLU, a 2x2 max pool after each of five stages, three dense
    layers."""
    plans = {
        11: (1, 1, 2, 2, 2),
        13: (2, 2, 2, 2, 2),
        16: (2, 2, 3, 3, 3),
        19: (2, 2, 4, 4, 4),
    }
    plan = plans[num_layers]
    widths = (64, 128, 256, 512, 512)
    rng = _rng(seed)
    b = GraphBuilder(f"vgg{num_layers}")
    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")
    h, cin = x, 3
    for stage, (reps, cw) in enumerate(zip(plan, widths)):
        for i in range(reps):
            h = _conv(b, h, cin, cw, 3, 1, 1, rng, f"conv{stage}_{i}")
            bias = b.const((rng.standard_normal(cw) * 0.01).astype(np.float32))
            h = b.call("nn.bias_add", h, bias)
            h = b.call("nn.relu", h, name=f"relu{stage}_{i}")
            cin = cw
        h = b.call("nn.max_pool2d", h, pool_size=(2, 2), strides=(2, 2), name=f"pool{stage}")
    h = b.call("nn.batch_flatten", h, name="flat")
    feat = (image_size // 32) ** 2 * 512
    h = _dense(b, h, feat, 4096, rng, "fc6")
    h = b.call("nn.relu", h)
    h = _dense(b, h, 4096, 4096, rng, "fc7")
    h = b.call("nn.relu", h)
    h = _dense(b, h, 4096, num_classes, rng, "fc8")
    return infer_types(b.build(b.call("nn.softmax", h, name="prob")))
