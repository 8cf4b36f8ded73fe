"""The vision zoo's float graphs, NHWC (port of
`tachikoma_tpu/models/vision.py`): mlp, lenet5, digits_cnn (trained weights
from an .npz), resnet, mobilenet_v2, vgg, squeezenet, densenet,
inception_v3_stem, dcgan_generator, dqn, ssd_lite, lstm and resnet_3d (NDHWC).

The same functions with the same seeded random weights as the JAX package, so
the graphs are equal node for node and byte for byte.
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


def mlp(batch_size=1, in_dim=784, hidden=(128, 64), num_classes=10, seed=0) -> Graph:
    """`python/tvm/relay/testing/mlp.py` equivalent."""
    rng = _rng(seed)
    b = GraphBuilder("mlp")
    x = b.var("data", (batch_size, in_dim), "float32")
    h = x
    dims = [in_dim] + list(hidden)
    for i in range(len(hidden)):
        h = _dense(b, h, dims[i], dims[i + 1], rng, f"fc{i}")
        h = b.call("nn.relu", h, name=f"relu{i}")
    h = _dense(b, h, dims[-1], num_classes, rng, "fc_out")
    out = b.call("nn.softmax", h, name="prob")
    return infer_types(b.build(out))


def lenet5(batch_size=1, num_classes=10, seed=0) -> Graph:
    """LeNet-5 for 28x28x1 MNIST."""
    rng = _rng(seed)
    b = GraphBuilder("lenet5")
    x = b.var("data", (batch_size, 28, 28, 1), "float32")
    c1 = _conv(b, x, 1, 6, 5, 1, 2, rng, "conv1")
    bias1 = b.const((rng.standard_normal(6) * 0.01).astype(np.float32), name="conv1_b")
    c1 = b.call("nn.bias_add", c1, bias1, name="conv1_biased")
    r1 = b.call("nn.relu", c1, name="relu1")
    p1 = b.call("nn.max_pool2d", r1, pool_size=(2, 2), strides=(2, 2), name="pool1")
    c2 = _conv(b, p1, 6, 16, 5, 1, 0, rng, "conv2")
    bias2 = b.const((rng.standard_normal(16) * 0.01).astype(np.float32), name="conv2_b")
    c2 = b.call("nn.bias_add", c2, bias2, name="conv2_biased")
    r2 = b.call("nn.relu", c2, name="relu2")
    p2 = b.call("nn.max_pool2d", r2, pool_size=(2, 2), strides=(2, 2), name="pool2")
    f = b.call("nn.batch_flatten", p2, name="flat")
    d1 = _dense(b, f, 5 * 5 * 16, 120, rng, "fc1")
    r3 = b.call("nn.relu", d1, name="relu3")
    d2 = _dense(b, r3, 120, 84, rng, "fc2")
    r4 = b.call("nn.relu", d2, name="relu4")
    d3 = _dense(b, r4, 84, num_classes, rng, "fc3")
    out = b.call("nn.softmax", d3, name="prob")
    return infer_types(b.build(out))


def digits_cnn(weights, batch_size: int = 32) -> Graph:
    """8x8 digits CNN with REAL trained weights (the dataset-accuracy
    harness's labeled model — mrt `Trace.eval` analog, `mrt/api.py:98`).

    `weights`: path to an .npz (scripts/make_digits_fixture.py: a torch
    state_dict trained on sklearn's bundled digits set) or a dict of its
    arrays.  Torch layouts are converted: conv OIHW -> HWIO, the classifier
    re-indexed from torch's CHW flatten order to this graph's NHWC flatten.
    """
    if isinstance(weights, (str, bytes)):
        weights = dict(np.load(weights))
    b = GraphBuilder("digits_cnn")
    x = b.var("data", (batch_size, 8, 8, 1), "float32")

    def conv(x, key, name):
        w = np.ascontiguousarray(
            weights[f"{key}.weight"].transpose(2, 3, 1, 0))  # OIHW -> HWIO
        y = b.call("nn.conv2d", x, b.const(w, name=f"{name}_w"),
                   strides=(1, 1), padding=(1, 1, 1, 1), name=name)
        return b.call("nn.bias_add", y,
                      b.const(weights[f"{key}.bias"], name=f"{name}_b"),
                      name=f"{name}_biased")

    h = conv(x, "0", "conv1")
    h = b.call("nn.relu", h, name="relu1")
    h = b.call("nn.max_pool2d", h, pool_size=(2, 2), strides=(2, 2),
               name="pool1")
    h = conv(h, "3", "conv2")
    h = b.call("nn.relu", h, name="relu2")
    h = b.call("nn.max_pool2d", h, pool_size=(2, 2), strides=(2, 2),
               name="pool2")
    h = b.call("nn.batch_flatten", h, name="flat")
    # torch flattens (C=16, H=2, W=2) as c*4 + hw; NHWC flattens as hw*16 + c
    wt = weights["7.weight"]                       # (10, 64) torch (out, in)
    idx = np.arange(64)
    remap = (idx % 16) * 4 + idx // 16             # ours -> torch input index
    wd = np.ascontiguousarray(wt[:, remap].T)      # (64, 10) ours (in, out)
    h = b.call("nn.dense", h, b.const(wd, name="fc_w"), name="fc")
    h = b.call("nn.bias_add", h, b.const(weights["7.bias"], name="fc_b"),
               name="fc_biased")
    return infer_types(b.build(h))


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


def squeezenet(batch_size=1, image_size=224, num_classes=1000, seed=0) -> Graph:
    """SqueezeNet v1.1 (`python/tvm/relay/testing/squeezenet.py` equivalent)."""
    rng = _rng(seed)
    b = GraphBuilder("squeezenet")

    def fire(h, cin, squeeze, expand, name):
        s = _conv(b, h, cin, squeeze, 1, 1, 0, rng, f"{name}_squeeze")
        s = b.call("nn.relu", s)
        e1 = _conv(b, s, squeeze, expand, 1, 1, 0, rng, f"{name}_e1")
        e1 = b.call("nn.relu", e1)
        e3 = _conv(b, s, squeeze, expand, 3, 1, 1, rng, f"{name}_e3")
        e3 = b.call("nn.relu", e3)
        return b.call("concatenate", e1, e3, axis=3, name=f"{name}_out"), expand * 2

    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")
    h = _conv(b, x, 3, 64, 3, 2, 0, rng, "conv1")
    h = b.call("nn.relu", h)
    h = b.call("nn.max_pool2d", h, pool_size=(3, 3), strides=(2, 2), name="pool1")
    cin = 64
    h, cin = fire(h, cin, 16, 64, "fire2")
    h, cin = fire(h, cin, 16, 64, "fire3")
    h = b.call("nn.max_pool2d", h, pool_size=(3, 3), strides=(2, 2), name="pool3")
    h, cin = fire(h, cin, 32, 128, "fire4")
    h, cin = fire(h, cin, 32, 128, "fire5")
    h = b.call("nn.max_pool2d", h, pool_size=(3, 3), strides=(2, 2), name="pool5")
    h, cin = fire(h, cin, 48, 192, "fire6")
    h, cin = fire(h, cin, 48, 192, "fire7")
    h, cin = fire(h, cin, 64, 256, "fire8")
    h, cin = fire(h, cin, 64, 256, "fire9")
    h = _conv(b, h, cin, num_classes, 1, 1, 0, rng, "conv10")
    h = b.call("nn.relu", h)
    h = b.call("nn.global_avg_pool2d", h, keepdims=False, name="gap")
    return infer_types(b.build(b.call("nn.softmax", h, name="prob")))


def densenet(batch_size=1, image_size=224, num_classes=1000, growth=32,
             blocks=(6, 12, 24, 16), seed=0) -> Graph:
    """DenseNet-121-style (`python/tvm/relay/testing/densenet.py` equivalent)."""
    rng = _rng(seed)
    b = GraphBuilder("densenet")
    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")
    h = _conv(b, x, 3, 64, 7, 2, 3, rng, "conv0")
    h = _bn(b, h, 64, rng, "bn0")
    h = b.call("nn.relu", h)
    h = b.call("nn.max_pool2d", h, pool_size=(3, 3), strides=(2, 2), padding=(1, 1, 1, 1))
    cin = 64
    for bi, reps in enumerate(blocks):
        for i in range(reps):
            y = _bn(b, h, cin, rng, f"b{bi}_{i}_bn")
            y = b.call("nn.relu", y)
            y = _conv(b, y, cin, growth, 3, 1, 1, rng, f"b{bi}_{i}_conv")
            h = b.call("concatenate", h, y, axis=3, name=f"b{bi}_{i}_cat")
            cin += growth
        if bi != len(blocks) - 1:
            h = _bn(b, h, cin, rng, f"t{bi}_bn")
            h = b.call("nn.relu", h)
            h = _conv(b, h, cin, cin // 2, 1, 1, 0, rng, f"t{bi}_conv")
            cin //= 2
            h = b.call("nn.avg_pool2d", h, pool_size=(2, 2), strides=(2, 2))
    h = _bn(b, h, cin, rng, "bn_final")
    h = b.call("nn.relu", h)
    h = b.call("nn.global_avg_pool2d", h, keepdims=False)
    out = _dense(b, h, cin, num_classes, rng, "fc")
    return infer_types(b.build(b.call("nn.softmax", out, name="prob")))


def inception_v3_stem(batch_size=1, image_size=299, num_classes=1000, seed=0) -> Graph:
    """Inception-v3-style net (stem + two inception blocks + head) —
    exercises the multi-branch concat topology of
    `python/tvm/relay/testing/inception_v3.py` at tractable size."""
    rng = _rng(seed)
    b = GraphBuilder("inception_v3")

    def conv_bn(h, cin, cout, k, stride, pad, name):
        h = _conv(b, h, cin, cout, k, stride, pad, rng, name)
        h = _bn(b, h, cout, rng, f"{name}_bn")
        return b.call("nn.relu", h, name=f"{name}_relu")

    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")
    h = conv_bn(x, 3, 32, 3, 2, 0, "stem1")
    h = conv_bn(h, 32, 64, 3, 1, 1, "stem2")
    h = b.call("nn.max_pool2d", h, pool_size=(3, 3), strides=(2, 2))
    h = conv_bn(h, 64, 192, 3, 1, 1, "stem3")
    h = b.call("nn.max_pool2d", h, pool_size=(3, 3), strides=(2, 2))
    cin = 192
    for bi in range(2):
        b1 = conv_bn(h, cin, 64, 1, 1, 0, f"i{bi}_b1")
        b2 = conv_bn(h, cin, 48, 1, 1, 0, f"i{bi}_b2a")
        b2 = conv_bn(b2, 48, 64, 5, 1, 2, f"i{bi}_b2b")
        b3 = conv_bn(h, cin, 64, 1, 1, 0, f"i{bi}_b3a")
        b3 = conv_bn(b3, 64, 96, 3, 1, 1, f"i{bi}_b3b")
        p = b.call("nn.avg_pool2d", h, pool_size=(3, 3), strides=(1, 1),
                   padding=(1, 1, 1, 1), count_include_pad=True)
        b4 = conv_bn(p, cin, 32 if bi == 0 else 64, 1, 1, 0, f"i{bi}_b4")
        h = b.call("concatenate", b1, b2, b3, b4, axis=3, name=f"i{bi}_out")
        cin = 64 + 64 + 96 + (32 if bi == 0 else 64)
    h = b.call("nn.global_avg_pool2d", h, keepdims=False)
    out = _dense(b, h, cin, num_classes, rng, "fc")
    return infer_types(b.build(b.call("nn.softmax", out, name="prob")))


def dcgan_generator(batch_size=1, latent=100, seed=0) -> Graph:
    """DCGAN generator (`python/tvm/relay/testing/dcgan.py` equivalent) —
    exercises conv2d_transpose."""
    rng = _rng(seed)
    b = GraphBuilder("dcgan")
    z = b.var("noise", (batch_size, latent), "float32")
    h = _dense(b, z, latent, 4 * 4 * 512, rng, "proj")
    h = b.call("reshape", h, newshape=(batch_size, 4, 4, 512), name="reshape0")
    cin = 512
    for i, cout in enumerate((256, 128, 64)):
        w = (rng.standard_normal((4, 4, cin, cout)) * 0.05).astype(np.float32)
        h = b.call("nn.conv2d_transpose", h, b.const(w, name=f"deconv{i}_w"),
                   strides=(2, 2), padding=(1, 1, 1, 1), name=f"deconv{i}")
        h = _bn(b, h, cout, rng, f"dbn{i}")
        h = b.call("nn.relu", h)
        cin = cout
    w = (rng.standard_normal((4, 4, cin, 3)) * 0.05).astype(np.float32)
    h = b.call("nn.conv2d_transpose", h, b.const(w, name="deconv_out_w"),
               strides=(2, 2), padding=(1, 1, 1, 1), name="deconv_out")
    return infer_types(b.build(b.call("tanh", h, name="img")))


def dqn(batch_size=1, image_size=84, num_actions=18, seed=0) -> Graph:
    """DQN Atari net (`python/tvm/relay/testing/dqn.py` equivalent)."""
    rng = _rng(seed)
    b = GraphBuilder("dqn")
    x = b.var("data", (batch_size, image_size, image_size, 4), "float32")
    h = _conv(b, x, 4, 32, 8, 4, 0, rng, "conv1")
    h = b.call("nn.relu", h)
    h = _conv(b, h, 32, 64, 4, 2, 0, rng, "conv2")
    h = b.call("nn.relu", h)
    h = _conv(b, h, 64, 64, 3, 1, 0, rng, "conv3")
    h = b.call("nn.relu", h)
    h = b.call("nn.batch_flatten", h)
    feat = 7 * 7 * 64
    h = _dense(b, h, feat, 512, rng, "fc1")
    h = b.call("nn.relu", h)
    out = _dense(b, h, 512, num_actions, rng, "fc2")
    return infer_types(b.build(out))


def _ssd_priors(feat_sizes, image_size, min_scale=0.2, max_scale=0.9):
    """SSD prior boxes in center-size form (cy, cx, h, w), normalized [0,1].

    Matches the SSD multibox discipline (reference exercises this graph shape
    via `vision.multibox_prior` + `vision.non_max_suppression`,
    `src/relay/op/vision/multibox_op.cc`): per feature map, one scale plus
    aspect ratios {1, 2, 1/2, 3, 1/3} and the geometric-mean extra box.
    """
    ratios = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
    scales = [min_scale + (max_scale - min_scale) * i / max(len(feat_sizes) - 1, 1)
              for i in range(len(feat_sizes) + 1)]
    priors = []
    for fi, fs in enumerate(feat_sizes):
        s = scales[fi]
        s_extra = float(np.sqrt(s * scales[fi + 1]))
        cells = (np.arange(fs) + 0.5) / fs
        cy, cx = np.meshgrid(cells, cells, indexing="ij")
        for box_h, box_w in [(s, s), (s_extra, s_extra)] + [
            (s / np.sqrt(r), s * np.sqrt(r)) for r in ratios[1:]
        ]:
            priors.append(np.stack(
                [cy.ravel(), cx.ravel(),
                 np.full(fs * fs, box_h), np.full(fs * fs, box_w)], axis=1))
    # interleave anchors per cell the same way the heads emit them:
    # heads produce (H, W, A*4) -> reshape (H*W*A, 4), i.e. anchor-major per
    # cell.  Rebuild priors in that order.
    out = []
    off = 0
    num_anchors = len(ratios) + 1
    for fs in feat_sizes:
        per_scale = [priors[off + a] for a in range(num_anchors)]
        off += num_anchors
        stacked = np.stack(per_scale, axis=1)  # (H*W, A, 4)
        out.append(stacked.reshape(-1, 4))
    return np.concatenate(out, axis=0).astype(np.float32), num_anchors


def ssd_lite(batch_size=1, image_size=320, num_classes=21, max_boxes=100,
             seed=0) -> Graph:
    """SSD-lite detector: MobileNetV2-style backbone, depthwise-separable
    multibox heads, prior-box decode, per-image greedy NMS.

    The detection-graph analog of the reference's SSD flow
    (`python/tvm/relay/testing` has no SSD, but its frontends import SSD via
    `vision.multibox_transform_loc` + `vision.non_max_suppression`,
    `src/relay/op/vision/{multibox_op.cc,nms.cc}`).  Outputs: decoded corner
    boxes (N, P, 4), per-box best-class scores (N, P), NMS-selected indices
    (N, max_boxes) padded with -1.
    """
    rng = _rng(seed)
    b = GraphBuilder("ssd_lite")
    x = b.var("data", (batch_size, image_size, image_size, 3), "float32")

    # --- backbone: trimmed MobileNetV2 down to stride 32 + 2 extra stages
    def conv_out(size, k, stride, pad):
        return (size + 2 * pad - k) // stride + 1

    h = _conv(b, x, 3, 32, 3, 2, 1, rng, "conv0")
    h = _bn(b, h, 32, rng, "bn0")
    h = b.call("clip", h, a_min=0.0, a_max=6.0, name="relu6_0")
    cur = conv_out(image_size, 3, 2, 1)
    cin = 32
    feats, feat_sizes = [], []
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 2, 2),
           (6, 96, 2, 1), (6, 160, 2, 2)]
    idx = 0
    for t, c, nrep, s in cfg:
        for i in range(nrep):
            stride = s if i == 0 else 1
            h = _inverted_residual(b, h, cin, c, stride, t, rng, f"ir{idx}")
            cur = conv_out(cur, 3, stride, 1)
            cin = c
            idx += 1
        if c in (96, 160):
            feats.append((h, cin))
            feat_sizes.append(cur)
    # extra feature stages (stride 64, 128)
    for j, cout in enumerate((256, 256)):
        h = _conv(b, h, cin, cout // 2, 1, 1, 0, rng, f"extra{j}_pw")
        h = b.call("nn.relu", h, name=f"extra{j}_relu0")
        h = _conv(b, h, cout // 2, cout, 3, 2, 1, rng, f"extra{j}_conv")
        h = b.call("nn.relu", h, name=f"extra{j}_relu1")
        cur = conv_out(cur, 3, 2, 1)
        cin = cout
        feats.append((h, cin))
        feat_sizes.append(cur)

    # --- SSD-lite heads: depthwise 3x3 + pointwise 1x1 per scale
    priors_np, num_anchors = _ssd_priors(feat_sizes, image_size)

    def head(xh, c, fs, n_out, name):
        hh = _conv(b, xh, c, c, 3, 1, 1, rng, f"{name}_dw", groups=c)
        hh = b.call("clip", hh, a_min=0.0, a_max=6.0, name=f"{name}_relu6")
        hh = _conv(b, hh, c, num_anchors * n_out, 1, 1, 0, rng, f"{name}_pw")
        return b.call("reshape", hh,
                      newshape=(batch_size, fs * fs * num_anchors, n_out),
                      name=f"{name}_flat")

    locs, confs = [], []
    for si, ((f, c), fs) in enumerate(zip(feats, feat_sizes)):
        locs.append(head(f, c, fs, 4, f"loc{si}"))
        confs.append(head(f, c, fs, num_classes, f"conf{si}"))
    loc = b.call("concatenate", *locs, axis=1, name="loc_cat")
    conf = b.call("concatenate", *confs, axis=1, name="conf_cat")

    # --- decode: center-size deltas with SSD variances (0.1, 0.2)
    npri = priors_np.shape[0]
    pr = priors_np[None]  # (1, P, 4)
    p_cy = b.const(pr[:, :, 0:1], "prior_cy")
    p_cx = b.const(pr[:, :, 1:2], "prior_cx")
    p_h = b.const(pr[:, :, 2:3], "prior_h")
    p_w = b.const(pr[:, :, 3:4], "prior_w")

    def comp(src, k, name):
        return b.call("strided_slice", src, begin=(k,), end=(k + 1,),
                      strides=(1,), axes=(2,), name=name)

    d_cy, d_cx = comp(loc, 0, "d_cy"), comp(loc, 1, "d_cx")
    d_h, d_w = comp(loc, 2, "d_h"), comp(loc, 3, "d_w")
    var_c = b.const(np.float32(0.1), "var_center")
    var_s = b.const(np.float32(0.2), "var_size")
    cy = b.call("add", b.call("multiply", b.call("multiply", d_cy, var_c), p_h), p_cy)
    cx = b.call("add", b.call("multiply", b.call("multiply", d_cx, var_c), p_w), p_cx)
    bh = b.call("multiply", b.call("exp", b.call("multiply", d_h, var_s)), p_h)
    bw = b.call("multiply", b.call("exp", b.call("multiply", d_w, var_s)), p_w)
    half = b.const(np.float32(0.5), "half")
    hy, hx = b.call("multiply", bh, half), b.call("multiply", bw, half)
    boxes = b.call("concatenate",
                   b.call("subtract", cy, hy), b.call("subtract", cx, hx),
                   b.call("add", cy, hy), b.call("add", cx, hx),
                   axis=2, name="boxes")

    # --- scores: softmax over classes, best non-background class per box
    probs = b.call("nn.softmax", conf, axis=-1, name="probs")
    fg = b.call("strided_slice", probs, begin=(1,), end=(num_classes,),
                strides=(1,), axes=(2,), name="fg_probs")
    scores = b.call("max", fg, axis=2, name="scores")

    keep = b.call("vision.non_max_suppression", boxes, scores,
                  max_output_size=max_boxes, iou_threshold=0.5,
                  score_threshold=0.05, name="nms")
    g = infer_types(b.build([boxes, scores, keep]))
    assert g[boxes].shape == (batch_size, npri, 4)
    return g


def lstm(batch_size=1, seq_len=16, input_dim=64, hidden_dim=128, num_classes=10,
         seed=0) -> Graph:
    """Unrolled LSTM classifier (`python/tvm/relay/testing/lstm.py`
    equivalent; static shapes require unrolling — XLA re-rolls via CSE)."""
    rng = _rng(seed)
    b = GraphBuilder("lstm")
    x = b.var("data", (batch_size, seq_len, input_dim), "float32")
    w_ih = b.const((rng.standard_normal((input_dim, 4 * hidden_dim)) * 0.08).astype(np.float32), "w_ih")
    w_hh = b.const((rng.standard_normal((hidden_dim, 4 * hidden_dim)) * 0.08).astype(np.float32), "w_hh")
    bias = b.const((rng.standard_normal(4 * hidden_dim) * 0.01).astype(np.float32), "b")
    h = b.const(np.zeros((batch_size, hidden_dim), np.float32), "h0")
    c = b.const(np.zeros((batch_size, hidden_dim), np.float32), "c0")
    for t in range(seq_len):
        xt = b.call("strided_slice", x, begin=(0, t), end=(batch_size, t + 1),
                    strides=(1, 1), axes=(0, 1), name=f"x{t}_slice")
        xt = b.call("reshape", xt, newshape=(batch_size, input_dim), name=f"x{t}")
        gates = b.call("add", b.call("nn.dense", xt, w_ih), b.call("nn.dense", h, w_hh))
        gates = b.call("nn.bias_add", gates, bias, name=f"gates{t}")
        parts = b.call("split", gates, indices_or_sections=4, axis=1, name=f"split{t}")
        i_g = b.call("sigmoid", b.get_item(parts, 0))
        f_g = b.call("sigmoid", b.get_item(parts, 1))
        g_g = b.call("tanh", b.get_item(parts, 2))
        o_g = b.call("sigmoid", b.get_item(parts, 3))
        c = b.call("add", b.call("multiply", f_g, c), b.call("multiply", i_g, g_g),
                   name=f"c{t}")
        h = b.call("multiply", o_g, b.call("tanh", c), name=f"h{t}")
    out = _dense(b, h, hidden_dim, num_classes, rng, "fc")
    return infer_types(b.build(b.call("nn.softmax", out, name="prob")))


def _conv3(b, x, cin, cout, k, stride, pad, rng, name):
    w = (rng.standard_normal((k, k, k, cin, cout)) * (k * k * k * cin) ** -0.5
         ).astype(np.float32)
    return b.call(
        "nn.conv3d", x, b.const(w, name=f"{name}_w"),
        strides=(stride, stride, stride), padding=(pad,) * 6, name=name)


def _res_block3(b, x, cin, cout, stride, rng, name):
    c1 = _conv3(b, x, cin, cout, 3, stride, 1, rng, f"{name}_conv1")
    n1 = _bn(b, c1, cout, rng, f"{name}_bn1")
    r1 = b.call("nn.relu", n1, name=f"{name}_relu1")
    c2 = _conv3(b, r1, cout, cout, 3, 1, 1, rng, f"{name}_conv2")
    n2 = _bn(b, c2, cout, rng, f"{name}_bn2")
    if stride != 1 or cin != cout:
        sc = _conv3(b, x, cin, cout, 1, stride, 0, rng, f"{name}_down")
        sc = _bn(b, sc, cout, rng, f"{name}_bn_down")
    else:
        sc = x
    s = b.call("add", n2, sc, name=f"{name}_add")
    return b.call("nn.relu", s, name=f"{name}_out")


def resnet_3d(num_layers=18, batch_size=1, frames=16, image_size=112,
              num_classes=400, seed=0) -> Graph:
    """3D ResNet for video (NDHWC; the reference's
    `python/tvm/relay/testing/resnet_3d.py` — last missing zoo family).
    ResNet3D-18 layout: 3x3x3 stem (video nets skip the 7x7 downsample),
    4 stages of basic blocks with spatiotemporal stride-2 transitions."""
    cfgs = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3]}
    blocks = cfgs[num_layers]
    rng = _rng(seed)
    b = GraphBuilder(f"resnet3d{num_layers}")
    x = b.var("data", (batch_size, frames, image_size, image_size, 3),
              "float32")
    c = _conv3(b, x, 3, 64, 3, 1, 1, rng, "conv0")
    n = _bn(b, c, 64, rng, "bn0")
    h = b.call("nn.relu", n, name="relu0")
    channels = [64, 128, 256, 512]
    cin = 64
    for stage, (nblocks, cw) in enumerate(zip(blocks, channels)):
        for i in range(nblocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            h = _res_block3(b, h, cin, cw, stride, rng, f"s{stage}b{i}")
            cin = cw
    gap = b.call("mean", h, axis=(1, 2, 3), name="gap")
    out = _dense(b, gap, cin, num_classes, rng, "fc")
    sm = b.call("nn.softmax", out, name="prob")
    return infer_types(b.build(sm))
