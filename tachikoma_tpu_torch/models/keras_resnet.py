"""ResNet-50 written as a frozen TensorFlow GraphDef, the way
`keras.applications.ResNet50` (Keras 3, the TensorFlow backend) freezes in
inference mode through `tf.function` and `convert_variables_to_constants_v2`
(`frontend/keras.py from_keras` does that): node for node, in the same
order, with the same names, ops and attrs.

Keras's v1 layout:
- `ZeroPadding2D(3)` as a Pad, then the 7x7 s2 VALID stem conv;
- a Pad of 1 and the 3x3 s2 VALID MaxPool;
- the stride on the first 1x1 conv of each downsampling block and on its 1x1
  shortcut, the 3x3 conv SAME at stride 1;
- every conv with its bias: a Reshape of the bias to (1, 1, 1, C), a Squeeze
  and a BiasAdd (Keras's `ops.add` becomes `tf.nn.bias_add` when its second
  operand squeezes to the channels);
- batch norm unfolded, as `tf.nn.batch_normalization` writes it: its four
  vectors reshaped to (1, 1, 1, C), then var + eps, Rsqrt, Mul by gamma,
  x * that, mean * that, beta - that, and the AddV2 of the two (eps 1.001e-5);
- AddV2 and Relu on the residual (a BiasAdd of the squeezed branch where the
  branch squeezes to the channels, at batch 1 on a 1 x 1 map);
- Mean over H and W, then MatMul, BiasAdd and Softmax into the classes;
- each weight a Const read through an Identity, a NoOp holding those reads as
  control inputs, and the output an Identity of the Softmax.

The weights are random from a seed: He-scaled convs, small biases,
batch-norm statistics and affine terms drawn per channel (a residual
branch's last gamma scaled by 1/4, which keeps the sum of sixteen blocks in
range), and a He-scaled classifier scaled down to logits of the order of 10
(`FC_GAIN`).  The graph is written with the port's codec (frontend/tf_proto.py),
so no TensorFlow is needed; `frontend/tensorflow.py from_tf_graphdef` imports
it.
"""

from __future__ import annotations

import numpy as np

from ..frontend.tf_proto import Message, encode, make_tensor_proto, shape_proto

EPS = 1.001e-5
PRODUCER = 2474  # the GraphDef version of the TensorFlow whose freeze this follows
F32, I32 = 1, 3  # DataType enums
SCOPE = "resnet50_1"
# the classifier's He scale times this: the pooled features of the random
# network are of the order of 10^2, so the logits come out of the order of
# 10, as a trained classifier's are, and the softmax does not saturate
FC_GAIN = 0.01


def _attr(**kw) -> Message:
    return Message("AttrValue", **kw)


def _ints(values) -> Message:
    return _attr(list=Message("ListValue", i=[int(v) for v in values]))


_T = {"T": _attr(type=F32)}
_NHWC = {"data_format": _attr(s=b"NHWC")}


class _Writer:
    """The frozen graph lists the placeholder, then every Const in layer
    order, then the ops in execution order: one walk over the network fills
    both lists."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.consts: list[Message] = []
        self.ops: list[Message] = []
        self.reads: list[str] = []

    def const(self, name: str, arr: np.ndarray) -> str:
        t = make_tensor_proto(arr)
        self.consts.append(Message("NodeDef", name=name, op="Const", attr={
            "value": _attr(tensor=t), "dtype": _attr(type=t.dtype)}))
        return name

    def op(self, name: str, op: str, inputs, **attrs) -> str:
        self.ops.append(Message("NodeDef", name=name, op=op, input=list(inputs), attr=attrs))
        return name

    def read(self, name: str) -> str:
        """The Identity that reads a frozen variable (its Const `name/resource`)."""
        self.reads.append(name)
        return self.op(name, "Identity", [f"{name}/resource"], **_T,
                       _has_manual_control_dependencies=_attr(b=True))

    def reshape(self, scope: str, suffix: str, read: str) -> str:
        return self.op(f"{scope}/Reshape{suffix}", "Reshape",
                       [read, f"{scope}/Reshape{suffix}/shape"], **_T, Tshape=_attr(type=I32))

    def conv(self, x: str, name: str, k: int, cin: int, cout: int, stride: int,
             padding: str) -> str:
        """Conv2D, then its bias reshaped, squeezed and added (BiasAdd)."""
        w = self.rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cin))
        b = self.rng.standard_normal(cout) * 0.01
        scope = f"{SCOPE}/{name}_1"
        self.const(f"{scope}/convolution/ReadVariableOp/resource", w.astype(np.float32))
        self.const(f"{scope}/Reshape/ReadVariableOp/resource", b.astype(np.float32))
        self.const(f"{scope}/Reshape/shape", np.array([1, 1, 1, cout], np.int32))
        conv = self.op(f"{scope}/convolution", "Conv2D",
                       [x, self.read(f"{scope}/convolution/ReadVariableOp")], **_T, **_NHWC,
                       dilations=_ints([1, 1, 1, 1]), explicit_paddings=_ints([]),
                       padding=_attr(s=padding.encode()), strides=_ints([1, stride, stride, 1]),
                       use_cudnn_on_gpu=_attr(b=True))
        bias = self.reshape(scope, "", self.read(f"{scope}/Reshape/ReadVariableOp"))
        bias = self.op(f"{scope}/Squeeze", "Squeeze", [bias], **_T, squeeze_dims=_ints([]))
        return self.op(f"{scope}/BiasAdd", "BiasAdd", [conv, bias], **_T, **_NHWC)

    def batch_norm(self, x: str, name: str, c: int, gain: float = 1.0) -> str:
        """Keras 3's BatchNormalization: the moving mean (Cast), moving
        variance (Cast_1), gamma (Cast_2) and beta (Cast_3) reshaped, then
        tf.nn.batch_normalization's ops."""
        rng = self.rng
        gamma = (np.abs(rng.standard_normal(c)) + 0.5) * gain
        beta = rng.standard_normal(c) * 0.1
        mean = rng.standard_normal(c) * 0.1
        var = np.abs(rng.standard_normal(c)) + 0.5
        scope = f"{SCOPE}/{name}_1"
        shape = np.array([1, 1, 1, c], np.int32)
        for cast, suffix, arr in (("Cast_1", "_1", var), ("Cast_2", "_3", gamma),
                                  ("Cast_3", "_2", beta), ("Cast", "", mean)):
            self.const(f"{scope}/{cast}/ReadVariableOp/resource", arr.astype(np.float32))
            self.const(f"{scope}/Reshape{suffix}/shape", shape)
            if cast == "Cast_1":
                self.const(f"{scope}/batchnorm/add/y", np.array(EPS, np.float32))
        bn = f"{scope}/batchnorm"
        var_ = self.reshape(scope, "_1", self.read(f"{scope}/Cast_1/ReadVariableOp"))
        inv = self.op(f"{bn}/Rsqrt", "Rsqrt",
                      [self.op(f"{bn}/add", "AddV2", [var_, f"{bn}/add/y"], **_T)], **_T)
        gamma_ = self.reshape(scope, "_3", self.read(f"{scope}/Cast_2/ReadVariableOp"))
        scale = self.op(f"{bn}/mul", "Mul", [inv, gamma_], **_T)
        xs = self.op(f"{bn}/mul_1", "Mul", [x, scale], **_T)
        beta_ = self.reshape(scope, "_2", self.read(f"{scope}/Cast_3/ReadVariableOp"))
        mean_ = self.reshape(scope, "", self.read(f"{scope}/Cast/ReadVariableOp"))
        shift = self.op(f"{bn}/sub", "Sub",
                        [beta_, self.op(f"{bn}/mul_2", "Mul", [mean_, scale], **_T)], **_T)
        return self.op(f"{bn}/add_1", "AddV2", [xs, shift], **_T)

    def relu(self, x: str, name: str) -> str:
        return self.op(f"{SCOPE}/{name}_1/Relu", "Relu", [x], **_T)

    def pad(self, x: str, name: str, p: int) -> str:
        scope = f"{SCOPE}/{name}_1"
        self.const(f"{scope}/Const", np.array([[0, 0], [p, p], [p, p], [0, 0]], np.int32))
        return self.op(f"{scope}/Pad", "Pad", [x, f"{scope}/Const"], **_T,
                       Tpaddings=_attr(type=I32))

    def residual_add(self, x: str, y: str, name: str, y_shape) -> str:
        """Keras's `ops.add(shortcut, branch)`: an AddV2, or a BiasAdd of the
        branch squeezed where the branch squeezes to the channels alone (a
        1 x 1 map at batch 1)."""
        scope = f"{SCOPE}/{name}_1"
        if [d for d in y_shape if d > 1] == [y_shape[-1]]:
            y = self.op(f"{scope}/Squeeze", "Squeeze", [y], **_T, squeeze_dims=_ints([]))
            return self.op(f"{scope}/BiasAdd", "BiasAdd", [x, y], **_T, **_NHWC)
        return self.op(f"{scope}/Add", "AddV2", [x, y], **_T)


def resnet50_keras(batch_size: int = 1, image_size: int = 224, num_classes: int = 1000,
                   seed: int = 0) -> bytes:
    """The serialized frozen GraphDef (a `.pb` file's bytes) of Keras's
    ResNet-50 at `batch_size` x `image_size`^2 x 3 (NHWC, input "x", output
    "Identity": the softmax)."""
    wr = _Writer(seed)
    h = wr.pad("x", "conv1_pad", 3)
    h = wr.batch_norm(wr.conv(h, "conv1_conv", 7, 3, 64, 2, "VALID"), "conv1_bn", 64)
    h = wr.relu(h, "conv1_relu")
    h = wr.pad(h, "pool1_pad", 1)
    h = wr.op(f"{SCOPE}/pool1_pool_1/MaxPool2d", "MaxPool", [h], **_T, **_NHWC,
              explicit_paddings=_ints([]), ksize=_ints([1, 3, 3, 1]),
              padding=_attr(s=b"VALID"), strides=_ints([1, 2, 2, 1]))
    size = ((image_size + 6 - 7) // 2 + 1 + 2 - 3) // 2 + 1
    cin = 64
    for stage, (blocks, width, stride) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512),
                                                        (1, 2, 2, 2))):
        for i in range(blocks):
            name = f"conv{stage + 2}_block{i + 1}"
            s = stride if i == 0 else 1
            cout = 4 * width
            if i == 0:
                sc = wr.batch_norm(wr.conv(h, f"{name}_0_conv", 1, cin, cout, s, "VALID"),
                                   f"{name}_0_bn", cout)
            else:
                sc = h
            r = wr.batch_norm(wr.conv(h, f"{name}_1_conv", 1, cin, width, s, "VALID"),
                              f"{name}_1_bn", width)
            r = wr.relu(r, f"{name}_1_relu")
            r = wr.batch_norm(wr.conv(r, f"{name}_2_conv", 3, width, width, 1, "SAME"),
                              f"{name}_2_bn", width)
            r = wr.relu(r, f"{name}_2_relu")
            r = wr.batch_norm(wr.conv(r, f"{name}_3_conv", 1, width, cout, 1, "VALID"),
                              f"{name}_3_bn", cout, gain=0.25)
            size = (size - 1) // s + 1
            h = wr.relu(wr.residual_add(sc, r, f"{name}_add", (batch_size, size, size, cout)),
                        f"{name}_out")
            cin = cout
    wr.const(f"{SCOPE}/avg_pool_1/Mean/reduction_indices", np.array([1, 2], np.int32))
    h = wr.op(f"{SCOPE}/avg_pool_1/Mean", "Mean", [h, f"{SCOPE}/avg_pool_1/Mean/reduction_indices"],
              **_T, Tidx=_attr(type=I32), keep_dims=_attr(b=False))
    fc = f"{SCOPE}/predictions_1"
    w = wr.rng.standard_normal((cin, num_classes)) * np.sqrt(2.0 / cin) * FC_GAIN
    wr.const(f"{fc}/Cast/ReadVariableOp/resource", w.astype(np.float32))
    wr.const(f"{fc}/BiasAdd/ReadVariableOp/resource",
             (wr.rng.standard_normal(num_classes) * 0.01).astype(np.float32))
    h = wr.op(f"{fc}/MatMul", "MatMul", [h, wr.read(f"{fc}/Cast/ReadVariableOp")], **_T,
              grad_a=_attr(b=False), grad_b=_attr(b=False), transpose_a=_attr(b=False),
              transpose_b=_attr(b=False))
    h = wr.op(f"{fc}/BiasAdd", "BiasAdd", [h, wr.read(f"{fc}/BiasAdd/ReadVariableOp")], **_T,
              **_NHWC)
    h = wr.op(f"{fc}/Softmax", "Softmax", [h], **_T)
    placeholder = Message("NodeDef", name="x", op="Placeholder", attr={
        "shape": _attr(shape=shape_proto((batch_size, image_size, image_size, 3))),
        "dtype": _attr(type=F32)})
    noop = Message("NodeDef", name="NoOp", op="NoOp", input=[f"^{r}" for r in sorted(wr.reads)],
                   attr={"_has_manual_control_dependencies": _attr(b=True)})
    out = Message("NodeDef", name="Identity", op="Identity", input=[h, "^NoOp"], attr=dict(_T))
    return encode(Message("GraphDef", node=[placeholder] + wr.consts + wr.ops + [noop, out],
                          versions=Message("VersionDef", producer=PRODUCER)))
