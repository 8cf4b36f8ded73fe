"""ResNet-50 written as an ONNX file, the way `torch.onnx.export` lays out
torchvision's model in eval mode: each Conv with its batch norm folded into
its weights and bias, Relu, MaxPool, Add on the residual, GlobalAveragePool,
Flatten and Gemm (transB = 1); the stride on the 3x3 conv of a bottleneck
(torchvision's v1.5).  The weights are random from a seed: He-scaled convs
and batch-norm statistics folded as the exporter folds them.  It is written
with the port's own protobuf encoder (frontend/onnx_proto.py), so neither
torch.onnx nor onnx is needed; `frontend/onnx.py from_onnx` imports it.
"""

from __future__ import annotations

import numpy as np

from ..frontend.onnx_proto import encode, np_to_tensor

EPS = 1e-5


def _node(op: str, ins, outs, name: str, **attrs) -> dict:
    alist = []
    for k, v in attrs.items():
        if isinstance(v, str):
            alist.append({"name": k, "s": v.encode(), "type": 3})
        elif isinstance(v, float):
            alist.append({"name": k, "f": v, "type": 1})
        elif isinstance(v, int):
            alist.append({"name": k, "i": v, "type": 2})
        else:
            alist.append({"name": k, "ints": [int(x) for x in v], "type": 7})
    return {"op_type": op, "input": list(ins), "output": list(outs), "name": name,
            "attribute": alist}


def _value_info(name: str, shape) -> dict:
    return {"name": name, "type": {"tensor_type": {
        "elem_type": 1, "shape": {"dim": [{"dim_value": int(s)} for s in shape]}}}}


class _Writer:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.nodes: list[dict] = []
        self.inits: list[dict] = []
        self.n_params = 0

    def param(self, arr: np.ndarray, name: str | None = None) -> str:
        if name is None:
            self.n_params += 1
            name = f"onnx::Conv_{496 + self.n_params}"
        self.inits.append(np_to_tensor(name, arr))
        return name

    def conv(self, x: str, cin: int, cout: int, k: int, stride: int, pad: int,
             scope: str, gain: float = 1.0, dilation: int = 1, groups: int = 1) -> str:
        """Conv with its batch norm folded: w * gamma / sqrt(var + eps) and
        beta - mean * gamma / sqrt(var + eps), in float32; `gain` scales
        gamma (a trained residual branch's last batch norm is small, which
        keeps the sum of sixteen blocks in range)."""
        rng = self.rng
        cin_g = cin // groups
        w = rng.standard_normal((cout, cin_g, k, k)) * np.sqrt(2.0 / (k * k * cin_g))
        gamma = (np.abs(rng.standard_normal(cout)) + 0.5) * gain
        beta = rng.standard_normal(cout) * 0.1
        mean = rng.standard_normal(cout) * 0.1
        var = np.abs(rng.standard_normal(cout)) + 0.5
        s = gamma / np.sqrt(var + EPS)
        wn = self.param((w * s[:, None, None, None]).astype(np.float32))
        bn = self.param((beta - mean * s).astype(np.float32))
        out = f"{scope}/Conv_output_0"
        self.nodes.append(_node("Conv", [x, wn, bn], [out], f"{scope}/Conv",
                                dilations=[dilation] * 2, group=groups, kernel_shape=[k, k],
                                pads=[pad] * 4, strides=[stride, stride]))
        return out

    def op(self, op: str, ins, scope: str, **attrs) -> str:
        out = f"{scope}/{op}_output_0"
        self.nodes.append(_node(op, ins, [out], f"{scope}/{op}", **attrs))
        return out


def resnet50_onnx(batch_size: int = 1, image_size: int = 224, num_classes: int = 1000,
                  seed: int = 0) -> bytes:
    """The serialized ModelProto of ResNet-50 at `batch_size` x 3 x
    `image_size`^2 (NCHW, input "input", output "output": the logits)."""
    wr = _Writer(seed)
    h = wr.conv("input", 3, 64, 7, 2, 3, "/conv1")
    h = wr.op("Relu", [h], "/relu")
    h = wr.op("MaxPool", [h], "/maxpool", ceil_mode=0, dilations=[1, 1], kernel_shape=[3, 3],
              pads=[1, 1, 1, 1], strides=[2, 2])
    cin = 64
    for stage, (nblocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for i in range(nblocks):
            scope = f"/layer{stage + 1}/layer{stage + 1}.{i}"
            stride = 2 if stage > 0 and i == 0 else 1
            cout = width * 4
            r = wr.op("Relu", [wr.conv(h, cin, width, 1, 1, 0, f"{scope}/conv1")],
                      f"{scope}/relu")
            r = wr.op("Relu", [wr.conv(r, width, width, 3, stride, 1, f"{scope}/conv2")],
                      f"{scope}/relu_1")
            r = wr.conv(r, width, cout, 1, 1, 0, f"{scope}/conv3", gain=0.25)
            sc = h if i else wr.conv(h, cin, cout, 1, stride, 0,
                                     f"{scope}/downsample/downsample.0")
            h = wr.op("Relu", [wr.op("Add", [r, sc], scope)], f"{scope}/relu_2")
            cin = cout
    h = wr.op("GlobalAveragePool", [h], "/avgpool")
    h = wr.op("Flatten", [h], "", axis=1)
    fc_w = (wr.rng.standard_normal((num_classes, cin)) * np.sqrt(2.0 / cin)).astype(np.float32)
    fc_b = (wr.rng.standard_normal(num_classes) * 0.01).astype(np.float32)
    wr.nodes.append(_node("Gemm", [h, wr.param(fc_w, "fc.weight"), wr.param(fc_b, "fc.bias")],
                          ["output"], "/fc/Gemm", alpha=1.0, beta=1.0, transB=1))
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
            "output": [_value_info("output", (batch_size, num_classes))],
        },
    }
    return encode(model, "ModelProto")
