"""Models of the PyTorch import path and of FQ2I, without jax: the small
torch.ao-quantized models of tests/test_torch_quantized.py (the classes and
the quantize helpers, copied), the three QDQ ONNX models of
tests/test_fq2i.py (QDQ conv, QLinearConv, QLinearMatMul), written with the
port's own protobuf encoder, and `same_graph`, the new tests' graph
comparison.  Shared by tests/test_torch_port_torch_quantized.py and
tests/test_torch_port_fq2i.py (which hold these copies to the JAX tests'
own functions), tests/test_torch_port_cuda.py and chip_smoke.py phase 22d.
"""

import warnings

import numpy as np
import torch

from tachikoma_tpu_torch.frontend.onnx_proto import decode, encode, np_to_tensor


def same_graph(a, b) -> bool:
    """`a.to_json() == b.to_json()` without compressing the params (seconds
    a ResNet-50): the JSON without params, then every param's dtype, shape
    and bytes."""
    if a.to_json(include_params=False) != b.to_json(include_params=False):
        return False
    if sorted(a.params) != sorted(b.params):
        return False
    for k, v in a.params.items():
        w = b.params[k]
        v, w = np.ascontiguousarray(v), np.ascontiguousarray(w)
        if v.dtype != w.dtype or v.shape != w.shape or v.tobytes() != w.tobytes():
            return False
    return True


# ---------------------------------------------------------------------------
# torch.ao (tests/test_torch_quantized.py)
# ---------------------------------------------------------------------------


def fx_quantize(model, example, n_calib=8, seed=0, backend="qnnpack"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from torch.ao.quantization import QConfigMapping, get_default_qconfig
        from torch.ao.quantization.quantize_fx import convert_fx, prepare_fx

        qm = QConfigMapping().set_global(get_default_qconfig(backend))
        mp = prepare_fx(model.eval(), qm, (example,))
        g = torch.Generator().manual_seed(seed)
        for _ in range(n_calib):
            mp(torch.randn(example.shape, generator=g))
        return convert_fx(mp)


def fx_quantize_qint8(model, example, n_calib=8, seed=0):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from torch.ao.quantization import QConfigMapping, default_symmetric_qnnpack_qconfig
        from torch.ao.quantization.backend_config import get_qnnpack_backend_config
        from torch.ao.quantization.quantize_fx import convert_fx, prepare_fx

        qm = QConfigMapping().set_global(default_symmetric_qnnpack_qconfig)
        bc = get_qnnpack_backend_config()
        mp = prepare_fx(model.eval(), qm, (example,), backend_config=bc)
        g = torch.Generator().manual_seed(seed)
        for _ in range(n_calib):
            mp(torch.randn(example.shape, generator=g))
        return convert_fx(mp, backend_config=bc)


class ConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.pool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(16, 10)

    def forward(self, x):
        x = self.relu(self.conv(x))
        x = self.conv2(x)
        x = self.pool(x).flatten(1)
        return self.fc(x)


class ResBlockNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(4, 8, 3, padding=1)
        self.conv2 = nn.Conv2d(8, 8, 3, padding=1)
        self.conv3 = nn.Conv2d(8, 8, 1)
        self.pool = nn.MaxPool2d(2)
        self.add = torch.ao.nn.quantized.FloatFunctional()

    def forward(self, x):
        y = self.conv1(x)
        z = self.add.add(self.conv2(y), self.conv3(y))
        return self.pool(z)


class MNv3Flavor(torch.nn.Module):
    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.hs = nn.Hardswish()
        self.r6 = nn.ReLU6()
        self.lr = nn.LeakyReLU(0.1)
        self.ct = nn.ConvTranspose2d(8, 4, 3, stride=2, padding=1, output_padding=1)
        self.pool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(4, 5)

    def forward(self, x):
        h = self.conv(x)
        h = self.hs(h)
        h = h + 3.0
        h = h * 0.5
        h = self.r6(h)
        h = torch.nn.functional.hardswish(h)
        h = self.lr(h)
        h = self.ct(h)
        h = self.pool(h).flatten(1)
        return self.fc(h)


class DeepResNet(torch.nn.Module):
    class Block(torch.nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            nn = torch.nn
            self.c1 = nn.Conv2d(cin, cout, 3, stride, 1)
            self.r1 = nn.ReLU()
            self.c2 = nn.Conv2d(cout, cout, 3, 1, 1)
            self.down = (nn.Conv2d(cin, cout, 1, stride)
                         if stride != 1 or cin != cout else None)
            self.f = torch.ao.nn.quantized.FloatFunctional()

        def forward(self, x):
            idn = x if self.down is None else self.down(x)
            h = self.c2(self.r1(self.c1(x)))
            return self.f.add_relu(h, idn)

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.stem = nn.Conv2d(3, 8, 3, padding=1)
        self.b1 = self.Block(8, 8, 1)
        self.b2 = self.Block(8, 16, 2)
        self.b3 = self.Block(16, 16, 1)
        self.pool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(16, 10)

    def forward(self, x):
        h = self.b3(self.b2(self.b1(self.stem(x))))
        return self.fc(self.pool(h).flatten(1))


class EagerQF(torch.nn.Module):
    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.quant = torch.ao.quantization.QuantStub()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2d(8, 8, 3, padding=1)
        self.qf = torch.ao.nn.quantized.FloatFunctional()
        self.dequant = torch.ao.quantization.DeQuantStub()

    def forward(self, x):
        x = self.quant(x)
        h = self.relu(self.conv(x))
        h = self.qf.add(h, self.conv2(h))
        h = self.qf.mul_scalar(h, 0.5)
        return self.dequant(h)


def eager_quantize(model, shape, n_calib=6):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = model.eval()
        m.qconfig = torch.ao.quantization.get_default_qconfig("qnnpack")
        torch.ao.quantization.prepare(m, inplace=True)
        g = torch.Generator().manual_seed(0)
        for _ in range(n_calib):
            m(torch.randn(shape, generator=g))
        torch.ao.quantization.convert(m, inplace=True)
    return m


def _convnet_qint8(shape):
    return fx_quantize_qint8(ConvNet(), torch.randn(*shape))


# name -> (build the quantized model (after torch.manual_seed(0)), input shape),
# as each test of tests/test_torch_quantized.py builds it
TORCH_AO_CASES = {
    "convnet": (lambda: fx_quantize(ConvNet(), torch.randn(2, 3, 32, 32)), (2, 3, 32, 32)),
    "resblock": (lambda: fx_quantize(ResBlockNet(), torch.randn(1, 4, 16, 16)), (1, 4, 16, 16)),
    "convnet_fbgemm": (lambda: fx_quantize(ConvNet(), torch.randn(1, 3, 16, 16),
                                           backend="fbgemm"), (1, 3, 16, 16)),
    "convnet_qint8": (lambda: _convnet_qint8((2, 3, 16, 16)), (2, 3, 16, 16)),
    "mnv3": (lambda: fx_quantize(MNv3Flavor(), torch.randn(2, 3, 16, 16), backend="qnnpack"),
             (2, 3, 16, 16)),
    "deep_resnet": (lambda: fx_quantize(DeepResNet(), torch.randn(2, 3, 16, 16),
                                        backend="fbgemm"), (2, 3, 16, 16)),
    "eager_qf": (lambda: eager_quantize(EagerQF(), (1, 3, 8, 8)), (1, 3, 8, 8)),
}


def torch_ao_case(name):
    """(quantized model, input shape) of TORCH_AO_CASES[name], built after
    torch.manual_seed(0) as the JAX tests build it."""
    build, shape = TORCH_AO_CASES[name]
    torch.manual_seed(0)
    return build(), shape


# ---------------------------------------------------------------------------
# QDQ ONNX (tests/test_fq2i.py)
# ---------------------------------------------------------------------------


def make_model(nodes, inputs, outputs, initializers):
    """tests/test_frontend_onnx.py make_model on the port's codec."""
    def vi(name, shape, elem=1):
        return {"name": name, "type": {"tensor_type": {
            "elem_type": elem, "shape": {"dim": [{"dim_value": s} for s in shape]}}}}

    model = {
        "ir_version": 8,
        "producer_name": "tachikoma_tpu.test",
        "opset_import": [{"domain": "", "version": 17}],
        "graph": {
            "name": "g",
            "node": nodes,
            "initializer": [np_to_tensor(k, v) for k, v in initializers.items()],
            "input": [vi(n, s) for n, s in inputs.items()],
            "output": [vi(n, s) for n, s in outputs.items()],
        },
    }
    return decode(encode(model, "ModelProto"), "ModelProto")


def node(op, ins, outs, **attrs):
    alist = []
    for k, v in attrs.items():
        if isinstance(v, float):
            alist.append({"name": k, "f": v, "type": 1})
        elif isinstance(v, int):
            alist.append({"name": k, "i": v, "type": 2})
        else:
            alist.append({"name": k, "ints": list(v), "type": 7})
    return {"op_type": op, "input": list(ins), "output": list(outs), "attribute": alist}


def qdq_conv_model(rng):
    """x -> Q -> DQ -> Conv(wDQ) -> Relu -> Q -> DQ -> out (tests/test_fq2i.py)."""
    wq = rng.integers(-127, 127, (8, 4, 3, 3)).astype(np.int8)
    wscale = (0.01 + rng.random(8) * 0.02).astype(np.float32)
    bias_f = (rng.standard_normal(8) * 0.5).astype(np.float32)
    nodes = [
        node("QuantizeLinear", ["x", "xs", "xzp"], ["xq"]),
        node("DequantizeLinear", ["xq", "xs", "xzp"], ["xdq"]),
        node("DequantizeLinear", ["w_q", "ws", "wzp"], ["wdq"], axis=0),
        node("Conv", ["xdq", "wdq", "bias"], ["c"], pads=[1, 1, 1, 1], strides=[1, 1]),
        node("Relu", ["c"], ["r"]),
        node("QuantizeLinear", ["r", "ys", "yzp"], ["yq"]),
        node("DequantizeLinear", ["yq", "ys", "yzp"], ["y"]),
    ]
    inits = {"xs": np.float32(0.05), "xzp": np.int8(3), "ws": wscale,
             "wzp": np.zeros(8, np.int8), "ys": np.float32(0.04), "yzp": np.int8(-8),
             "w_q": wq, "bias": bias_f}
    return make_model(nodes, {"x": (1, 4, 8, 8)}, {"y": (1, 8, 8, 8)}, inits), (1, 4, 8, 8)


def qlinear_conv_model(rng):
    wq = rng.integers(-100, 100, (6, 3, 3, 3)).astype(np.int8)
    bq = rng.integers(-500, 500, 6).astype(np.int32)
    nodes = [
        node("QuantizeLinear", ["x", "xs", "xzp"], ["xq"]),
        node("QLinearConv", ["xq", "xs", "xzp", "w_q", "ws", "wzp", "ys", "yzp", "bias"],
             ["yq"], pads=[1, 1, 1, 1], strides=[1, 1]),
        node("DequantizeLinear", ["yq", "ys", "yzp"], ["y"]),
    ]
    inits = {"xs": np.float32(0.03), "xzp": np.int8(0), "ws": np.float32(0.015),
             "wzp": np.int8(0), "ys": np.float32(0.1), "yzp": np.int8(5), "w_q": wq, "bias": bq}
    return (make_model(nodes, {"x": (1, 3, 10, 10)}, {"y": (1, 6, 10, 10)}, inits),
            (1, 3, 10, 10))


def qlinear_matmul_model(rng):
    aq_w = rng.integers(-127, 127, (16, 12)).astype(np.int8)
    nodes = [
        node("QuantizeLinear", ["x", "xs", "xzp"], ["xq"]),
        node("QLinearMatMul", ["xq", "xs", "xzp", "w_q", "ws", "wzp", "ys", "yzp"], ["yq"]),
        node("DequantizeLinear", ["yq", "ys", "yzp"], ["y"]),
    ]
    inits = {"xs": np.float32(0.05), "xzp": np.int8(2), "ws": np.float32(0.02),
             "wzp": np.int8(0), "ys": np.float32(0.2), "yzp": np.int8(0), "w_q": aq_w}
    return make_model(nodes, {"x": (4, 16)}, {"y": (4, 12)}, inits), (4, 16)


# name -> make(rng) -> (model dict, input shape)
QDQ_CASES = {"qdq_conv": qdq_conv_model, "qlinear_conv": qlinear_conv_model,
             "qlinear_matmul": qlinear_matmul_model}
