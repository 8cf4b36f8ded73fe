"""ResNet-50 as a torch `nn.Module` in torchvision's layout, and its
torch.ao quantization: the model the prequantized-torch import path
(frontend/torch_quantized.py) and the float torch.fx path
(frontend/torch_fx.py) are run on.  Not a zoo entry.

The module is torchvision's ResNet-50 (v1.5: the stride on a bottleneck's
3x3 conv; convs without bias, each followed by a batch norm; a 1x1 conv and
batch norm on the shortcut of each stage's first block) with the residual
add written as torchvision's quantizable ResNet writes it,
`FloatFunctional.add_relu`, so that torch.ao quantizes it as
`quantized::add_relu`.  The weights are random from a seed, drawn with
numpy (the same on every machine): He-scaled convs and batch-norm
statistics as `models/onnx_resnet.py` draws them, each residual branch's
last batch norm scaled by 0.25.  With random weights the pooled features
of every image share one large positive direction (cosine 0.997 between
the mean features of noise and of `quantize/dataset.py synthetic_images`
at 224^2), which alone would pick one top-1 class for every image; so each
row of the fc is drawn He-scaled, projected off the pooled features of one
random 224^2 image and scaled by FC_GAIN.  The logits at 224^2 are then
near 10^2 and their top-1 class varies from image to image.

`quantize_fx` is torch.ao's FX graph mode flow (`prepare_fx` with fbgemm's
default qconfig, calibration on one random batch from an explicit
`torch.Generator`, `convert_fx`), whose output `import_torch_quantized`
takes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

FC_GAIN = 2.0   # the projected fc's gain: logits near 10^2 at 224^2


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.relu1 = nn.ReLU()
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.relu2 = nn.ReLU()
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))
        self.skip_add_relu = torch.ao.nn.quantized.FloatFunctional()

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.relu2(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.skip_add_relu.add_relu(out, identity)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for stage, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            layers = []
            for i in range(blocks):
                layers.append(Bottleneck(cin, width, 2 if stage > 0 and i == 0 else 1))
                cin = width * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(cin, 1000)

    def features(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return torch.flatten(self.avgpool(x), 1)

    def forward(self, x):
        return self.fc(self.features(x))


def _fill(model: ResNet50, seed: int) -> None:
    """Random weights from `seed`, in module order."""
    rng = np.random.default_rng(seed)

    def put(t: torch.Tensor, arr: np.ndarray) -> None:
        t.copy_(torch.from_numpy(np.asarray(arr, np.float32)))

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Conv2d):
                cout, cin, k, _ = mod.weight.shape
                put(mod.weight, rng.standard_normal((cout, cin, k, k))
                    * np.sqrt(2.0 / (k * k * cin)))
            elif isinstance(mod, nn.BatchNorm2d):
                c = mod.num_features
                gain = 0.25 if name.endswith("bn3") else 1.0
                put(mod.weight, (np.abs(rng.standard_normal(c)) + 0.5) * gain)
                put(mod.bias, rng.standard_normal(c) * 0.1)
                put(mod.running_mean, rng.standard_normal(c) * 0.1)
                put(mod.running_var, np.abs(rng.standard_normal(c)) + 0.5)
        fc = model.fc
        w = rng.standard_normal(tuple(fc.weight.shape)) * np.sqrt(2.0 / fc.in_features)
        put(fc.bias, rng.standard_normal(fc.out_features) * 0.01)
        model.eval()
        f = model.features(torch.from_numpy(
            rng.standard_normal((1, 3, 224, 224)).astype(np.float32)))[0].double().numpy()
        u = f / np.linalg.norm(f)
        put(fc.weight, (w - np.outer(w @ u, u)) * FC_GAIN)


def resnet50_torch(seed: int = 0) -> ResNet50:
    """The float ResNet-50 module in eval mode, weights from `seed`."""
    model = ResNet50()
    _fill(model, seed)
    return model.eval()


def quantize_fx(model: nn.Module, shape, seed: int = 0) -> torch.fx.GraphModule:
    """torch.ao FX graph mode quantization of `model` (left unchanged):
    `prepare_fx` with `get_default_qconfig("fbgemm")` as the global qconfig
    (weights per-channel symmetric int8, activations quint8 with
    reduce_range: 0..127), one calibration batch of `shape` (NCHW) drawn
    with a `torch.Generator` seeded with `seed`, then `convert_fx`."""
    import copy

    from torch.ao.quantization import QConfigMapping, get_default_qconfig
    from torch.ao.quantization.quantize_fx import convert_fx, prepare_fx

    gen = torch.Generator().manual_seed(seed)
    example = torch.randn(tuple(shape), generator=gen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qm = QConfigMapping().set_global(get_default_qconfig("fbgemm"))
        prepared = prepare_fx(copy.deepcopy(model).eval(), qm, (example,))
        with torch.no_grad():
            prepared(example)
        return convert_fx(prepared)
