"""Model importers.  The port has the torch.fx importer (`from_torch`: float
nn.Modules), the prequantized-torch importer (torch.ao-quantized models,
through FQ2I), the ONNX importer (float models, and QDQ / QLinear models,
which `quantize/fq2i.py` turns into integer ops; the in-tree protobuf codec)
and the TFLite importer (prequantized int8 and 16x8 models; the in-tree
flatbuffer reader); the JAX package's TensorFlow and Keras frontends wait
for ROADMAP Queue 1 item 12."""

from .onnx import from_onnx
from .tflite import from_tflite
from .torch_fx import from_torch

__all__ = ["from_onnx", "from_tflite", "from_torch"]
