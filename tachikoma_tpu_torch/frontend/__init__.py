"""Model importers.  The port has the ONNX importer (float models, and
QDQ / QLinear models as quantize-dequantize islands; the in-tree protobuf
codec) and the TFLite importer (prequantized int8 and 16x8 models; the
in-tree flatbuffer reader); the JAX package's torch.fx, TensorFlow, Keras
and prequantized-torch frontends wait for ROADMAP Queue 1 item 12."""

from .onnx import from_onnx
from .tflite import from_tflite

__all__ = ["from_onnx", "from_tflite"]
