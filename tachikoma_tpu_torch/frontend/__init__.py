"""Model importers.  The port has the TFLite importer (prequantized int8 and
16x8 models; the in-tree flatbuffer reader); the JAX package's ONNX, torch.fx
and other frontends wait for ROADMAP Queue 1 item 12."""

from .tflite import from_tflite

__all__ = ["from_tflite"]
