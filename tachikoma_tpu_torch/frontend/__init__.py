"""Model importers.  The port has the torch.fx importer (`from_torch`: float
nn.Modules), the prequantized-torch importer (torch.ao-quantized models,
through FQ2I), the ONNX importer (float models, and QDQ / QLinear models,
which `quantize/fq2i.py` turns into integer ops; the in-tree protobuf codec),
the TFLite importer (prequantized int8 and 16x8 models; the in-tree
flatbuffer reader) and the TensorFlow and Keras importers (frozen GraphDefs
through the in-tree GraphDef codec, so a `.pb` file needs no TensorFlow;
tf.functions, SavedModels and Keras models through TensorFlow, imported when
called)."""

from .keras import from_keras
from .onnx import from_onnx
from .tensorflow import from_saved_model, from_tf_function, from_tf_graphdef
from .tflite import from_tflite
from .torch_fx import from_torch

__all__ = ["from_keras", "from_onnx", "from_saved_model", "from_tf_function",
           "from_tf_graphdef", "from_tflite", "from_torch"]
