"""Keras frontend: import Keras 3 models, in memory or from `.keras` / `.h5`
files (port of `tachikoma_tpu/frontend/keras.py`).

Keras 3 has no stable layer-graph API, but every Keras model is a callable
that traces through `tf.function`.  So a model is traced into a frozen
TensorFlow GraphDef (variables folded to constants) and converted by
`frontend/tensorflow.py`: one op-level converter serves both frameworks, and
the imported graph is the model's own executed graph.  TensorFlow and Keras
are imported when `from_keras` is called, never when this module is.
"""

from __future__ import annotations

from ..ir.graph import Graph

__all__ = ["from_keras"]


def from_keras(model_or_path, input_shapes=None, batch: int = 1) -> Graph:
    """Import a Keras model (instance or path to .keras/.h5).

    input_shapes: optional list of concrete per-input shapes (with batch
    dim) overriding the model's declared inputs; otherwise shapes come from
    `model.inputs` with unknown batch dims replaced by `batch`.
    """
    import tensorflow as tf

    from .tensorflow import from_tf_function

    if isinstance(model_or_path, (str, bytes)):
        import keras

        model = keras.models.load_model(model_or_path, compile=False)
    else:
        model = model_or_path

    if input_shapes is None:
        input_shapes = []
        for t in model.inputs:
            shape = [batch if d is None else int(d) for d in t.shape]
            input_shapes.append((shape, t.dtype.name if hasattr(t.dtype, "name") else str(t.dtype)))
    else:
        input_shapes = [
            (list(s), "float32") if not (isinstance(s, tuple) and len(s) == 2
                                         and isinstance(s[1], str)) else s
            for s in input_shapes
        ]

    specs = [tf.TensorSpec(shape, getattr(tf, dtype)) for shape, dtype in input_shapes]
    if len(specs) == 1:
        fn = tf.function(lambda x: model(x, training=False))
        return from_tf_function(fn, specs)
    fn = tf.function(lambda *xs: model(list(xs), training=False))
    return from_tf_function(fn, specs)
