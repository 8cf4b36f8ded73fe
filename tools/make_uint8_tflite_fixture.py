"""Write `tests/fixtures/small_cnn_uint8.tflite` and its golden
`small_cnn_uint8_io.npz` with TensorFlow's legacy (TF1) converter.

The model is a legacy uint8 quantized TFLite model, as TF1's
quantization-aware converter writes them (`inference_type=QUANTIZED_UINT8`):
a graph of fake-quant ops whose ranges were learned (here: drawn from a
seed), converted with `tf.compat.v1.lite.TFLiteConverter.from_session` at
`inference_type=tf.uint8`.  Every activation is uint8, every weight is
uint8 per tensor with the zero point its asymmetric range gives (not 0),
biases int32 at input scale x weight scale.  Its ops:

  * CONV_2D 3x3 s1 SAME, RELU6, 3 -> 8;
  * DEPTHWISE_CONV_2D 3x3 at dilation 2 (TF folds the atrous conv into the
    op's dilation factors), RELU6;
  * CONV_2D 1x1, 8 -> 8;
  * ADD of the two;
  * AVERAGE_POOL_2D 2x2 s2;
  * RESHAPE, FULLY_CONNECTED 512 -> 10;
  * SOFTMAX (scale 1/256, zero point 0).

The golden is TFLite's own interpreter on a seeded uint8 input.  Run once
where TensorFlow is installed:

    python tools/make_uint8_tflite_fixture.py [OUT_DIR]

The fixture is committed, so its tests need no TensorFlow.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np

FIX = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")
NAME = "small_cnn_uint8"
SHAPE = (1, 16, 16, 3)


def _fq(tf, x, lo, hi):
    return tf.quantization.fake_quant_with_min_max_vars(x, lo, hi, num_bits=8)


def build_and_convert(seed: int = 0) -> bytes:
    """The fake-quant graph, converted to uint8 TFLite bytes."""
    import tensorflow as tf

    rng = np.random.default_rng(seed)
    v1 = tf.compat.v1
    graph = tf.Graph()
    with graph.as_default():
        inp = v1.placeholder(tf.float32, SHAPE, name="x")
        x = _fq(tf, inp, -1.0, 127.0 / 128.0)  # scale 1/128, zero point 128

        def weight(shape, lo, hi):
            return _fq(tf, tf.constant(rng.uniform(lo, hi, shape).astype(np.float32)), lo, hi)

        def bias(n):
            return tf.constant(rng.uniform(-0.2, 0.2, n).astype(np.float32))

        c1 = tf.nn.conv2d(x, weight((3, 3, 3, 8), -0.35, 0.55), [1, 1, 1, 1], "SAME")
        c1 = _fq(tf, tf.nn.relu6(c1 + bias(8)), 0.0, 6.0)
        dw = tf.nn.depthwise_conv2d(c1, weight((3, 3, 8, 1), -0.6, 0.4), [1, 1, 1, 1], "SAME",
                                    dilations=[2, 2])
        dw = _fq(tf, tf.nn.relu6(dw + bias(8)), 0.0, 6.0)
        pw = tf.nn.conv2d(dw, weight((1, 1, 8, 8), -0.25, 0.5), [1, 1, 1, 1], "VALID")
        pw = _fq(tf, pw + bias(8), -4.0, 5.0)
        s = _fq(tf, pw + dw, -3.0, 9.0)
        p = _fq(tf, tf.nn.avg_pool2d(s, 2, 2, "VALID"), -3.0, 9.0)
        f = tf.reshape(p, (1, 8 * 8 * 8))
        fc = tf.matmul(f, weight((8 * 8 * 8, 10), -0.1, 0.12)) + bias(10)
        fc = _fq(tf, fc, -6.0, 8.0)
        out = _fq(tf, tf.nn.softmax(fc), 0.0, 255.0 / 256.0)
        out = tf.identity(out, name="y")
        with v1.Session(graph=graph) as sess:
            conv = v1.lite.TFLiteConverter.from_session(sess, [inp], [out])
            conv.inference_type = tf.uint8
            # (mean, std): real = (q - 128) / 128
            conv.quantized_input_stats = {"x": (128.0, 128.0)}
            return conv.convert()


def main() -> None:
    import tensorflow as tf

    out_dir = sys.argv[1] if len(sys.argv) > 1 else FIX
    blob = build_and_convert()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{NAME}.tflite"), "wb") as f:
        f.write(blob)
    interp = tf.lite.Interpreter(model_content=blob, experimental_preserve_all_tensors=True)
    interp.allocate_tensors()
    (inp,), (out,) = interp.get_input_details(), interp.get_output_details()
    x = np.random.default_rng(1).integers(0, 256, inp["shape"], dtype=np.uint8)
    interp.set_tensor(inp["index"], x)
    interp.invoke()
    y = interp.get_tensor(out["index"])
    # every activation the interpreter computed, by tensor name (the
    # one-quantum rule is held op by op: an op's difference feeds the next)
    acts = {f"t_{d['name']}": interp.get_tensor(d["index"])
            for d in interp.get_tensor_details()
            if d["dtype"] == np.uint8 and len(d["shape"]) and d["shape"][0] == 1}
    np.savez(os.path.join(out_dir, f"{NAME}_io.npz"), x=x, y=y, **acts,
             in_scale=inp["quantization"][0], in_zp=inp["quantization"][1],
             out_scale=out["quantization"][0], out_zp=out["quantization"][1])
    print(f"{NAME}: {len(blob)} bytes, in {inp['dtype'].__name__} {tuple(inp['shape'])}, "
          f"out {out['dtype'].__name__} {tuple(y.shape)}")


if __name__ == "__main__":
    main()
