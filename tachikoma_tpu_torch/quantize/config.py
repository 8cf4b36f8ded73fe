"""Quantization configuration (port of `tachikoma_tpu/quantize/config.py`).

The same QConfig fields as the JAX package, so a configuration carries over;
its calibration runs the numpy oracle or, as the JAX package's "xla-cpu"
backend does on XLA, the port's segmented executor on the CPU ("torch-cpu").
The JAX package's three presets: TRANSFORMER_INT8, TRANSFORMER_INT8_SCAN and
W8A16."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class QConfig:
    # activation quantization
    act_dtype: str = "int8"
    act_symmetric: bool = True          # zp=0 (symmetric) vs asymmetric minmax
    # weight quantization
    weight_dtype: str = "int8"
    weight_per_channel: bool = True
    # accumulator / bias
    accum_dtype: str = "int32"
    bias_dtype: str = "int32"
    # requantize behavior (reference default rounding is UPWARD,
    # `src/relay/qnn/op/requantize_config.h`)
    rounding: str = "UPWARD"
    # calibration
    calibrate_mode: str = "max"         # "max" (absmax) | "minmax" | "percentile" | "kl"
    percentile: float = 99.99
    kl_bins: int = 2048
    # ops that stay float (executed via dequantize -> float -> quantize)
    float_ops: frozenset = frozenset({"nn.softmax", "nn.log_softmax", "erf", "nn.gelu"})
    # skip quantizing graph outputs back to int (emit dequantized floats)
    dequantize_outputs: bool = True
    # deterministic softmax-free attention path: rewrite nn.softmax on a
    # quantized input to the integer LUT softmax (qnn.softmax) — BASELINE
    # config 4's 'deterministic softmax-free path'
    integer_softmax: bool = False
    # float unary ops realized as 256-entry int8 LUTs (qnn.lut) instead of
    # dequant->float->quant; wins determinism + fusion
    lut_ops: frozenset = frozenset()
    # nn.layer_norm -> qnn.layer_norm (pinned integer semantics) instead of a
    # dequantized float island (ops/qnn.py integer layer norm)
    integer_layer_norm: bool = True
    # calibration executor: "oracle" (numpy interpreter, the exactness
    # reference) or "torch-cpu" (the segmented executor on the CPU, streamed:
    # the counterpart of the JAX package's "xla-cpu")
    calibrate_backend: str = "oracle"
    # scale tying: a regex matching the layer-varying part of node names
    # (e.g. r"block\d+"); nodes/weights whose names differ only in that
    # part share ONE pooled quantization scale, so structurally identical
    # layers get IDENTICAL integer attrs.
    scale_group: str | None = None


# Preset for the BERT/ViT integer-attention trace path.
TRANSFORMER_INT8 = QConfig(
    integer_softmax=True,
    lut_ops=frozenset({"nn.gelu", "tanh", "sigmoid", "nn.silu", "erf"}),
    float_ops=frozenset({"nn.log_softmax"}),
)


# TRANSFORMER_INT8 with layer-tied scales: structurally identical encoder/
# decoder layers get IDENTICAL integer attrs, so the segmented executor runs
# deep quantized transformers as O(1) programs with a scan over stacked
# layer weights (runtime/segmented.py).  Group-max scales are slightly
# coarser than per-layer calibration.
TRANSFORMER_INT8_SCAN = replace(TRANSFORMER_INT8, scale_group=r"(block|layer)\d+")


# 16-bit activations x 8-bit weights (the TFLite "16x8" mode): int64
# accumulators and biases, requantized on the wide fixed-point path
# (ops/fixed_point.py q_multiply_shift_wide_*).  fuse_qnn leaves the int64
# heads unfused; on the card their products run on kernels of their own,
# one wgmma pass over the int16 activations' two byte planes
# (ops/kernels/wide.py).
W8A16 = QConfig(act_dtype="int16", accum_dtype="int64", bias_dtype="int64")
