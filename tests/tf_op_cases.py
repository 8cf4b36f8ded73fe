"""The op cases of the six ops the TensorFlow importer emits that the port
had no torch impl for (rsqrt, floor_divide, floor_mod, all, any, stack),
shared by tests/test_torch_port_tf_ops.py (the port against the JAX package
on the CPU), tests/test_torch_port_cuda.py and chip_smoke.py phase 25d (the
port on the card against its CPU torch impl).  It imports neither jax nor the
JAX package.

The inputs are tests/test_frontend_tf.py's shapes ((3, 17) for the
elementwise zoo's rsqrt, (2, 4, 4, 3) and (2, 5, 6) for the shape and slice
folds), made from seeds, and the edge cases: an integer divided by zero
(numpy's 0; torch raises on the CPU and gives garbage on CUDA), int8 -128
divided by -1, signed zeros and infinities, a float floor mod's sign (the
divisor's, as np.mod and torch.remainder, not torch.fmod's), NaN as a truth
value, a negative stacking axis.

A case is (id, op, inputs, attrs, tol, jax, n_out, graph), as in
tests/onnx_op_cases.py: `tol` is EXACT (==) for every case here (each op is
exact in float32 or an integer op); `jax` False where the JAX package's jax
impl departs from its oracle (XLA's integer division by zero, its float
floor division and mod at a zero divisor or an infinity, in float64, and
its rsqrt)."""

import numpy as np

from onnx_op_cases import EXACT, SPECIAL, case, floats, ints

I8_A = np.array([-128, -7, -1, 0, 5, 127, 3, -3, 7, -128], np.int8)
I8_B = np.array([-1, 2, 0, 3, -2, 0, -3, 3, 7, 1], np.int8)
F_A = np.array([-7.5, 7.5, 0.0, -0.0, 3.0, -3.0, 1e30, 5.0, np.inf, -1.0], np.float32)
F_B = np.array([2.0, -2.0, 3.0, -3.0, 0.0, -0.0, 3.0, -5.0, 2.0, np.inf], np.float32)
BOOLS = np.random.default_rng(3).standard_normal((2, 4, 4, 3)) > 0.5
NAN_TRUTH = np.array([[0.0, np.nan, 0.0], [1.0, 2.0, -0.0]], np.float32)

CASES = [
    # -- rsqrt (ops/nn.py) ------------------------------------------------------
    case("rsqrt_zoo", "rsqrt", [1.0 + np.square(floats(3, 17))], jax=False),
    case("rsqrt_small", "rsqrt", [floats(4, 9, seed=1, lo=1e-6)], jax=False),
    case("rsqrt_special", "rsqrt", [np.abs(SPECIAL)], jax=False),
    case("rsqrt_negative", "rsqrt", [np.array([-1.0, -4.0, 4.0], np.float32)], jax=False),
    case("rsqrt_float64", "rsqrt", [floats(3, 17, seed=2, lo=0.1).astype(np.float64)],
         jax=False),
    case("rsqrt_int32", "rsqrt", [ints(3, 5, lo=1, hi=1000, dtype=np.int32)], jax=False),
    # -- floor_divide (ops/nn.py) -----------------------------------------------
    case("floor_divide_int8_zero", "floor_divide", [I8_A, I8_B], jax=False),
    case("floor_divide_int32_broadcast", "floor_divide",
         [ints(3, 4, lo=-100, hi=100, dtype=np.int32), np.array([-3, 2, 5, -7], np.int32)]),
    case("floor_divide_float_special", "floor_divide", [F_A, F_B], jax=False),
    case("floor_divide_float", "floor_divide", [floats(2, 5, 6, scale=10),
                                                floats(2, 5, 6, seed=1, lo=0.5)]),
    case("floor_divide_shape_fold", "floor_divide",
         [np.array([2, 4, 4, 3], np.int32), np.array(2, np.int32)]),
    # -- floor_mod (ops/tail3.py) -----------------------------------------------
    case("floor_mod_int8_zero", "floor_mod", [I8_A, I8_B], jax=False),
    case("floor_mod_int64", "floor_mod",
         [ints(3, 4, lo=-100, hi=100, dtype=np.int64), np.array([-3, 2, 5, -7], np.int64)]),
    case("floor_mod_float_special", "floor_mod", [F_A, F_B], jax=False),
    case("floor_mod_float_sign", "floor_mod", [floats(2, 5, 6, scale=10),
                                               -floats(2, 5, 6, seed=1, lo=0.5)]),
    case("floor_mod_float_int_mixed", "floor_mod",
         [floats(3, 4, scale=5), np.array([-3, 2, 0, 7], np.int32)], jax=False),
    # -- all / any (ops/nn.py) ----------------------------------------------------
    case("all_axis1", "all", [BOOLS], dict(axis=(1,), keepdims=False)),
    case("all_hw_keepdims", "all", [BOOLS], dict(axis=(1, 2), keepdims=True)),
    case("all_every_axis", "all", [BOOLS]),
    case("all_negative_axis", "all", [BOOLS], dict(axis=(-1,), keepdims=False)),
    case("all_no_axis", "all", [BOOLS], dict(axis=(), keepdims=False)),
    case("all_nan_truth", "all", [NAN_TRUTH], dict(axis=(1,), keepdims=False)),
    case("any_axis1", "any", [BOOLS], dict(axis=(1,), keepdims=False)),
    case("any_hw_keepdims", "any", [BOOLS], dict(axis=(1, 2), keepdims=True)),
    case("any_every_axis", "any", [~BOOLS]),
    case("any_int8", "any", [ints(2, 5, 6, lo=-1, hi=2)], dict(axis=(0, 2), keepdims=False)),
    case("any_nan_truth", "any", [NAN_TRUTH], dict(axis=(1,), keepdims=False)),
    # -- stack (ops/extra.py) -----------------------------------------------------
    case("stack_axis0", "stack", [floats(2, 5, 6), floats(2, 5, 6, seed=1)], dict(axis=0)),
    case("stack_axis_last", "stack", [floats(2, 5, 6), floats(2, 5, 6, seed=1),
                                      floats(2, 5, 6, seed=2)], dict(axis=3)),
    case("stack_axis_minus1", "stack", [floats(2, 5, 6), floats(2, 5, 6, seed=1)],
         dict(axis=-1)),
    case("stack_axis_minus3", "stack", [floats(2, 5, 6), floats(2, 5, 6, seed=1)],
         dict(axis=-3)),
    case("stack_shape_scalars", "stack", [np.array(2, np.int32), np.array(48, np.int32)],
         dict(axis=0)),
    case("stack_int8", "stack", [ints(3, 4), ints(3, 4, seed=1)], dict(axis=1)),
]

assert all(c[4] is EXACT for c in CASES)
