"""The op cases of the ONNX importer's 53 ops, shared by
tests/test_torch_port_ops_onnx.py (the port against the JAX package on the
CPU), tests/test_torch_port_cuda.py and chip_smoke.py phase 21c (the port on
the card against its CPU torch impl).  It imports neither jax nor the JAX
package.  The inputs are those of tests/test_ops_np.py, test_ops_extra.py,
test_ops_tail.py, test_ops_tail3.py and test_resize.py for these ops, made
from seeds, and named cases for the places where torch's conventions differ
from the oracle's.

A case is (id, op, inputs, attrs, tol, jax, n_out, graph): `tol` is EXACT
(==) or the float tolerance against the numpy oracle; `jax` False where the
JAX package's jax impl departs from its oracle on the case, JAX_IMPL where
the port follows the jax impl there instead (the oracle's integer `topk`
wraps: ROADMAP Queue 3); `n_out` the
op's outputs; `graph` False where the JAX package's relation and oracle
part (its interpreter refuses the graph), so the impls are called on the
arrays."""

import numpy as np

EXACT = True
JAX_IMPL = "jax_impl"  # the answer is the JAX package's jax impl, not its oracle
ELEM = 1e-6    # elementwise float32 functions: torch's and numpy's may differ by an ulp
SUMS = 1e-5    # reductions, norms, products: another summation order


def floats(*shape, seed=0, scale=1.0, lo=None):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return (np.abs(x) + lo if lo is not None else x).astype(np.float32)


def ints(*shape, seed=0, lo=-128, hi=128, dtype=np.int8):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def signed_divisors(shape, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(1, 9, shape) * rng.choice([-1, 1], shape)
    return b.astype(np.int32)


SPECIAL = np.array([1.0, np.inf, -np.inf, np.nan, 0.0, -0.0, -2.5], np.float32)
TIES = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49, -3.51]], np.float32)
TOPK_TIES = np.array([[3, 1, 3, 2, 3, 1, 2, 0], [5, 5, 5, 5, 4, 4, 6, 6]], np.float32)
TOPK_INT8 = np.array([[-128, 127, 0, -128, 5, -1, 127, -127]], np.int8)
RESIZE = floats(2, 4, 6, 3, seed=7)


def case(cid, op, inputs, attrs=None, tol=EXACT, jax=True, n_out=1, graph=True):
    return (cid, op, inputs, attrs or {}, tol, jax, n_out, graph)


CASES = [
    # -- elementwise unary (ops/nn.py) ----------------------------------------
    case("abs_float", "abs", [floats(3, 7)]),
    case("abs_int8_min", "abs", [np.array([-128, -1, 0, 127], np.int8)]),
    case("negative_float", "negative", [floats(3, 7)]),
    case("negative_int8_min", "negative", [np.array([-128, -1, 0, 127], np.int8)]),
    case("floor_float", "floor", [floats(4, 9, scale=3)]),
    case("floor_int32", "floor", [ints(3, 5, lo=-1000, hi=1000, dtype=np.int32)]),
    case("ceil_float", "ceil", [floats(4, 9, scale=3)]),
    case("ceil_int8", "ceil", [ints(3, 5)]),
    case("round_ties_to_even", "round", [TIES]),
    case("round_float", "round", [floats(4, 9, scale=4)]),
    case("sign_float_nan_zeros", "sign", [SPECIAL]),
    case("sign_int8", "sign", [ints(3, 7)]),
    case("sqrt", "sqrt", [floats(3, 8, lo=0.01)]),  # IEEE sqrt: correctly rounded
    case("log", "log", [floats(2, 7, lo=1.0)], tol=ELEM),
    case("log_zero_and_negative", "log", [np.array([0.0, -1.0, 1e-30, 3.0], np.float32)],
         tol=ELEM),
    case("erf", "erf", [floats(4, 16, scale=2)], tol=ELEM),
    case("nn_leaky_relu", "nn.leaky_relu", [floats(3, 6, 6, 4)], dict(alpha=0.1)),
    case("nn_leaky_relu_int8_truncates", "nn.leaky_relu", [ints(4, 9)], dict(alpha=0.2)),
    case("nn_prelu_nhwc", "nn.prelu", [floats(2, 4, 4, 3), np.array([0.1, 0.2, 0.3], np.float32)],
         dict(axis=-1)),
    case("nn_prelu_nchw", "nn.prelu", [floats(2, 3, 4, 4), np.array([0.1, 0.2, 0.3], np.float32)],
         dict(axis=1)),
    case("nn_prelu_int32_promotes", "nn.prelu",
         [ints(2, 5, lo=-100, hi=100, dtype=np.int32), np.array([0.5] * 5, np.float32)],
         dict(axis=-1)),
    case("nn_log_softmax", "nn.log_softmax", [floats(3, 10)], dict(axis=-1), tol=SUMS),
    case("nn_log_softmax_axis0", "nn.log_softmax", [floats(5, 4, scale=5)], dict(axis=0), tol=SUMS),
    # -- binaries ---------------------------------------------------------------
    case("maximum_float_nan", "maximum", [SPECIAL, SPECIAL[::-1].copy()]),
    case("maximum_broadcast_int8", "maximum", [ints(3, 4), ints(1, 4, seed=1)]),
    case("minimum_float_nan", "minimum", [SPECIAL, SPECIAL[::-1].copy()]),
    case("minimum_mixed_int_float", "minimum",
         [ints(3, 4, dtype=np.int32), floats(3, 4, scale=50)]),
    case("divide_int_trunc", "divide", [np.array([7, -7, 7, -7], np.int32),
                                        np.array([2, 2, -2, -2], np.int32)]),
    case("divide_int_mixed_signs", "divide", [ints(3, 17, lo=-50, hi=50, dtype=np.int32),
                                              signed_divisors((3, 17), 1)]),
    case("divide_int8_min_by_minus_one_wraps", "divide",
         [np.array([-128, -128, 127], np.int8), np.array([-1, 1, -1], np.int8)]),
    case("divide_int_zero_divisor", "divide", [np.array([5, -5, 0, 7], np.int32),
                                               np.array([0, 0, 0, 2], np.int32)], jax=False),
    case("divide_float", "divide", [floats(3, 5), floats(3, 5, seed=1, lo=0.5)]),
    case("divide_int_by_float_float64", "divide",
         [ints(3, 5, dtype=np.int32), floats(3, 5, lo=0.5)]),
    case("mod_int_mixed_signs", "mod", [ints(3, 17, lo=-50, hi=50, dtype=np.int32),
                                        signed_divisors((3, 17), 2)]),
    case("mod_int_zero_divisor", "mod", [np.array([5, -5, 3], np.int32),
                                         np.array([0, 0, -2], np.int32)], jax=False),
    case("mod_float", "mod", [floats(4, 9, scale=10), floats(4, 9, seed=1) + 3.5]),
    case("mod_float_signs", "mod", [np.array([-4.0, 4.0, -3.5, 3.5, 0.0], np.float32),
                                    np.array([2.0, -2.0, 2.0, -2.0, -3.0], np.float32)]),
    case("power_float", "power", [floats(3, 6, lo=0.1), floats(3, 6, seed=1, scale=2)], tol=ELEM),
    case("power_int", "power", [ints(3, 6, lo=-5, hi=6, dtype=np.int32),
                                ints(3, 6, seed=1, lo=0, hi=5, dtype=np.int32)]),
    case("power_int8_wraps", "power", [np.array([3, -2, 2], np.int8),
                                       np.array([5, 7, 7], np.int8)]),
    # -- reductions ---------------------------------------------------------------
    case("sum_float_axis", "sum", [floats(3, 4, 5)], dict(axis=(1,)), tol=SUMS),
    case("sum_int8_to_int32", "sum", [ints(4, 5)], dict(axis=(0,))),
    case("sum_int32_wraps", "sum", [np.full((4,), 2 ** 30, np.int32)], dict(axis=(0,))),
    case("sum_keepdims_all", "sum", [floats(2, 3, 4)], dict(keepdims=True), tol=SUMS),
    case("prod_float", "prod", [floats(2, 3, 5)], dict(axis=(1,)), tol=SUMS),
    case("prod_float_two_axes", "prod", [floats(2, 3, 5, lo=0.5)], dict(axis=(0, 2), keepdims=True),
         tol=SUMS),
    case("min_float", "min", [floats(2, 3, 5)], dict(axis=(1,))),
    case("min_int8_all", "min", [ints(3, 7)]),
    case("argmax_float", "argmax", [floats(3, 4, 5)], dict(axis=(1,))),
    case("argmax_ties_first", "argmax", [np.array([[1, 3, 3, 0], [2, 2, 2, 2]], np.int8)],
         dict(axis=(1,), keepdims=True)),
    case("argmax_flat", "argmax", [floats(3, 7)]),
    case("argmax_nan_first", "argmax", [np.array([[1.0, np.nan, 3.0, np.nan]], np.float32)],
         dict(axis=(1,))),
    case("argmin_float", "argmin", [floats(3, 7)], dict(axis=(1,))),
    case("argmin_ties_first", "argmin", [np.array([[1, 0, 3, 0], [2, 2, 2, 2]], np.int32)],
         dict(axis=(1,), keepdims=True)),
    # -- shape and index ops ----------------------------------------------------
    case("squeeze_axis", "squeeze", [floats(1, 3, 1, 4)], dict(axis=(0,))),
    case("squeeze_all", "squeeze", [floats(1, 3, 1, 4)]),
    case("squeeze_negative_axis", "squeeze", [ints(2, 3, 1)], dict(axis=-1)),
    case("expand_dims", "expand_dims", [floats(2, 3)], dict(axis=1)),
    case("expand_dims_negative_two", "expand_dims", [ints(2, 3)], dict(axis=-1, num_newaxis=2)),
    case("tile", "tile", [floats(2, 3, 4)], dict(reps=(1, 2, 1))),
    case("tile_short_reps", "tile", [ints(2, 3)], dict(reps=(2,))),
    case("tile_long_reps", "tile", [floats(3, 1)], dict(reps=(2, 1, 3))),
    case("gather_axis0", "gather", [floats(4, 5), ints(2, 5, lo=0, hi=4, dtype=np.int64)],
         dict(axis=0)),
    case("gather_axis1_int32_index", "gather", [ints(3, 6), ints(3, 4, lo=0, hi=6, dtype=np.int32)],
         dict(axis=1)),
    case("gather_negative_indices", "gather",
         [floats(4, 5), np.array([[-1, 0, -4, 3, -2]], np.int64)], dict(axis=0)),
    case("gather_broadcasts_like_numpy", "gather",
         [floats(4, 5), np.array([[0], [3], [-1]], np.int64)], dict(axis=0), graph=False),
    case("one_hot_out_of_range", "one_hot", [np.array([0, 2, -1, 3], np.int32)],
         dict(depth=3, on_value=1.0, off_value=0.0, dtype="float32")),
    case("one_hot_axis0_int32", "one_hot", [ints(3, 4, lo=-1, hi=6, dtype=np.int64)],
         dict(depth=5, axis=0, on_value=7, off_value=-2, dtype="int32"), jax=False),
    # -- NHWC pools and moves ------------------------------------------------------
    case("global_max_pool", "nn.global_max_pool2d", [floats(2, 4, 4, 8)]),
    case("global_max_pool_int8_flat", "nn.global_max_pool2d", [ints(2, 5, 3, 4)],
         dict(keepdims=False)),
    case("depth_to_space_dcr", "nn.depth_to_space", [floats(2, 4, 4, 8)],
         dict(block_size=2, mode="DCR")),
    case("depth_to_space_crd", "nn.depth_to_space", [floats(1, 4, 6, 8)],
         dict(block_size=2, mode="CRD")),
    case("depth_to_space_int8_b3", "nn.depth_to_space", [ints(1, 2, 3, 18)],
         dict(block_size=3, mode="DCR")),
    case("space_to_depth", "nn.space_to_depth", [floats(1, 6, 6, 2)], dict(block_size=2)),
    case("space_to_depth_int8", "nn.space_to_depth", [ints(2, 4, 8, 3)], dict(block_size=4)),
    *(case(f"resize_nearest_{ctm}_{rm}", "image.resize2d", [RESIZE],
           dict(size=(7, 5), method="nearest_neighbor", coordinate_transformation_mode=ctm,
                rounding_method=rm))
      for ctm in ("asymmetric", "half_pixel", "align_corners")
      for rm in ("floor", "ceil", "round_prefer_floor", "round_prefer_ceil")),
    *(case(f"resize_upsample_{ctm}_{rm}", "image.resize2d", [RESIZE],
           dict(size=(8, 12), method="nearest_neighbor", coordinate_transformation_mode=ctm,
                rounding_method=rm))
      for ctm in ("asymmetric", "half_pixel")
      for rm in ("round_prefer_floor", "round_prefer_ceil")),
    case("resize_nearest_default_floor", "image.resize2d", [RESIZE],
         dict(size=(3, 9), method="nearest_neighbor")),
    case("resize_nearest_int8", "image.resize2d", [ints(1, 5, 7, 4)],
         dict(size=(10, 14), method="nearest_neighbor",
              coordinate_transformation_mode="half_pixel", rounding_method="round_prefer_floor")),
    *(case(f"resize_linear_{ctm}", "image.resize2d", [floats(2, 5, 7, 3)],
           dict(size=(11, 4), method="linear", coordinate_transformation_mode=ctm))
      for ctm in ("asymmetric", "half_pixel", "align_corners")),
    # -- ops/extra.py -----------------------------------------------------------------
    *(case(op, op, [floats(3, 8, scale=0.8)], tol=ELEM)
      for op in ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh")),
    case("isnan", "isnan", [SPECIAL]),
    case("isinf", "isinf", [SPECIAL]),
    case("isnan_int", "isnan", [ints(2, 3)]),
    case("logical_xor_bool", "logical_xor", [floats(4, 6) > 0, floats(4, 6, seed=1) > 0]),
    case("logical_xor_int_truthiness", "logical_xor", [ints(3, 4, lo=-2, hi=3), ints(1, 4, lo=0,
                                                                                hi=2)]),
    case("lrn_nhwc", "nn.lrn", [floats(1, 6, 6, 8, lo=0.0)],
         dict(size=5, axis=3, alpha=1e-4, beta=0.75, bias=2.0), tol=SUMS),
    case("lrn_nchw_size3", "nn.lrn", [floats(1, 6, 5, 5, scale=3)],
         dict(size=3, axis=1, alpha=1e-2, beta=0.75, bias=1.0), tol=SUMS),
    case("instance_norm_nhwc", "nn.instance_norm",
         [floats(2, 4, 4, 8), floats(8, seed=1), floats(8, seed=2)], dict(axis=-1, epsilon=1e-5),
         tol=SUMS),
    case("instance_norm_nchw", "nn.instance_norm",
         [floats(2, 3, 6, 6, scale=3), floats(3, seed=1, lo=0.5), floats(3, seed=2)],
         dict(axis=1, epsilon=1e-5), tol=SUMS),
    case("reverse", "reverse", [floats(2, 3)], dict(axis=1)),
    case("reverse_int8_axis0", "reverse", [ints(3, 2, 2)], dict(axis=0)),
    case("cumsum_int8_to_int32", "cumsum", [ints(2, 6, lo=-5, hi=5)], dict(axis=1)),
    case("cumsum_int32_wraps", "cumsum", [np.full((1, 4), 2 ** 30, np.int32)], dict(axis=1)),
    case("cumsum_float", "cumsum", [floats(3, 6)], dict(axis=0), tol=SUMS),
    case("topk_both", "topk", [floats(3, 10)], dict(k=3, axis=-1, ret_type="both"), n_out=2),
    case("topk_ties_lowest_index_first", "topk", [TOPK_TIES],
         dict(k=5, axis=-1, ret_type="both", dtype="int64"), n_out=2),
    # the oracle's -a wraps at -128, which it sorts first; the port and
    # lax.top_k put 127 first
    case("topk_int8_min_wraps_first", "topk", [TOPK_INT8],
         dict(k=4, axis=-1, ret_type="both"), jax=JAX_IMPL, n_out=2),
    case("topk_axis0_values", "topk", [floats(6, 3)], dict(k=2, axis=0, ret_type="values")),
    case("topk_indices", "topk", [ints(2, 9)], dict(k=9, ret_type="indices", dtype="int64"),
         jax=JAX_IMPL),
    # -- ops/tail.py ----------------------------------------------------------------
    case("einsum_int8_matmul", "einsum", [ints(3, 4, lo=-10, hi=10), ints(4, 5, seed=1, lo=-10,
                                                                        hi=10)],
         dict(equation="ij,jk->ik"), graph=False),
    case("einsum_int8_batched", "einsum", [ints(2, 3, 4), ints(2, 4, 5, seed=1)],
         dict(equation="bij,bjk->bik"), graph=False),
    case("einsum_int32_implicit", "einsum", [ints(3, 4, dtype=np.int32), ints(4, 2, seed=1,
                                                                         dtype=np.int32)],
         dict(equation="ij,jk")),
    case("einsum_int_diagonal", "einsum", [ints(4, 4, dtype=np.int32)], dict(equation="ii->i")),
    case("einsum_int_three_operands", "einsum",
         [ints(2, 3), ints(3, 4, seed=1), ints(4, 2, seed=2)],
         dict(equation="ij,jk,kl->il"), graph=False),
    case("einsum_int_ellipsis", "einsum", [ints(2, 2, 3, 4), ints(4, 5, seed=1)],
         dict(equation="...ij,jk->...ik"), graph=False),
    case("einsum_float", "einsum", [floats(3, 4), floats(4, 5, seed=1)], dict(equation="ij,jk->ik"),
         tol=SUMS),
    case("einsum_float_outer_transpose", "einsum", [floats(3), floats(4, seed=1)],
         dict(equation="i,j->ji"), tol=SUMS),
    case("gather_nd", "gather_nd", [floats(4, 5, 6), np.stack([ints(7, lo=0, hi=4, dtype=np.int32),
                                                          ints(7, seed=1, lo=0, hi=5,
                                                             dtype=np.int32)], -1)]),
    case("gather_nd_k1", "gather_nd", [ints(4, 3), np.array([[2], [0], [3]], np.int64)]),
    case("gather_nd_negative", "gather_nd",
         [floats(4, 5), np.array([[-1, -2], [0, -5]], np.int64)]),
    case("scatter_elements_update", "scatter_elements",
         [ints(4, 6, lo=-50, hi=50, dtype=np.int32), ints(2, 6, lo=0, hi=4, dtype=np.int32),
          ints(2, 6, seed=1, lo=-50, hi=50, dtype=np.int32)], dict(axis=0)),
    case("scatter_elements_update_twice_last_wins", "scatter_elements",
         [floats(3, 4), np.array([[1, 1, 0, 2], [1, 1, 0, 2], [1, 0, 0, 2]], np.int64),
          floats(3, 4, seed=1)], dict(axis=0)),
    case("scatter_elements_add", "scatter_elements",
         [ints(4, 6, lo=-50, hi=50, dtype=np.int32), ints(3, 6, lo=0, hi=4, dtype=np.int32),
          ints(3, 6, seed=1, lo=-50, hi=50, dtype=np.int32)], dict(axis=0, reduction="add")),
    case("scatter_elements_add_float_axis1", "scatter_elements",
         [floats(3, 5), ints(3, 4, lo=0, hi=5, dtype=np.int64), floats(3, 4, seed=1)],
         dict(axis=1, reduction="add"), tol=ELEM),
    case("scatter_elements_negative_wraps_twice", "scatter_elements",
         [floats(3, 4), np.array([[-1, -4, -5, 0]], np.int64), floats(1, 4, seed=1)],
         dict(axis=1), jax=False),
    case("scatter_nd_add", "scatter_nd",
         [ints(4, 6, lo=-50, hi=50, dtype=np.int32), ints(3, 1, lo=0, hi=4, dtype=np.int32),
          ints(3, 6, seed=1, lo=-50, hi=50, dtype=np.int32)], dict(mode="add")),
    case("scatter_nd_update_twice_last_wins", "scatter_nd",
         [floats(4, 5), np.array([[0, 1], [2, 3], [0, 1]], np.int64),
          np.array([9.0, 8.0, 7.0], np.float32)]),
    case("scatter_nd_negative_rows", "scatter_nd",
         [ints(4, 3), np.array([[-1], [1]], np.int64), ints(2, 3, seed=1)]),
    case("scatter_nd_reduction_attr_is_not_read", "scatter_nd",
         [ints(4, 3), np.array([[1], [1]], np.int64), ints(2, 3, seed=1)], dict(reduction="add")),
    case("trilu_lower", "trilu", [floats(2, 2)], dict(upper=False, k=0)),
    case("trilu_upper_k1", "trilu", [floats(4, 5)], dict(upper=True, k=1)),
    case("trilu_batched_lower_k_minus1", "trilu", [ints(2, 4, 4)], dict(upper=False, k=-1)),
    # -- ops/tail3.py -------------------------------------------------------------------
    case("trunc_mod_int_mixed_signs", "trunc_mod", [ints(3, 17, lo=-50, hi=50, dtype=np.int32),
                                                    signed_divisors((3, 17), 3)]),
    case("trunc_mod_int_zero_divisor", "trunc_mod", [np.array([5, -5, 3], np.int32),
                                                     np.array([0, 0, -2], np.int32)], jax=False),
    case("trunc_mod_int8_min", "trunc_mod", [np.array([-128, -128, 127], np.int8),
                                             np.array([-1, 3, -3], np.int8)]),
    case("trunc_mod_float", "trunc_mod", [floats(4, 9, scale=10), floats(4, 9, seed=1) + 3.5]),
]
