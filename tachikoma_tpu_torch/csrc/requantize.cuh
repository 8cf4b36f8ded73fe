// Exact fixed-point requantize epilogue shared by the port's int8 kernels.
//
// Replaces the epilogue of tachikoma_tpu/ops/pallas/qms32.py
// (fused_requantize), which every TPU int8 kernel ends with.  The TPU has no
// fast 64-bit integers, so that file emulates the int64 product with 32-bit
// high words; Hopper has them, so this is the int64 arithmetic of
// tachikoma_tpu/ops/fixed_point.py q_multiply_shift_np, written out:
//   * the left shift max(s, 0) comes before the multiply;
//   * the rounding addend is 2^(30 - min(s, 0)) (TONEAREST: minus 1 when the
//     product is negative);
//   * the result is an arithmetic shift right by 31 + max(-s, 0).
// The int64 (and int32) arithmetic wraps around, as the oracle's does; it is
// computed in unsigned types because signed overflow is undefined in C++.
#pragma once

#include <cstdint>

namespace tk {

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t q_multiply_shift(int32_t x, int32_t m, int32_t s,
                                                    bool tonearest) {
  const int left = s > 0 ? s : 0;
  const int total_right = 31 + (s < 0 ? -s : 0);
  uint64_t v = (uint64_t)(int64_t)x << left;
  v *= (uint64_t)(int64_t)m;
  uint64_t round = (uint64_t)1 << (total_right - 1);
  if (tonearest && (int64_t)v < 0) round -= 1;
  v += round;
  return (int32_t)(uint32_t)(uint64_t)((int64_t)v >> total_right);
}

// Per output channel c:
//   clip(q_multiply_shift(acc + bias[c] - rq_izp, m[c], s[c]) + out_zp, qmin, qmax)
struct Requant {
  const int32_t* bias;
  const int32_t* mult;
  const int32_t* shift;
  int32_t rq_izp, out_zp, qmin, qmax;
  bool tonearest;
};

__device__ __forceinline__ int32_t requantize_channel(int32_t acc, int c, const Requant& p) {
  int32_t v = wrap_sub(wrap_add(acc, p.bias[c]), p.rq_izp);
  v = q_multiply_shift(v, p.mult[c], p.shift[c], p.tonearest);
  v = wrap_add(v, p.out_zp);
  return min(max(v, p.qmin), p.qmax);
}

}  // namespace tk
