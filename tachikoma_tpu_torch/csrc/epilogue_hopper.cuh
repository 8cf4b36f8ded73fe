// The requantize epilogue that the Hopper conv kernels share: K2 qconv_rq and
// K3 qconv_rq_res (qconv_igemm_hopper.cu), K11 qconv_direct
// (qconv_direct.cu).  Each of them ends its main loop with int32 sums in
// wgmma's register fragment and stores int8 (or, K11, uint8) bytes.
//
//   * The per-column constants (bias - rq_izp, multiplier, left shift, right
//     shift 31 + max(-s, 0)) are read once per block into shared memory, 16
//     bytes a column (load_cols).
//   * requant_wide is requantize.cuh's q_multiply_shift with the product as
//     one mul.wide.s32 and then the left shift: (x 2^l) m == (x m) 2^l mod
//     2^64, so it equals the oracle in its own wraparound arithmetic.
//   * The fragment is requantized into a staged tile in shared memory, two
//     neighbouring columns a 16-bit store (stage_fragment; K3 passes its
//     residual add as `fin`), and the tile leaves in 16-byte rows
//     (store_tile16) where COUT % 16 == 0 and the output is aligned.
#pragma once

#include <cstdint>

#include "requantize.cuh"

namespace tk {
namespace epi {

// The call's requantize constants that are the same for every column.
struct RqConst {
  int32_t out_zp, qmin, qmax;
  bool tonearest;
};

// colc[c] = the constants of column n0 + c, c < bn (zeros past COUT); every
// thread of the block takes part.
__device__ __forceinline__ void load_cols(int4* colc, int bn, int n0, int cout,
                                          const int32_t* __restrict__ bias,
                                          const int32_t* __restrict__ mult,
                                          const int32_t* __restrict__ shift, int32_t rq_izp) {
  for (int c = threadIdx.x; c < bn; c += blockDim.x) {
    const int col = n0 + c;
    int4 cc = make_int4(0, 0, 0, 31);
    if (col < cout) {
      const int s = shift[col];
      cc = make_int4(wrap_sub(bias[col], rq_izp), mult[col], s > 0 ? s : 0, 31 + (s < 0 ? -s : 0));
    }
    colc[c] = cc;
  }
}

// The requantize of one accumulator with column constants c.
__device__ __forceinline__ int32_t requant_wide(int32_t acc, int4 c, const RqConst& e) {
  const int32_t v = wrap_add(acc, c.x);
  const uint64_t p = (uint64_t)((int64_t)v * (int64_t)c.y) << c.z;
  uint64_t rnd = 1ull << (c.w - 1);
  if (e.tonearest && (int64_t)p < 0) rnd -= 1;
  const int32_t q = wrap_add((int32_t)(uint32_t)(uint64_t)((int64_t)(p + rnd) >> c.w), e.out_zp);
  return min(max(q, e.qmin), e.qmax);
}

// One warpgroup's fragment (acc[4 jb + e]: row rl0 + 8 (e >> 1) of the
// tile, column 8 jb + 2 (lane % 4) + (e & 1)) requantized into the staged
// tile (row stride rs bytes): each pair of columns becomes
// fin(q0, q1, the 16 bits the tile held there), K2's and K11's fin packing
// the pair's low bytes, K3's applying the residual add.
template <int BN, class Fin>
__device__ __forceinline__ void stage_fragment(int8_t* tile, int rs, int rl0,
                                               const int32_t (&acc)[BN / 2], const int4* colc,
                                               const RqConst& e, Fin fin) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int cl = 8 * jb + 2 * (lane & 3);
    const int4 c0 = colc[cl], c1 = colc[cl + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint16_t* p = reinterpret_cast<uint16_t*>(tile + (rl0 + 8 * h) * rs + cl);
      const int32_t q0 = requant_wide(acc[4 * jb + 2 * h], c0, e);
      const int32_t q1 = requant_wide(acc[4 * jb + 2 * h + 1], c1, e);
      *p = fin(q0, q1, *p);
    }
  }
}

// K2's and K11's fin: the pair's low bytes.
struct PackPair {
  __device__ __forceinline__ uint16_t operator()(int32_t q0, int32_t q1, uint16_t) const {
    return (uint16_t)((q0 & 255) | (q1 & 255) << 8);
  }
};

// The staged tile's rows r < rows, columns [0, cols) (cols a multiple of
// 16), stored 16 bytes a thread to out + dst(r) (a byte offset; negative
// skips the row).  Every thread of the block takes part.
template <class Dst>
__device__ __forceinline__ void store_tile16(int8_t* __restrict__ out, const int8_t* tile, int rs,
                                             int rows, int cols, Dst dst) {
  const int per = cols >> 4;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, c = 16 * (i - r * per);
    const long long o = dst(r);
    if (o >= 0)
      *reinterpret_cast<uint4*>(out + o + c) = *reinterpret_cast<const uint4*>(tile + r * rs + c);
  }
}

}  // namespace epi
}  // namespace tk
