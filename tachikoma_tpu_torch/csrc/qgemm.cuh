// The int8 mma.sync pieces that several kernels share: the 32 x 32-per-warp
// tile geometry of K7 (qconv_layouts_hopper.cu), the m16n8k32 product of the
// skinny path of K1 and K4's GEMM mode (qgemm_rq.cu), of K7 and of K11's
// narrow path (qconv_direct.cu), and K11's 4x4 byte transpose.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "params.cuh"
#include "requantize.cuh"

namespace tk {

constexpr int BK = 64;

// A BM x BN block tile: one warp per 32 x 32 output tile, warps laid out
// (BM / 32) along M by (BN / 32) along N.
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = BM / 32;
  static constexpr int NTHREADS = 32 * (BM / 32) * (BN / 32);
  static constexpr int A_PER = BM * (BK / 16) / NTHREADS;       // 16-byte A chunks a thread
  static constexpr int B_PER = (BK / 4) * (BN / 4) / NTHREADS;  // 4 x 4 B blocks a thread
  static_assert(A_PER >= 1 && B_PER >= 1, "tile too small for its threads");
};

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: word r holds k + r for columns n .. n + 3; the four
// words stored from `dst` with stride `stride` give column n + c k .. k + 3.
__device__ __forceinline__ void store_transposed(int8_t* dst, int stride, const uint32_t (&v)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
  *reinterpret_cast<uint32_t*>(dst + stride) = __byte_perm(t0, t1, 0x7632);
  *reinterpret_cast<uint32_t*>(dst + 2 * stride) = __byte_perm(t2, t3, 0x5410);
  *reinterpret_cast<uint32_t*>(dst + 3 * stride) = __byte_perm(t2, t3, 0x7632);
}

}  // namespace tk
