// Int8 GEMM kernel with the exact requantize epilogue: the first port's body
// of K1, now the body of K4's GEMM mode (qgemm_raw.cu) alone; K1
// (qgemm_rq.cu) and the convs (K2, K3 and K4's conv mode) have Hopper
// designs of their own (igemm_hopper.cuh); K7 (qconv_layouts_hopper.cu) and
// K11's narrow path (qconv_direct.cu) take this file's mma.sync pieces.  Its
// requantize epilogue and its tiles other than 64 x 64 were K1's; a `git
// archive` of an earlier tree builds them (tools/gemm_probe.py --csrc).
//
// out[m, n] = epilogue(sum_k A[m, k] * B[k, n]) with int8 operands and an
// int32 accumulator on the tensor cores (mma.sync m16n8k32 s8.s8.s32).
//   * A is x (M, K) row-major.
//   * B is w (K, N) row-major.  The loader transposes 4x4 byte blocks so
//     that shared memory holds B as [n][k], the layout the mma takes.
//   * RAW = true (K4's GEMM mode): no requantize; the epilogue stores
//     acc + bias[n] as int32 (wraparound) to an int32 output.
//
// Design, simple and right first: BM x BN x 64 block tiles, one warp per
// 32 x 32 output tile (four warps at 64 x 64, sixteen at 128 x 128), one
// shared-memory stage with the next tile prefetched into registers.  The
// tile is a template parameter: K1 is built at BM, BN in {64, 128} x
// {64, 128} (the tuner's config space, `blocks`), and takes it from the
// parameter array (P_BM, P_BN; 0 means 64); K4 is built at 64 x 64 only.
// Rows of shared memory are padded to 80 bytes, so fragment loads hit 32
// distinct banks.  Edges in M, N and K are masked, so any shape runs;
// 16-byte loads of A need K % 16 == 0 and 4-byte loads of B need N % 4 == 0,
// else the loaders fall back to bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "params.cuh"
#include "requantize.cuh"

namespace tk {

constexpr int BK = 64;
constexpr int SROW = BK + 16;  // shared-memory row stride in bytes

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

struct Geo {
  int M, K, cout;
  bool a_vec, b_vec;
};

// One row of A as a thread sees it.
struct ARow {
  long long base;
  bool valid;
};

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of A: row r, k .. k + 15.
__device__ __forceinline__ uint4 a_chunk(const int8_t* __restrict__ x, const ARow& r, int k,
                                         const Geo& g) {
  if (!r.valid || k >= g.K) return make_uint4(0, 0, 0, 0);
  if (g.a_vec) return *reinterpret_cast<const uint4*>(x + r.base + k);
  uint32_t v[4] = {0, 0, 0, 0};
  for (int b = 0; b < 16 && k + b < g.K; ++b)
    v[b >> 2] |= (uint32_t)(uint8_t)x[r.base + k + b] << ((b & 3) * 8);
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// 4 bytes of B: row k, columns n .. n + 3 (zero outside).
__device__ __forceinline__ uint32_t b_word(const int8_t* __restrict__ w, int k, int n,
                                           const Geo& g) {
  if (k >= g.K || n >= g.cout) return 0;
  const int8_t* p = w + (long long)k * g.cout + n;
  if (g.b_vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int j = 0; j < 4 && n + j < g.cout; ++j) v |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return v;
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

// `out` is int8 (M, N), or int32 (M, N) when RAW.
template <bool RAW, int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NTHREADS)
    qgemm_rq_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    void* __restrict__ out, Requant rq, Geo g) {
  using T = Tile<BM, BN>;
  constexpr int NT = T::NTHREADS, A_PER = T::A_PER, B_PER = T::B_PER, NG = BN / 4;
  __shared__ __align__(16) int8_t As[BM * SROW];
  __shared__ __align__(16) int8_t Bs[BN * SROW];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A loads: element e = tid + NT j is 16-byte chunk e & 3 of row e >> 2
  // (at 64 x 64: chunk tid & 3 of rows tid >> 2 and tid >> 2 + 32).
  const int a_c = tid & 3;
  ARow rows[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int m = m0 + ((tid + NT * j) >> 2);
    rows[j].valid = m < g.M;
    rows[j].base = (long long)m * g.K;
  }
  // B loads: element e = tid + NT j is the 4 x 4 block of k group
  // (e & 7) + 8 ((e >> 3) / NG) and n group (e >> 3) % NG (at 64 x 64: k
  // groups tid & 7 and tid & 7 + 8, n group tid >> 3).
  int b_kq[B_PER], b_nq[B_PER];
#pragma unroll
  for (int j = 0; j < B_PER; ++j) {
    const int e = tid + NT * j;
    b_kq[j] = (e & 7) + 8 * ((e >> 3) / NG);
    b_nq[j] = (e >> 3) % NG;
  }

  uint4 a_reg[A_PER];
  uint32_t b_reg[B_PER][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) a_reg[j] = a_chunk(x, rows[j], k0 + a_c * 16, g);
#pragma unroll
    for (int j = 0; j < B_PER; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        b_reg[j][r] = b_word(w, k0 + b_kq[j] * 4 + r, n0 + b_nq[j] * 4, g);
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < A_PER; ++j)
      *reinterpret_cast<uint4*>(As + ((tid + NT * j) >> 2) * SROW + a_c * 16) = a_reg[j];
#pragma unroll
    for (int j = 0; j < B_PER; ++j)
      store_transposed(Bs + (b_nq[j] * 4) * SROW + b_kq[j] * 4, SROW, b_reg[j]);
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp % T::WARPS_M) * 32, wn = (warp / T::WARPS_M) * 32;
  int32_t acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int nk = (g.K + BK - 1) / BK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = As + (wm + mt * 16 + gid) * SROW + ks + tig * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* q = Bs + (wn + nt * 8 + gid) * SROW + ks + tig * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // Epilogue: accumulator (gid + 8 (i >> 1), 2 tig + (i & 1)) of each tile.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mt * 16 + gid + (i >> 1) * 8;
        const int col = n0 + wn + nt * 8 + tig * 2 + (i & 1);
        if (row < g.M && col < g.cout) {
          const long long o = (long long)row * g.cout + col;
          if constexpr (RAW) {
            static_cast<int32_t*>(out)[o] = wrap_add(acc[mt][nt][i], rq.bias[col]);
          } else {
            static_cast<int8_t*>(out)[o] = (int8_t)requantize_channel(acc[mt][nt][i], col, rq);
          }
        }
      }
}

// (M, K) = (P_N, P_CIN) and N = P_COUT: the wrappers pass a GEMM as a 1x1
// conv of 1 x 1 images.
inline Geo make_geo(const int32_t* p) {
  Geo g;
  g.M = p[P_N] * p[P_OH] * p[P_OW];
  g.K = p[P_KH] * p[P_KW] * p[P_CIN];
  g.cout = p[P_COUT];
  g.a_vec = p[P_A_VEC] != 0;
  g.b_vec = p[P_B_VEC] != 0;
  return g;
}

template <bool RAW, int BM, int BN>
void launch_tile(const int8_t* x, const int8_t* w, void* out, const Requant& rq, const Geo& g,
                 cudaStream_t stream) {
  const dim3 grid((g.M + BM - 1) / BM, (g.cout + BN - 1) / BN);
  qgemm_rq_kernel<RAW, BM, BN><<<grid, Tile<BM, BN>::NTHREADS, 0, stream>>>(x, w, out, rq, g);
}

// Launches the kernel on `stream` at the tile (P_BM, P_BN) and returns
// cudaGetLastError() (cudaErrorInvalidValue for a tile that is not built).
// With RAW, `mult` and `shift` are not read.
template <bool RAW = false>
int launch_qgemm_rq(const int8_t* x, const int8_t* w, void* out, const int32_t* bias,
                    const int32_t* mult, const int32_t* shift, const int32_t* p, void* stream) {
  const Geo g = make_geo(p);
  const Requant rq{bias, mult, shift, p[P_RQ_IZP], p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                   p[P_TONEAREST] != 0};
  const int bm = p[P_BM] ? p[P_BM] : 64, bn = p[P_BN] ? p[P_BN] : 64;
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.M <= 0 || g.cout <= 0) return (int)cudaGetLastError();
  if constexpr (RAW) {
    if (bm != 64 || bn != 64) return (int)cudaErrorInvalidValue;
    launch_tile<RAW, 64, 64>(x, w, out, rq, g, s);
  } else if (bm == 64 && bn == 64) {
    launch_tile<RAW, 64, 64>(x, w, out, rq, g, s);
  } else if (bm == 64 && bn == 128) {
    launch_tile<RAW, 64, 128>(x, w, out, rq, g, s);
  } else if (bm == 128 && bn == 64) {
    launch_tile<RAW, 128, 64>(x, w, out, rq, g, s);
  } else if (bm == 128 && bn == 128) {
    launch_tile<RAW, 128, 128>(x, w, out, rq, g, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace tk
