// qbmm_wide: W8A16's qnn.batch_matmul, int16 x int16 into an int64
// accumulator,
//
//   out[z, m, n] = sum_k (a[z, m, k] - za) * (b[z, k, n] - zb),
//
// on Hopper's wgmma.  The JAX package runs it on XLA (tachikoma_tpu/ops/
// jax_ops.py _qbmm_jax); no Pallas kernel is replaced.  Each call is a batch
// of products (the attention's scores q . k^T and its context softmax . v),
// the batch two merged axes of the grid, each operand read in place through
// its element strides: q and k head-split views (k contiguous in K), the
// softmax output contiguous (ViT's 197-element rows: 394 bytes, not 16-byte
// aligned), v a view with N contiguous.
//
// The arithmetic.  The tensor cores take 8-bit operands.  Each int16 operand
// is 256 hi + lo, hi = x >> 8 signed and lo = x & 255 unsigned, so
//
//   sum a b = 65536 sum ha hb + 256 sum (ha lb + la hb) + sum la lb,
//
// four wgmma products of one staged tile pair: .s8.s8 into the hi sum,
// .s8.u8 and .u8.s8 into one middle sum, .u8.u8 into the lo sum, all int32.
// Each middle term is at most 2 * 128 * 255 = 65,280 a k, so every sum is
// exact in int32 for K <= 32,896 (K_BOUND, ops/kernels/wide.py
// BMM_K_BOUND); the launch refuses deeper K.  The epilogue combines the three
// in int64.  A zero point other than 0 (W8A16 graphs carry 0) is folded in
// int64 as K1's batched mode folds it (qbmm_hopper.cu): - za colsum(B) - zb
// rowsum(A) + K za zb, the sums of the operands' staged values made in
// int32 (|sum| <= 32,768 K: exact at K_BOUND) by shared-memory atomics as
// the tiles are staged.
//
// The design (a simple kernel, first):
//
//   * one block of one warpgroup per (product, 64-row tile, 64-column tile);
//     K in steps of 64; the products' three int32 accumulators take 96
//     registers a thread;
//   * staging in registers: a thread loads eight units of (row, 4 k) of
//     each operand, one step ahead of the products (the loads of step s + 1
//     fly under step s's barrier and wgmmas), splits each unit's four int16
//     values with __byte_perm into four hi and four lo bytes and writes one
//     4-byte shared store a plane into the step's slot in wgmma's no-swizzle
//     K-major layout (two slots: a slot is written again only after every
//     wgmma on it is done);
//   * the operands' layouts: k contiguous and every unit 8-byte aligned (q,
//     k) is one 8-byte load a unit, a warp on two rows; k contiguous
//     otherwise (the softmax output at S 197) four element loads, the same
//     walk; rows contiguous (v) four element loads, a warp on 32 rows, so
//     each load of a warp reads 64 contiguous bytes;
//   * the epilogue stores straight from the fragments, 16 bytes (two
//     int64 columns) a store where N is even.
//
// What bounds it on an H100: bytes, the int64 output most of them (a
// BERT-base b4 scores call writes 48 x 128 x 128 values, 6.3 MB, against
// 1.6 MB of int16 operands).
#include "layouts_hopper.cuh"

namespace tk {
namespace bmmw {

using hop::fence_proxy_async;
using hop::gmma_desc;
using hop::wgmma_commit;
using hop::wgmma_fence;
using hop::wgmma_wait0;

constexpr int BM = 64, BN = 64, NT = 128;  // a warpgroup a 64 x 64 tile
constexpr int KSTEP = 64;                  // k a step
constexpr int PLANE = BM * KSTEP;          // one plane of a step's tile: 4096 bytes
constexpr int UNITS = BM * KSTEP / 4 / NT;  // (row, 4 k) units a thread stages an operand: 8
constexpr int K_BOUND = 32896;  // (2^31 - 1) / (2 * 128 * 255): the deepest exact middle sum

// How an operand is staged (ops/kernels/wide.py BMM_WIDE_STAGES).
enum Stage { KMAJOR8 = 0, KMAJOR = 1, ROWS = 2 };

// One operand: element (r, k) of product z = z0 nb1 + z1 at p + z0 sb0 +
// z1 sb1 + r sr + k sk (A: r < M; B: r = n < N).
struct Opnd {
  const int16_t* p;
  long long sb0, sb1, sr, sk;
  int rows, mode;
};

struct Args {
  Opnd a, b;
  int64_t* out;  // (nb, M, N)
  int M, K, N, nb1, n_tiles, steps;
  int za, zb;
};

__device__ __forceinline__ int cm_off(int r, int seg) {  // igemm_hopper.cuh's layout
  return (r >> 3) * 512 + seg * 128 + (r & 7) * 16;
}

// Unit u of a step's tile: row r and k quad q (k 4 q .. 4 q + 3), walked
// along k (a warp on two rows) or, for ROWS, along the rows.
__device__ __forceinline__ void unit_at(int mode, int u, int& r, int& q) {
  if (mode == ROWS) {
    q = u >> 6;
    r = u & 63;
  } else {
    r = u >> 4;
    q = u & 15;
  }
}

// The unit (row r0 + r, k k0 + 4 q ..) of operand o at base: two words of
// two int16 each (element k in the low half of word 0), zero past K or past
// the rows.
__device__ __forceinline__ uint2 load_unit(const Opnd& o, const int16_t* base, int r0, int k0,
                                           int r, int q, int K) {
  const int row = r0 + r, k = k0 + 4 * q;
  if (row >= o.rows || k >= K) return make_uint2(0u, 0u);
  const int16_t* src = base + row * o.sr + k * o.sk;
  if (o.mode == KMAJOR8 && k + 3 < K) return __ldg(reinterpret_cast<const uint2*>(src));
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = k + i < K ? (uint16_t)__ldg(src + i * o.sk) : 0u;
  return make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
}

// The sum of a unit's four int16 values.
__device__ __forceinline__ int32_t unit_sum(uint2 v) {
  return (int32_t)(int16_t)(v.x & 0xffffu) + (int32_t)(int16_t)(v.x >> 16) +
         (int32_t)(int16_t)(v.y & 0xffffu) + (int32_t)(int16_t)(v.y >> 16);
}

#define TK_WGMMA64(TA, TB)                                                                     \
  asm volatile(                                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." TA "." TB " "                              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                                     \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"                             \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),   \
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),             \
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),          \
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),          \
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),          \
        "+r"(d[31])                                                                            \
      : "l"(da), "l"(db), "r"(1))

// d (64 x 64, int32) += A (64 x 32 bytes) . B (64 x 32 bytes)^T, both
// K-major in shared memory by descriptor; UA / UB: that operand's bytes read
// unsigned (its lo plane).
template <bool UA, bool UB>
__device__ __forceinline__ void wgmma64(int32_t (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (!UA && !UB)
    TK_WGMMA64("s8", "s8");
  else if constexpr (!UA && UB)
    TK_WGMMA64("s8", "u8");
  else if constexpr (UA && !UB)
    TK_WGMMA64("u8", "s8");
  else
    TK_WGMMA64("u8", "u8");
}
#undef TK_WGMMA64

__global__ void __launch_bounds__(NT) qbmm_wide_hopper(Args g) {
  // two slots, each the step's A hi, A lo, B hi and B lo planes
  __shared__ __align__(128) int8_t tiles[2][4][PLANE];
  __shared__ int32_t row_sum[BM], col_sum[BN];  // A's rows, B's columns (zero points only)
  const int tid = threadIdx.x;
  const int z = blockIdx.y, z0 = z / g.nb1, z1 = z - z0 * g.nb1;
  const int mt = blockIdx.x / g.n_tiles, nt = blockIdx.x - mt * g.n_tiles;
  const int m0 = mt * BM, n0 = nt * BN;
  const int16_t* const pa = g.a.p + z0 * g.a.sb0 + z1 * g.a.sb1;
  const int16_t* const pb = g.b.p + z0 * g.b.sb0 + z1 * g.b.sb1;
  const bool rows_needed = g.zb != 0, cols_needed = g.za != 0;
  if (rows_needed || cols_needed) {
    for (int i = tid; i < BM; i += NT) row_sum[i] = col_sum[i] = 0;
    __syncthreads();
  }

  uint2 ra[UNITS], rb[UNITS];
  auto load = [&](int step) {
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      int r, q;
      unit_at(g.a.mode, tid + j * NT, r, q);
      ra[j] = load_unit(g.a, pa, m0, step * KSTEP, r, q, g.K);
      unit_at(g.b.mode, tid + j * NT, r, q);
      rb[j] = load_unit(g.b, pb, n0, step * KSTEP, r, q, g.K);
    }
  };
  // a unit's hi and lo bytes into planes hi and hi + PLANE of a slot
  auto put = [](int8_t* hi, int r, int q, uint2 v) {
    const int off = cm_off(r, q >> 2) + 4 * (q & 3);
    *reinterpret_cast<uint32_t*>(hi + off) = __byte_perm(v.x, v.y, 0x7531);
    *reinterpret_cast<uint32_t*>(hi + PLANE + off) = __byte_perm(v.x, v.y, 0x6420);
  };

  int32_t hh[32], mid[32], ll[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) hh[i] = mid[i] = ll[i] = 0;
  if (g.steps > 0) load(0);
  for (int s = 0; s < g.steps; ++s) {
    int8_t* const slot = tiles[s & 1][0];
#pragma unroll
    for (int j = 0; j < UNITS; ++j) {
      int r, q;
      unit_at(g.a.mode, tid + j * NT, r, q);
      put(slot, r, q, ra[j]);
      if (rows_needed) atomicAdd(&row_sum[r], unit_sum(ra[j]));
      unit_at(g.b.mode, tid + j * NT, r, q);
      put(slot + 2 * PLANE, r, q, rb[j]);
      if (cols_needed) atomicAdd(&col_sum[r], unit_sum(rb[j]));
    }
    if (s + 1 < g.steps) load(s + 1);  // in flight through the barrier and the products
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dah = gmma_desc(slot + kk * 256, 128, 512);
      const uint64_t dal = gmma_desc(slot + PLANE + kk * 256, 128, 512);
      const uint64_t dbh = gmma_desc(slot + 2 * PLANE + kk * 256, 128, 512);
      const uint64_t dbl = gmma_desc(slot + 3 * PLANE + kk * 256, 128, 512);
      wgmma64<false, false>(hh, dah, dbh);
      wgmma64<false, true>(mid, dah, dbl);
      wgmma64<true, false>(mid, dal, dbh);
      wgmma64<true, true>(ll, dal, dbl);
    }
    wgmma_commit();
    wgmma_wait0();
  }
  // every atomic of the sums came before the last step's barrier

  // fragment: d[4 jb + e] is row 16 warp + lane / 4 + 8 (e >> 1), column 8
  // jb + 2 (lane % 4) + (e & 1)
  const int warp = tid >> 5, lane = tid & 31;
  const int rl0 = 16 * warp + (lane >> 2);
  int64_t* const out = g.out + (long long)z * g.M * g.N;
  const long long kzz = (long long)g.K * g.za * g.zb;
  const bool vec = g.N % 2 == 0;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int cl = 8 * jb + 2 * (lane & 3), col = n0 + cl;
    if (col >= g.N) continue;
    const bool pair = col + 1 < g.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = rl0 + 8 * h, row = m0 + rl;
      if (row >= g.M) continue;
      const int i = 4 * jb + 2 * h;
      long long v0 = 65536LL * hh[i] + 256LL * mid[i] + ll[i];
      long long v1 = 65536LL * hh[i + 1] + 256LL * mid[i + 1] + ll[i + 1];
      if (rows_needed || cols_needed) {
        const long long zr = kzz - (long long)g.zb * row_sum[rl];
        v0 += zr - (long long)g.za * col_sum[cl];
        v1 += zr - (long long)g.za * col_sum[cl + 1];
      }
      int64_t* const p = out + (long long)row * g.N + col;
      if (pair && vec) {
        *reinterpret_cast<longlong2*>(p) = make_longlong2(v0, v1);
      } else {
        p[0] = v0;
        if (pair) p[1] = v1;
      }
    }
  }
}

}  // namespace bmmw
}  // namespace tk

// The batched product: a and b int16 read through the strides of the
// parameter array (params.cuh P_A_SB0 .. P_B_SK, in elements; P_BMM_NB
// products, P_BMM_NB1 of them along the inner batch axis), M = P_N, K =
// P_CIN, N = P_COUT, zero points P_BMM_ZA / P_BMM_ZB, staging modes P_A_MODE
// / P_B_MODE; out int64 (nb, M, N) contiguous.  Returns cudaGetLastError();
// cudaErrorInvalidValue for K above K_BOUND, a zero point outside int16, a
// mode it does not take or an 8-byte mode on an operand that is not 8-byte
// aligned with k contiguous, or more than 65535 products.
extern "C" int tk_qbmm_wide(const int16_t* a, const int16_t* b, int64_t* out, const int32_t* p,
                            void* stream) {
  using namespace tk;
  using namespace tk::bmmw;
  Args g;
  g.M = p[P_N];
  g.K = p[P_CIN];
  g.N = p[P_COUT];
  const int nb = p[P_BMM_NB];
  g.nb1 = p[P_BMM_NB1] > 0 ? p[P_BMM_NB1] : 1;
  g.za = p[P_BMM_ZA];
  g.zb = p[P_BMM_ZB];
  g.a = Opnd{a, p[P_A_SB0], p[P_A_SB1], p[P_A_SM], p[P_A_SK], g.M, p[P_A_MODE]};
  g.b = Opnd{b, p[P_B_SB0], p[P_B_SB1], p[P_B_SN], p[P_B_SK], g.N, p[P_B_MODE]};
  g.out = out;
  if (g.M < 0 || g.N < 0 || g.K < 0 || g.K > K_BOUND || nb < 0 || nb > 65535 ||
      nb % g.nb1 != 0 || g.za < -32768 || g.za > 32767 || g.zb < -32768 || g.zb > 32767)
    return (int)cudaErrorInvalidValue;
  for (const Opnd* o : {&g.a, &g.b}) {
    if (o->mode < KMAJOR8 || o->mode > ROWS) return (int)cudaErrorInvalidValue;
    if (o->mode == KMAJOR8 && (o->sk != 1 || (uintptr_t)o->p % 8 != 0 || o->sr % 4 != 0 ||
                               o->sb0 % 4 != 0 || o->sb1 % 4 != 0))
      return (int)cudaErrorInvalidValue;
  }
  if (g.M == 0 || g.N == 0 || nb == 0) return (int)cudaGetLastError();
  g.steps = (g.K + KSTEP - 1) / KSTEP;
  g.n_tiles = (g.N + BN - 1) / BN;
  const long long tiles = (long long)((g.M + BM - 1) / BM) * g.n_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)nb);
  qbmm_wide_hopper<<<grid, NT, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
