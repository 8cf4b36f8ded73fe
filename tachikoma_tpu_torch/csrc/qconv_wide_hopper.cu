// qgemm_wide and qconv_wide: the W8A16 products, qnn.dense and qnn.conv2d of
// int16 data and int8 weights into an int64 accumulator,
//
//   out[m, n] = sum_k (x[m, k] - izp) * w[k, n]     (the border padded by izp)
//
// on Hopper's wgmma.  The JAX package runs both on XLA with an int64
// accumulator (tachikoma_tpu/ops/jax_ops.py _qconv2d_jax and _qdense_jax); no
// Pallas kernel is replaced.  tk_qgemm_wide takes a GEMM (a dense layer, or a
// 1x1 stride-1 unpadded conv as the (N*H*W, CIN) matrix it is);
// tk_qconv_wide any kernel size, stride, padding and dilation, as an
// implicit GEMM over the caller's NHWC image (a 1x1 stride-2 conv too: no
// subsampled copy), and a grouped conv as K2 and K4's conv mode run it: a
// super-group of groups as one dense conv on block-diagonal weights (the
// wrapper packs them once, ops/kernels/conv.py grouped_weights), each N tile
// reading the contiguous run of its super-group's P_CSPAN input channels.
// Tap (ky, kx) reads input row oy sh - pt + ky dh (igemm_hopper.cuh's
// dilation).  Both launch one kernel, qwide_hopper.
//
// The arithmetic.  The tensor cores take 8-bit operands.  An int16 x is 256
// hi + lo with hi = x >> 8 signed and lo = x & 255 unsigned, so
//
//   sum x w = 256 sum hi w + sum lo w,
//
// two int32 sums of one staged weight tile: wgmma .s32.s8.s8 on the hi plane
// and .s32.u8.s8 on the lo plane, no shift and no zero point of their own.
// Taps outside the image read izp itself (both of its bytes), so every term
// is x w and the epilogue takes izp colsum[n] off once: colsum is the
// weight's int64 column sum over all of K, made once per weight tensor by the
// wrapper (ops/kernels/wide.py), and a padded cell adds izp w - izp w = 0, as
// the oracle's int64 pad does, at any dilation (in a grouped conv the column
// sum is the group's own; the block-diagonal zeros add nothing).  |hi w| <=
// 2^14 and |lo w| <= 255 * 128, so
// both sums are exact in int32 for K <= 65,793 (K_BOUND; the launch refuses
// deeper K), and the int64 combine 256 acc_hi + acc_lo - izp colsum is exact.
//
// What bounds it on an H100: bytes, at every call of the W8A16 ResNet-50:
// 2 bytes an input element, 1 a weight and 8 an output element (0.2747 ms of
// HBM time for the b8 224^2 forward's 54 products), against 2 M K N int8
// products twice over.  The design, against the byte-plane route it
// replaces (two int8 products on K4 / K5 and seven torch passes a product,
// ops/kernels/wide.py before it):
//
//   * one pass: the weights are read once and the int64 output written once;
//     no plane, int16 temporary or int32 partial product reaches memory;
//   * K4's shape: persistent blocks over (M tile, N tile) items, each block
//     keeping one N tile; a 4-stage cp.async ring of the weight tiles of K
//     steps of 64 runs across the items; the weights packed K-major once
//     per tensor as (Kp / 64,
//     COUT, 64) (ops/kernels/matmul_int8.py kmajor_weights, K4's packing
//     and cache);
//     both planes and the weight tile in wgmma's no-swizzle core-matrix
//     layout (igemm_hopper.cuh cm_off), one warpgroup per 64 rows, the n64
//     sub-tiles of the N tile issued one by one (two int32 accumulators a
//     thread: BN 128 holds 128 registers of sums, BN 256 would not fit);
//   * the split in registers: each thread loads its segments of the int16 A
//     tile (16 elements of a row: two 16-byte ld.global) one step ahead of
//     the products, splits them with __byte_perm 0x6420 / 0x7531 on each
//     pair of words, and writes one 16-byte shared store a plane into the
//     step's plane slot (two slots, so a slot is written only after every
//     warpgroup's wgmma on it is done); only the weight tiles go through
//     the cp.async ring.  QW_SPLIT_SMEM 1 copies the raw tile into the ring
//     by cp.async instead and has each thread split the bytes it copied
//     from shared memory: 1.15x slower at the b8 forward (a stage three
//     times as large, one more pass through shared memory; PERF.md).  A row
//     whose CIN is not a multiple of 8 (the CIN-3 stem: 6-byte pixels; K = 70
//     of a dense) gathers its 16 elements one by one, walking its address
//     along each tap row;
//   * the epilogue: the 64-bit combine, izp colsum taken off by split 0, and
//     16-byte stores of two neighbouring columns straight from the fragment
//     (a warp's store is whole 32-byte sectors; QW_STORE_STAGED 1 stages the
//     int64 tile in shared memory first and stores whole rows: 1.13x slower
//     at the b8 forward);
//   * small grids (the b1 trace's 7^2 calls, M 49 and K 4608; the dense at M
//     1 and 8): the wrapper splits K over the grid's z dimension
//     (wide.py wide_plan) and the splits add into an output it zeroed with
//     64-bit integer atomics (red.global.add.u64): integer addition is
//     associative mod 2^64, so every run gives the same integers.
//
// What holds it above its bound (tools/wide_probe.py): the K step's chain of
// latencies.  A lone block spends about 1.2 us a step of 64 (the A loads
// 0.7, the wgmmas 0.3, the split, fence and barrier 0.3), so the 3x3 calls
// at 14^2 and 7^2 (K 2304-4608) and the deep 1x1 GEMMs take 10-30x their
// bound; at the b8 forward the loads are 43% of the time, the int64 stores
// 30%, the wgmmas 13% (each cut out in turn).
#include "igemm_hopper.cuh"

// The parts that tools/wide_probe.py cuts out, one at a time (each is 1 in
// the kernel as it runs).
#define QW_LOADS 1     // 0: no operand copied (the stages hold what shared memory held)
#define QW_MMA 1       // 0: no wgmma
#define QW_EPILOGUE 1  // 0: nothing stored
#define QW_BODY 1      // 0: every block returns as it starts
// The designs that tools/wide_probe.py holds this one against (each gives
// the same integers).
#define QW_SPLIT_SMEM 0    // 1: the int16 tile copied into the ring and split from shared memory
#define QW_STORE_STAGED 0  // 1: the int64 tile staged in shared memory, leaving in whole rows

namespace tk {
namespace wide {

using hop::cp_async16;
using hop::cp_async_commit;
using hop::cp_async_wait_upto;
using hop::fence_proxy_async;
using hop::gmma_desc;
using hop::wgmma_commit;
using hop::wgmma_fence;
using hop::wgmma_wait0;
using igemm::cm_off;
using igemm::KSTEP;

constexpr int STAGES = 4;   // the cp.async ring
constexpr int PSLOTS = 2;   // plane slots: one is written while the other's wgmmas finish
constexpr int OPAD = 16;    // bytes of padding a row of the staged output tile
constexpr int K_BOUND = 65793;  // (2^31 - 1) / (255 * 128): the deepest exact lo-plane sum

struct WGeo {
  int n, h, w, cin, kh, kw, cout, oh, ow, sh, sw, pt, pl;
  int dh, dw;   // the dilation
  // a grouped conv: the N tile of column n0 reads the cspan input channels
  // from (n0 / nspan) cspan on, K = KH KW cspan (dense: cspan CIN, nspan COUT)
  int cspan, nspan;
  int M, K, steps, kper;     // steps = Kp / 64; a split walks kper of them
  int m_tiles, n_tiles, gm;  // a block walks M tiles mb, mb + gm, ... of one N tile
  // dynamic shared memory: the ring (STAGES x stage_bytes: raw A, then the
  // weight tile), the two plane slots (hi, lo), izp * colsum of the N tile,
  // the staged output tile; smem bytes in all
  int stage_bytes, off_planes, off_cols, off_otile, smem;
  int32_t izp;
  uint32_t izp2;  // izp's 16 bits in both halves of a word
  bool a_vec;     // CIN % 8 == 0, cspan % 8 == 0, x 16-byte aligned: 16-byte copies of 8
  bool o_vec;     // COUT even and out 16-byte aligned: 16-byte stores of two columns
  hop::FastDiv by_ohow, by_ow;
};

template <int BM, int BN>
struct WTiles {
  static constexpr int NT = 2 * BM;         // a warpgroup per 64 rows
  static constexpr int A_PER = BM * 4 / NT;  // row segments (16 elements) a thread stages: 2
  static constexpr int B_PER = BN * 4 / NT;  // weight row segments a thread stages
  static constexpr int NJ = BN / 64;         // n64 sub-tiles
  static constexpr int PLANE = BM * KSTEP;   // one plane of a step: BM x 64 bytes
  static constexpr int RAW = QW_SPLIT_SMEM ? 2 * PLANE : 0;  // the raw int16 A tile of a stage
  static constexpr int OS = BN * 8 + OPAD;  // staged output row stride, bytes
};

template <int BM, int BN>
void smem_layout(WGeo& g) {
  using T = WTiles<BM, BN>;
  g.stage_bytes = T::RAW + BN * KSTEP;
  g.off_planes = STAGES * g.stage_bytes;
  g.off_cols = g.off_planes + PSLOTS * 2 * T::PLANE;
  g.off_otile = g.off_cols + BN * 8;
  g.smem = g.off_otile + (QW_STORE_STAGED ? BM * T::OS : 0);
}

#define TK_WGMMA64(TA)                                                                         \
  asm volatile(                                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." TA ".s8 "                                  \
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
// K-major in shared memory by descriptor; U: A's bytes read unsigned (the
// lo plane).
template <bool U>
__device__ __forceinline__ void wgmma64(int32_t (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (U)
    TK_WGMMA64("u8");
  else
    TK_WGMMA64("s8");
}
#undef TK_WGMMA64

// 16 int16 elements (a: 0-7, b: 8-15, two to a word, element 2i in the low
// half) into their high bytes (hi) and low bytes (lo), in element order.
__device__ __forceinline__ void split_planes(const uint4& a, const uint4& b, uint4& hi,
                                             uint4& lo) {
  lo = make_uint4(__byte_perm(a.x, a.y, 0x6420), __byte_perm(a.z, a.w, 0x6420),
                  __byte_perm(b.x, b.y, 0x6420), __byte_perm(b.z, b.w, 0x6420));
  hi = make_uint4(__byte_perm(a.x, a.y, 0x7531), __byte_perm(a.z, a.w, 0x7531),
                  __byte_perm(b.x, b.y, 0x7531), __byte_perm(b.z, b.w, 0x7531));
}

// The A rows a thread stages for one item and its segment's (ky, kx, ci) at
// the step it stages next.
template <int A_PER>
struct Rows {
  long long base[A_PER];
  int iy[A_PER], ix[A_PER];
  bool ok[A_PER];
  int ky, kx, ci;
};

// A block of the grid (x: N tile + n_tiles * mb, z: split of K) walks the M
// tiles mb, mb + gm, ... of its N tile, one item each, and the steps of its
// split in each; the copies run as one stream of stages over the items, up
// to STAGES - 1 ahead of the products.
template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM)
    qwide_hopper(const int16_t* __restrict__ x, const int8_t* __restrict__ wk,
                 int64_t* __restrict__ out, const int64_t* __restrict__ colsum, WGeo g) {
  using T = WTiles<BM, BN>;
  constexpr int NT = T::NT, A_PER = T::A_PER, B_PER = T::B_PER, NJ = T::NJ;
  extern __shared__ __align__(128) int8_t smem[];
#if !QW_BODY
  if (g.M >= 0) return;
#endif
  const int tid = threadIdx.x, seg = tid & 3;
  const int nt_idx = blockIdx.x % g.n_tiles;
  const int n0 = nt_idx * BN, mb = blockIdx.x / g.n_tiles;
  const int c0 = n0 / g.nspan * g.cspan;  // the first input channel the N tile reads
  const int n_items = mb < g.m_tiles ? (g.m_tiles - 1 - mb) / g.gm + 1 : 0;
  const int kbeg = blockIdx.z * g.kper;
  const int nst = min(g.steps, kbeg + g.kper) - kbeg;  // steps per item
  int ky0, kx0, ci0;  // this thread's segment at step kbeg
  {
    const int k = kbeg * KSTEP + seg * 16;
    const int tap = k / g.cspan;
    ci0 = k - tap * g.cspan;
    ky0 = tap / g.kw;
    kx0 = tap - ky0 * g.kw;
  }
  const uint4 fill = make_uint4(g.izp2, g.izp2, g.izp2, g.izp2);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  int64_t* const colz = reinterpret_cast<int64_t*>(smem + g.off_cols);

  auto begin = [&](Rows<A_PER>& a, int item) {
    const int m0 = (mb + item * g.gm) * BM;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int m = m0 + (tid >> 2) + j * (NT / 4);
      a.ok[j] = m < g.M;
      const int mm = a.ok[j] ? m : 0;
      const int img = g.by_ohow.div(mm), rem = mm - img * (g.oh * g.ow);
      const int oy = g.by_ow.div(rem), ox = rem - oy * g.ow;
      a.base[j] = (long long)img * g.h * g.w * g.cin + c0;
      a.iy[j] = oy * g.sh - g.pt;
      a.ix[j] = ox * g.sw - g.pl;
    }
    a.ky = ky0;
    a.kx = kx0;
    a.ci = ci0;
  };
  auto advance = [&](Rows<A_PER>& a) {  // the next step: 64 elements on
    a.ci += KSTEP;
    while (a.ci >= g.cspan && a.ky < g.kh) {
      a.ci -= g.cspan;
      if (++a.kx == g.kw) {
        a.kx = 0;
        ++a.ky;
      }
    }
  };
  // Where half h (elements 8h .. 8h + 7) of segment j of `a` starts: 1 and
  // `src` in the image, 2 outside it (izp), 0 past K or M (zeros: the weights
  // there are zero, the rows are not stored).  CIN % 8 == 0 and cspan % 8
  // == 0: a half lies in one tap.
  auto half_at = [&](const Rows<A_PER>& a, int j, int h, const int16_t*& src) -> int {
    int cy = a.ky, cx = a.kx, cc = a.ci + 8 * h;
    if (cc >= g.cspan) {
      cc -= g.cspan;
      if (++cx == g.kw) {
        cx = 0;
        ++cy;
      }
    }
    if (!a.ok[j] || cy >= g.kh) return 0;
    const int iy = a.iy[j] + cy * g.dh, ix = a.ix[j] + cx * g.dw;
    if ((unsigned)iy >= (unsigned)g.h || (unsigned)ix >= (unsigned)g.w) return 2;
    src = x + a.base[j] + ((long long)iy * g.w + ix) * g.cin + cc;
    return 1;
  };
  // Segment j of `a` into registers: 16-byte loads, or element by element
  // where CIN or cspan % 8 != 0.
  auto load_seg = [&](const Rows<A_PER>& a, int j, uint4 (&v)[2]) {
    if (g.a_vec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int16_t* src = x;
        const int at = half_at(a, j, h, src);
        v[h] = at == 1 ? *reinterpret_cast<const uint4*>(src) : at == 2 ? fill : zero;
      }
      return;
    }
    // Within one tap the elements (ci) are consecutive in memory, so the
    // address steps by one element and only a new tap (kx, or ky) is
    // bounds-tested and addressed anew (its pixel ix + kx dw, row iy + ky dh).
    uint32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (a.ok[j] && a.ky < g.kh) {
      int cy = a.ky, cx = a.kx, cc = a.ci;
      int iy = a.iy[j] + cy * g.dh, ix = a.ix[j] + cx * g.dw;
      bool row_in = (unsigned)iy < (unsigned)g.h, in = row_in && (unsigned)ix < (unsigned)g.w;
      const int16_t* src = x + a.base[j] + ((long long)iy * g.w + ix) * g.cin + cc;
#pragma unroll
      for (int b = 0; b < 16; ++b) {  // unrolled: e stays in registers
        const uint32_t val = in ? (uint16_t)*src : g.izp2 & 0xffffu;
        e[b >> 1] |= val << (16 * (b & 1));
        ++src;
        if (++cc == g.cspan) {
          cc = 0;
          if (++cx == g.kw) {  // the next tap row
            cx = 0;
            if (++cy >= g.kh) break;
            iy = a.iy[j] + cy * g.dh;
            row_in = (unsigned)iy < (unsigned)g.h;
          }
          ix = a.ix[j] + cx * g.dw;
          src = x + a.base[j] + ((long long)iy * g.w + ix) * g.cin;
          in = row_in && (unsigned)ix < (unsigned)g.w;
        }
      }
    }
    v[0] = make_uint4(e[0], e[1], e[2], e[3]);
    v[1] = make_uint4(e[4], e[5], e[6], e[7]);
  };

  // the producer: the item and step it stages next
  int p_item = 0, p_step = 0, issued = 0;
#if QW_SPLIT_SMEM
  Rows<A_PER> pa;
  // the raw tile of a stage: half h of row r's segment s at h * PLANE + 64 r
  // + 16 s (a warp's 16-byte accesses fall on distinct banks)
  auto stage_a = [&](int8_t* raw) {
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int off = ((tid >> 2) + j * (NT / 4)) * 64 + seg * 16;
      if (g.a_vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int16_t* src = x;
          const int at = half_at(pa, j, h, src);
          if (at == 2)
            *reinterpret_cast<uint4*>(raw + h * T::PLANE + off) = fill;
          else
            cp_async16(raw + h * T::PLANE + off, src, at == 1);
        }
      } else {
        uint4 v[2];
        load_seg(pa, j, v);
        *reinterpret_cast<uint4*>(raw + off) = v[0];
        *reinterpret_cast<uint4*>(raw + T::PLANE + off) = v[1];
      }
    }
  };
#endif
  auto stage_b = [&](int8_t* bs, int kstep) {  // the N tile's weights at step kstep
    const int8_t* const wb = wk + ((long long)kstep * g.cout + n0) * KSTEP + seg * 16;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int r = (tid >> 2) + j * (NT / 4);
      const bool ok = n0 + r < g.cout;
      cp_async16(bs + cm_off(r, seg), ok ? wb + r * KSTEP : wk, ok);
    }
  };
  // issues stages while the ring has room
  auto produce = [&](int consumed) {
    while (issued - consumed < STAGES - 1 && p_item < n_items) {
      int8_t* const st = smem + (issued % STAGES) * g.stage_bytes;
#if QW_LOADS
#if QW_SPLIT_SMEM
      if (p_step == 0) begin(pa, p_item);
      stage_a(st);
      advance(pa);
#endif
      stage_b(st + T::RAW, kbeg + p_step);
#endif
      cp_async_commit();
      ++issued;
      if (++p_step == nst) {
        p_step = 0;
        ++p_item;
      }
    }
  };

#if !QW_SPLIT_SMEM
  // the consumer's own A walker, one step ahead, in registers: ra holds the
  // step it splits next
  Rows<A_PER> ca;
  int a_item = 0, a_step = 0;
  uint4 ra[A_PER][2];
  auto load_next = [&](uint4 (&dst)[A_PER][2]) {
    if (a_item >= n_items) return;
    if (a_step == 0) begin(ca, a_item);
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
#if QW_LOADS
      load_seg(ca, j, dst[j]);
#else
      dst[j][0] = dst[j][1] = zero;
#endif
    }
    advance(ca);
    if (++a_step == nst) {
      a_step = 0;
      ++a_item;
    }
  };
#endif

  produce(0);
#if !QW_SPLIT_SMEM
  load_next(ra);
#endif
  // izp * colsum of the N tile's columns, taken off by split 0 alone
  for (int i = tid; i < BN; i += NT)
    colz[i] = blockIdx.z == 0 && n0 + i < g.cout ? (int64_t)g.izp * colsum[n0 + i] : 0;

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // fragment: acc[j][4 jb + e] is row 16 warp + lane / 4 + 8 (e >> 1) of the
  // warpgroup's 64, column 64 j + 8 jb + 2 (lane % 4) + (e & 1)
  const int rl0 = wg * 64 + 16 * warp + (lane >> 2);
  int32_t acc_hi[NJ][32], acc_lo[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_hi[j][i] = acc_lo[j][i] = 0;
  int consumed = 0, c_item = 0, c_step = 0;
  while (c_item < n_items) {
    produce(consumed);
    cp_async_wait_upto(issued - consumed - 1);
    int8_t* const st = smem + (consumed % STAGES) * g.stage_bytes;
    int8_t* const ph = smem + g.off_planes + (consumed % PSLOTS) * 2 * T::PLANE;
    int8_t* const pz = ph + T::PLANE;
    // this thread's segments into the step's plane slot: the bytes it copied
    // (or loaded) itself, so no barrier comes between
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int r = (tid >> 2) + j * (NT / 4);
#if !QW_SPLIT_SMEM
      const uint4 v0 = ra[j][0], v1 = ra[j][1];
#else
      const uint4 v0 = *reinterpret_cast<const uint4*>(st + r * 64 + seg * 16);
      const uint4 v1 = *reinterpret_cast<const uint4*>(st + T::PLANE + r * 64 + seg * 16);
#endif
      uint4 hi, lo;
      split_planes(v0, v1, hi, lo);
      *reinterpret_cast<uint4*>(ph + cm_off(r, seg)) = hi;
      *reinterpret_cast<uint4*>(pz + cm_off(r, seg)) = lo;
    }
#if !QW_SPLIT_SMEM
    load_next(ra);  // the next step's loads fly through the barrier and the products
#endif
    fence_proxy_async();
    __syncthreads();
#if QW_MMA
    const int8_t* const bs = st + T::RAW;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dh = gmma_desc(ph + wg * 4096 + kk * 256, 128, 512);
      const uint64_t dl = gmma_desc(pz + wg * 4096 + kk * 256, 128, 512);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint64_t db = gmma_desc(bs + j * 4096 + kk * 256, 128, 512);
        wgmma64<false>(acc_hi[j], dh, db);
        wgmma64<true>(acc_lo[j], dl, db);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#endif
    ++consumed;
    if (++c_step < nst) continue;

    // the epilogue of item c_item: 256 acc_hi + acc_lo - izp colsum in int64
    const int m0 = (mb + c_item * g.gm) * BM;
    const bool split = gridDim.z > 1;
#if QW_EPILOGUE
#if QW_STORE_STAGED
    if (!split && g.o_vec) {
      int8_t* const ot = smem + g.off_otile;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int cl = 64 * j + 8 * jb + 2 * (lane & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jb + 2 * h;
            *reinterpret_cast<longlong2*>(ot + (rl0 + 8 * h) * T::OS + cl * 8) = make_longlong2(
                256 * (long long)acc_hi[j][i] + acc_lo[j][i] - colz[cl],
                256 * (long long)acc_hi[j][i + 1] + acc_lo[j][i + 1] - colz[cl + 1]);
          }
        }
      __syncthreads();
      const int ncols = min(BN, g.cout - n0);
      for (int i = tid; i < BM * (BN / 2); i += NT) {
        const int r = i / (BN / 2), c = 2 * (i % (BN / 2));
        if (m0 + r < g.M && c < ncols)
          *reinterpret_cast<longlong2*>(out + (long long)(m0 + r) * g.cout + n0 + c) =
              *reinterpret_cast<const longlong2*>(ot + r * T::OS + c * 8);
      }
      // the tile is written again only after the next item's barriers
    } else
#endif
    {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int cl = 64 * j + 8 * jb + 2 * (lane & 3), col = n0 + cl;
          if (col >= g.cout) continue;
          const bool pair = col + 1 < g.cout;
          const int64_t z0 = colz[cl], z1 = colz[cl + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + rl0 + 8 * h;
            if (row >= g.M) continue;
            const int i = 4 * jb + 2 * h;
            const long long v0 = 256 * (long long)acc_hi[j][i] + acc_lo[j][i] - z0;
            const long long v1 = 256 * (long long)acc_hi[j][i + 1] + acc_lo[j][i + 1] - z1;
            int64_t* const p = out + (long long)row * g.cout + col;
            if (split) {  // 64-bit integer atomics: the same sum in any order
              atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v0);
              if (pair)
                atomicAdd(reinterpret_cast<unsigned long long*>(p + 1), (unsigned long long)v1);
            } else if (pair && g.o_vec) {
              *reinterpret_cast<longlong2*>(p) = make_longlong2(v0, v1);
            } else {
              p[0] = v0;
              if (pair) p[1] = v1;
            }
          }
        }
    }
#endif
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_hi[j][i] = acc_lo[j][i] = 0;
    c_step = 0;
    ++c_item;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The geometry of a launch from the parameter array (params.cuh); false for
// a shape, zero point or split the kernel does not take.
inline bool make_geo(const int32_t* p, WGeo& g, int& ks) {
  g.n = p[P_N];
  g.h = p[P_H];
  g.w = p[P_W];
  g.cin = p[P_CIN];
  g.kh = p[P_KH];
  g.kw = p[P_KW];
  g.cout = p[P_COUT];
  g.oh = p[P_OH];
  g.ow = p[P_OW];
  g.sh = p[P_SH];
  g.sw = p[P_SW];
  g.pt = p[P_PT];
  g.pl = p[P_PL];
  g.izp = p[P_IZP];
  g.dh = p[P_DH] ? p[P_DH] : 1;
  g.dw = p[P_DW] ? p[P_DW] : 1;
  g.cspan = p[P_CSPAN] ? p[P_CSPAN] : g.cin;
  if (g.cin <= 0 || g.kh <= 0 || g.kw <= 0 || g.sh <= 0 || g.sw <= 0 || g.izp < -32768 ||
      g.izp > 32767 || g.dh <= 0 || g.dw <= 0 || g.cspan <= 0 || g.cin % g.cspan != 0 ||
      (long long)g.cout * g.cspan % g.cin != 0)
    return false;
  g.nspan = (int)((long long)g.cout * g.cspan / g.cin);
  if (g.nspan <= 0) g.nspan = 1;  // COUT 0: no tile
  g.M = g.n * g.oh * g.ow;
  g.K = g.kh * g.kw * g.cspan;
  if (g.K > K_BOUND || (long long)g.n * g.oh * g.ow >= (1LL << 31)) return false;
  g.steps = (g.K + KSTEP - 1) / KSTEP;
  g.kper = p[P_KPER];
  ks = p[P_KS];
  if (!(ks >= 1 && g.kper >= 1 && (long long)ks * g.kper >= g.steps &&
        (ks - 1) * g.kper < g.steps))
    return false;
  g.izp2 = (uint32_t)(uint16_t)(int16_t)g.izp * 0x00010001u;
  g.a_vec = p[P_A_VEC] != 0 && g.cin % 8 == 0 && g.cspan % 8 == 0;
  return true;
}

// Launches the kernel over a grid of (N tiles x gm, 1, ks): gm M-tile lanes,
// gm as large as the card holds blocks at once (the occupancy API, once per
// tile: its shared memory does not depend on the call) and at most the M
// tiles.
template <int BM, int BN>
int launch_tile(const int16_t* x, const int8_t* wk, int64_t* out, const int64_t* colsum, WGeo g,
                int ks, cudaStream_t stream) {
  using T = WTiles<BM, BN>;
  auto kern = qwide_hopper<BM, BN>;
  smem_layout<BM, BN>(g);
  if (g.smem > (int)hop::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // an N tile lies inside one super-group
  if (g.nspan != g.cout && g.nspan % BN != 0) return (int)cudaErrorInvalidValue;
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0, n = 0, b = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hop::SMEM_LIMIT) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, T::NT, g.smem) != cudaSuccess)
      return (int)cudaGetLastError();
    if (b < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm = b;
    sms = n;
  }
  g.m_tiles = (g.M + BM - 1) / BM;
  g.n_tiles = (g.cout + BN - 1) / BN;
  g.gm = std::max(1, std::min(g.m_tiles, sms * per_sm / (g.n_tiles * ks)));
  g.by_ohow = hop::FastDiv::make(g.oh * g.ow);
  g.by_ow = hop::FastDiv::make(g.ow);
  const dim3 grid(g.n_tiles * g.gm, 1, ks);
  kern<<<grid, T::NT, g.smem, stream>>>(x, wk, out, colsum, g);
  return (int)cudaGetLastError();
}

// The tile (P_BM, P_BN) from {64, 128}^2.
inline int launch(const int16_t* x, const int8_t* wk, int64_t* out, const int64_t* colsum,
                  const WGeo& g, int ks, const int32_t* p, cudaStream_t s) {
  if (g.M <= 0 || g.cout <= 0) return (int)cudaGetLastError();
  const int bm = p[P_BM] ? p[P_BM] : 64, bn = p[P_BN] ? p[P_BN] : 64;
#define TK_TILE(BM, BN) \
  if (bm == BM && bn == BN) return launch_tile<BM, BN>(x, wk, out, colsum, g, ks, s);
  TK_TILE(64, 64)
  TK_TILE(64, 128)
  TK_TILE(128, 64)
  TK_TILE(128, 128)
#undef TK_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace wide
}  // namespace tk

// The GEMM: x int16 (M, K) row-major as a 1x1 conv of M 1 x 1 images (P_N =
// M, P_CIN = K, every other extent 1, no padding), wk the weight (K, N)
// packed (Kp / 64, N, 64) (kmajor_weights), colsum int64 (N,), out int64 (M,
// N), zeroed by the caller when P_KS > 1.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for another geometry, K above K_BOUND, an izp outside
// int16, a split that does not cover K or a tile not built).
extern "C" int tk_qgemm_wide(const int16_t* x, const int8_t* wk, int64_t* out,
                             const int64_t* colsum, const int32_t* p, void* stream) {
  using namespace tk;
  wide::WGeo g;
  int ks = 1;
  if (!wide::make_geo(p, g, ks) || g.h != 1 || g.w != 1 || g.kh != 1 || g.kw != 1 ||
      g.oh != 1 || g.ow != 1 || g.pt != 0 || g.pl != 0)
    return (int)cudaErrorInvalidValue;
  g.o_vec = g.cout % 2 == 0 && (uintptr_t)out % 16 == 0;
  return wide::launch(x, wk, out, colsum, g, ks, p, (cudaStream_t)stream);
}

// The conv: x int16 NHWC, wk the weight (KH, KW, P_CSPAN, COUT) packed (Kp /
// 64, COUT, 64) (a grouped conv's block-diagonal weight: P_CSPAN the input
// channels of a super-group; 0 for a dense conv), colsum int64 (COUT,), out
// int64 (N, OH, OW, COUT), zeroed by the caller when P_KS > 1; any stride,
// padding (top P_PT, left P_PL) and dilation (P_DH, P_DW; 0 means 1).
// Returns as tk_qgemm_wide (cudaErrorInvalidValue too for a P_CSPAN that
// does not divide CIN, or a super-group whose columns are not whole N tiles).
extern "C" int tk_qconv_wide(const int16_t* x, const int8_t* wk, int64_t* out,
                             const int64_t* colsum, const int32_t* p, void* stream) {
  using namespace tk;
  wide::WGeo g;
  int ks = 1;
  if (!wide::make_geo(p, g, ks)) return (int)cudaErrorInvalidValue;
  g.o_vec = g.cout % 2 == 0 && (uintptr_t)out % 16 == 0;
  return wide::launch(x, wk, out, colsum, g, ks, p, (cudaStream_t)stream);
}
