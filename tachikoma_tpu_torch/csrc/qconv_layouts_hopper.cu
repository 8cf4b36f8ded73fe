// K7 qconv_rq_t and K9 qconv_rq_w, the Hopper designs of two layouts of the
// flat conv.
//
// Each computes exactly K2's function: the NHWC int8 conv, the int32
// accumulator plus the folded bias, the exact requantize epilogue of
// requantize.cuh, the low byte of the clipped value stored (int8 or uint8).
// They replace the layout variants of tachikoma_tpu/ops/pallas/conv_flat.py
// (both reach pl.pallas_call at :370 through _build_flat_conv, :321):
//   K7 qconv_rq_t <- _flat_conv_kernel_t (:278): the image channel-major, so
//      that a tap's shift runs along the contiguous axis;
//   K9 qconv_rq_w <- _flat_conv_kernel_w (:182): one wide product of the
//      window against several taps' weights side by side, then shifted int32
//      sums.
//
// The polyphase frame, the stagers, the step walk, the cluster split and the
// cost model are layouts_hopper.cuh's, shared with K8 and K10
// (qconv_layouts.cu).
//
// What bounds them on the H100.  The three 3x3 s2 convs of ResNet-50 b8 move
// about 10 MB and do 5.5 GOP: 3 us at 3.35 TB/s, 2.8 us at the int8 peak, so
// neither bound is near.  What a flat-frame design loses is overhead: a
// per-call operand build, the polyphase zero taps, exposed copy latency,
// per-copy address arithmetic and too few blocks at 7^2.  On one H100 80GB
// HBM3 (700 W), at 64 x 64, K7 takes 0.12 ms and K9 0.16 ms for the three
// calls, against K2's 0.16 ms (chip_smoke.py phase 15b).  The design:
//   1. No per-call operand build: the polyphase relabeling is address
//      arithmetic in the stagers (layouts_hopper.cuh); taps outside the
//      image read izp (a 16-byte shared store, as K11's stager does:
//      cp.async's zero fill and TMA's out-of-bounds fill are zero, not izp).  The divisors are
//      multiply-high constants made on the host (FastDiv), a thread keeps
//      its 16-byte segment on every row it stages, and each tap's weight
//      offset is made once per step.
//   2. The zero taps are skipped: channels run in chunks of 64; a (chunk,
//      tap) pair is multiplied only when some phase of the chunk has that tap
//      (a*SH + p < KH and b*SW + q < KW).  With CIN % 64 == 0 a chunk lies in
//      one phase, and a 3x3 s2 conv runs 9 tap-phase products, not 16.  A
//      chunk with no phase channel past its first 32 runs one K step.  The
//      skipped products are exact zeros; int32 sums wrap in any order.
//   3. The copies are pipelined: a step is (chunk, a group of up to four
//      live taps); the next step's window (when it starts a new chunk) and
//      weights are in flight (cp.async, 16-byte, two buffers each) while the
//      current step is multiplied.
//   4. The card is filled: M and N tiles are in the grid, and where twice the
//      tiles still fit the card's block slots in one wave (the 7^2 stage: 64
//      tiles of 64 x 64 on 132 SMs, 32 chunks each), a cluster of two blocks
//      splits the chunks; rank 1's int32 sums reach rank 0 through
//      distributed shared memory, with no second pass and no atomics.  The
//      launcher picks the taps per step and the split together from a cost
//      model (plan_launch): fewer taps a step spend fewer bytes, so more
//      blocks share an SM and more tiles split.
//
// K9, the wide product on wgmma.  Per step, P = window (rows x 64) .
// [W_t0 .. W_tg-1] (64 x g*BN) runs as wgmma.mma_async m64n32k32 .s32.s8.s8
// with the operands swapped: A is the weights (M = the g*BN (tap, column)
// rows, a multiple of 64 for any tile) and B the window (N = 32 window rows
// per instruction).  int8 wgmma takes both operands K-major only, so the
// weights are staged [n][k] and the window [row][k], in the no-swizzle
// core-matrix layout (8 rows x 16 bytes per 128-byte core matrix; LBO 128,
// SBO 512).  The swap puts the window rows on wgmma's N, whose granule is
// 8..16 rows, not on M's 64: at BM 128 on the 28^2 stage the 158 window rows
// become 160 (5 x 32), not 192 (mma.sync's 16-row granule would give 160
// too, at four times the instructions).  Each accumulator fragment goes to
// shared memory once, as P[row][tap*BN + n] with rows padded to g*BN + 4
// words (conflict-free fragment stores); each thread then adds its outputs'
// g shifted partials with 16-byte loads.  P is single-buffered: double
// buffering it would not fit the 28^2 stage's window at BM 128.
//
// K7, channel-major in shared memory.  Per chunk, the window arrives NHWC
// ([pixel][64], cp.async) and is turned around once, in registers (4 pixels
// x 16 channels per thread, __byte_perm), into [channel][pixel] rows of
// stride round_up(rows + 4, 32) + 8 bytes (conflict-free fragment loads).
// Per tap, each thread builds its mma.sync m16n8k32 A fragments straight from
// there: four channel rows at pixel m + off, word loads, __funnelshift_r and
// a 4x4 __byte_perm transpose; a thread's four fragment rows are four
// neighbouring pixels, so one funnel shift serves all four.  No A tile and no
// barrier between the taps of a step.  B, the weights, is [n][k] (stride 80),
// every tap of the step staged at once.  K7 stays on mma.sync: its point is
// that each warp assembles its own A fragments per tap, at any pixel shift,
// from the channel-major window; wgmma would want a 64-row A operand that four
// warps build in lockstep, or a staged tile per tap, which is the copy this
// layout exists to avoid.  K9 is the wgmma kernel of the pair.
#include "layouts_hopper.cuh"

namespace tk {
namespace hop {

constexpr int W_THREADS = 256;  // K9: two warpgroups
constexpr int W_NW = 32;        // K9: window rows per wgmma (its N)
constexpr int W_IB = 4;         // K9: wgmma tiles in flight per warpgroup
constexpr int W_PPAD = 4;       // K9: int32 words of padding per row of P
constexpr int T_SROW = 80;      // K7: bytes per weight row

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The 4x4 byte transpose: u[j] byte r = v[r] byte j.
__device__ __forceinline__ void transpose4(const uint32_t (&v)[4], uint32_t (&u)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362), t3 = __byte_perm(v[2], v[3], 0x7362);
  u[0] = __byte_perm(t0, t1, 0x5410);
  u[1] = __byte_perm(t0, t1, 0x7632);
  u[2] = __byte_perm(t2, t3, 0x5410);
  u[3] = __byte_perm(t2, t3, 0x7632);
}

// ---------------------------------------------------------------------------
// K9 qconv_rq_w
// ---------------------------------------------------------------------------

// d (64 x 32) = A (64 x 32 bytes) . B (32 x 32 bytes)^T, + d when accumulate.
__device__ __forceinline__ void wgmma_m64n32k32(int32_t (&d)[16], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__host__ __device__ inline int w_rows_pad(int bm, int maxoff) {
  return (bm + maxoff + W_NW - 1) / W_NW * W_NW;
}

// P[row][tl*BN + n] = sum_k window[row][k] * wt[tl*BN + n][k] for the step's
// g taps: (g*BN/64) x (rows_pad/32) wgmma tiles of `ksteps` 32-byte K steps,
// W_IB in flight per warpgroup, each fragment stored once.
__device__ void wide_product(const int8_t* win, const int8_t* wt, int32_t* P, int mtiles,
                             int rows_pad, int ps, int ksteps) {
  const int wg = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int items = mtiles * (rows_pad / W_NW);
  for (int it0 = wg * W_IB; it0 < items; it0 += 2 * W_IB) {
    int32_t d[W_IB][16];
#pragma unroll
    for (int j = 0; j < W_IB; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) d[j][i] = 0;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < W_IB; ++j) {
      const int it = it0 + j;
      if (it < items) {
        const int mt = it % mtiles, rb = it / mtiles;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          if (kk < ksteps)
            wgmma_m64n32k32(d[j], gmma_desc(wt + mt * 4096 + kk * 256, 128, 512),
                            gmma_desc(win + rb * (W_NW / 8) * 512 + kk * 256, 128, 512), kk);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    // fragment: d[4jb + e] is D[r + 8 (e >> 1)][c + (e & 1)], r = 16 wi + lane / 4,
    // c = 8 jb + 2 (lane % 4): D's rows are P's columns, D's columns P's rows
    const int r = 16 * wi + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < W_IB; ++j) {
      const int it = it0 + j;
      if (it < items) {
        const int mt = it % mtiles, rb = it / mtiles;
        int32_t* base = P + (rb * W_NW + c) * ps + mt * 64 + r;
#pragma unroll
        for (int jb = 0; jb < W_NW / 8; ++jb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            base[(8 * jb + (e & 1)) * ps + 8 * (e >> 1)] = d[j][4 * jb + e];
      }
    }
  }
}

template <int BM, int BN, int KS>
__global__ void __launch_bounds__(W_THREADS)
    qconv_w_hopper(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                   int8_t* __restrict__ out, Requant rq, HGeo g) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int TPR = BN / 4, RPP = W_THREADS / TPR, PASSES = BM / RPP;
  const int rows_pad = w_rows_pad(BM, g.maxoff);
  const int ps = g.group * BN + W_PPAD;
  // two windows, two weight tiles, the partials (buffer b at base + b * size)
  const int win_sz = rows_pad * KC, wt_sz = g.group * BN * KC;
  int8_t* const win = smem;
  int8_t* const wt = smem + 2 * win_sz;
  int32_t* P = reinterpret_cast<int32_t*>(wt + 2 * wt_sz);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nq = threadIdx.x % TPR, mr = threadIdx.x / TPR;

  uint32_t acc[PASSES * 4];  // output (mr + i * RPP, col + e) at acc[4 i + e]
#pragma unroll
  for (int i = 0; i < PASSES * 4; ++i) acc[i] = 0;

  Step cur = step_from<false>(KS > 1 ? (int)blockIdx.z : 0, 0, KS, g);
  int wb = 0;  // the window buffer of cur's chunk
  if (cur.chunk < g.nchunks) {
    stage_window<CM, W_THREADS>(win, 0, x, m0, rows_pad, cur.chunk * KC, g);
    stage_weights<CM, BN, W_THREADS>(wt, 0, wk, cur, n0, g);
  }
  cp_async_commit();
  for (int s = 0; cur.chunk < g.nchunks; ++s) {
    const Step nxt = next_step<false>(cur, KS, g);
    const int nwb = nxt.chunk != cur.chunk ? wb ^ 1 : wb;
    if (nxt.chunk < g.nchunks) {
      if (nxt.chunk != cur.chunk)
        stage_window<CM, W_THREADS>(win + nwb * win_sz, 0, x, m0, rows_pad, nxt.chunk * KC, g);
      stage_weights<CM, BN, W_THREADS>(wt + ((s + 1) & 1) * wt_sz, 0, wk, nxt, n0, g);
    }
    cp_async_commit();
    cp_async_wait1();
    fence_proxy_async();
    __syncthreads();
    wide_product(win + wb * win_sz, wt + (s & 1) * wt_sz, P, cur.g * BN / 64, rows_pad, ps,
                 chunk_ksteps(cur.chunk * KC, g));
    __syncthreads();
    for (int tl = 0; tl < cur.g; ++tl) {
      const int32_t* src = P + (mr + tap_off(step_tap(cur, tl), g)) * ps + tl * BN + 4 * nq;
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const int4 v = *reinterpret_cast<const int4*>(src + i * RPP * ps);
        acc[4 * i] += (uint32_t)v.x;
        acc[4 * i + 1] += (uint32_t)v.y;
        acc[4 * i + 2] += (uint32_t)v.z;
        acc[4 * i + 3] += (uint32_t)v.w;
      }
    }
    cur = nxt;
    wb = nwb;
  }
  if (!cluster_reduce<KS, W_THREADS>(acc, smem)) return;

  const int col = n0 + 4 * nq;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const long long o = out_index(m0 + mr + i * RPP, g);
    if (o < 0 || col >= g.cout) continue;
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < g.cout)
        v |= (uint32_t)(uint8_t)requantize_channel((int32_t)acc[4 * i + e], col + e, rq)
             << (8 * e);
    if (g.o_vec) {
      *reinterpret_cast<uint32_t*>(out + o + col) = v;
    } else {
      for (int e = 0; e < 4 && col + e < g.cout; ++e) out[o + col + e] = (int8_t)(v >> (8 * e));
    }
  }
}

// ---------------------------------------------------------------------------
// K7 qconv_rq_t
// ---------------------------------------------------------------------------

__host__ __device__ inline int t_rows4(int bm, int maxoff) { return (bm + maxoff + 3) & ~3; }
// row stride of the channel-major window: >= rows + 4 (the funnel shift's
// second word), and 8 mod 32 so that four channel rows hit four bank octets
__host__ __device__ inline int t_xs(int bm, int maxoff) {
  return ((t_rows4(bm, maxoff) + 4 + 31) & ~31) + 8;
}

template <int BM, int BN, int KS>
__global__ void __launch_bounds__(Tile<BM, BN>::NTHREADS)
    qconv_t_hopper(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                   int8_t* __restrict__ out, Requant rq, HGeo g) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int NT = Tile<BM, BN>::NTHREADS;
  const int rows4 = t_rows4(BM, g.maxoff), xs = t_xs(BM, g.maxoff);
  // two NHWC windows, the channel-major window, two weight tiles (buffer b
  // at base + b * size)
  const int st_sz = rows4 * KC, wt_sz = g.group * BN * T_SROW;
  int8_t* const stage = smem;
  int8_t* const cwin = smem + 2 * st_sz;
  int8_t* const wt = cwin + KC * xs;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp % Tile<BM, BN>::WARPS_M) * 32, wn = (warp / Tile<BM, BN>::WARPS_M) * 32;
  int32_t acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  Step cur = step_from<false>(KS > 1 ? (int)blockIdx.z : 0, 0, KS, g);
  int wb = 0, last_chunk = -1;
  if (cur.chunk < g.nchunks) {
    stage_window<ROWS, NT>(stage, KC, x, m0, rows4, cur.chunk * KC, g);
    stage_weights<ROWS, BN, NT>(wt, T_SROW, wk, cur, n0, g);
  }
  cp_async_commit();
  for (int s = 0; cur.chunk < g.nchunks; ++s) {
    const Step nxt = next_step<false>(cur, KS, g);
    const int nwb = nxt.chunk != cur.chunk ? wb ^ 1 : wb;
    if (nxt.chunk < g.nchunks) {
      if (nxt.chunk != cur.chunk)
        stage_window<ROWS, NT>(stage + nwb * st_sz, KC, x, m0, rows4, nxt.chunk * KC, g);
      stage_weights<ROWS, BN, NT>(wt + ((s + 1) & 1) * wt_sz, T_SROW, wk, nxt, n0, g);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (cur.chunk != last_chunk) {
      // [pixel][64] -> [channel][pixel]: 4 pixels x 16 channels a thread
      const int8_t* src = stage + wb * st_sz;
      for (int e = threadIdx.x; e < rows4; e += NT) {
        const int seg = e & 3, pq = e >> 2;
        uint4 px[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          px[j] = *reinterpret_cast<const uint4*>(src + (4 * pq + j) * KC + seg * 16);
        const uint32_t* pw = reinterpret_cast<const uint32_t*>(px);
#pragma unroll
        for (int cg = 0; cg < 4; ++cg) {
          const uint32_t v[4] = {pw[cg], pw[4 + cg], pw[8 + cg], pw[12 + cg]};
          uint32_t u[4];
          transpose4(v, u);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<uint32_t*>(cwin + (seg * 16 + 4 * cg + r) * xs + 4 * pq) = u[r];
        }
      }
      last_chunk = cur.chunk;
      __syncthreads();
    }
    const int kend = 32 * chunk_ksteps(cur.chunk * KC, g);
    for (int tl = 0; tl < cur.g; ++tl) {
      const int p = wm + 4 * gid + tap_off(step_tap(cur, tl), g);
      const int pa = p & ~3, sh = (p & 3) * 8;
      const int8_t* bs = wt + (s & 1) * wt_sz + tl * BN * T_SROW;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 32) {
        if (ks >= kend) break;
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int8_t* rowp = cwin + (ks + 16 * h + 4 * tig) * xs + pa;
          uint32_t v[4], u[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            v[r] = __funnelshift_r(lds32(rowp + r * xs), lds32(rowp + r * xs + 4), sh);
          transpose4(v, u);
          af[0][2 * h] = u[0];
          af[0][2 * h + 1] = u[1];
          af[1][2 * h] = u[2];
          af[1][2 * h + 1] = u[3];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* q = bs + (wn + nt * 8 + gid) * T_SROW + ks + tig * 4;
          bf[nt][0] = lds32(q);
          bf[nt][1] = lds32(q + 16);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();
    cur = nxt;
    wb = nwb;
  }

  if (!cluster_reduce<KS, NT>(reinterpret_cast<uint32_t(&)[32]>(acc), smem)) return;

  // fragment row gid + 8 (i >> 1) of tile mt is pixel 4 gid + 2 mt + (i >> 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = out_index(m0 + wm + 4 * gid + 2 * mt + h, g);
      if (o < 0) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + nt * 8 + 2 * tig + e;
          if (col < g.cout)
            out[o + col] = (int8_t)requantize_channel(acc[mt][nt][2 * h + e], col, rq);
        }
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum HLayout { H_T, H_W };

// Dynamic shared memory; the wrapper mirrors these sums (conv_layouts.py
// smem_bytes) to refuse a tile that does not fit.
inline size_t smem_bytes(HLayout l, int bm, int bn, int group, int maxoff) {
  if (l == H_W) {
    const int rows_pad = w_rows_pad(bm, maxoff);
    return 2 * (size_t)rows_pad * KC + 2 * (size_t)group * bn * KC +
           (size_t)rows_pad * (group * bn + W_PPAD) * 4;
  }
  return 2 * (size_t)t_rows4(bm, maxoff) * KC + (size_t)KC * t_xs(bm, maxoff) +
         2 * (size_t)group * bn * T_SROW;
}

template <HLayout L, int BM, int BN>
int launch_tile(const int8_t* x, const int8_t* wk, int8_t* out, const Requant& rq, HGeo g,
                cudaStream_t stream) {
  auto kern1 = L == H_W ? qconv_w_hopper<BM, BN, 1> : qconv_t_hopper<BM, BN, 1>;
  auto kern2 = L == H_W ? qconv_w_hopper<BM, BN, 2> : qconv_t_hopper<BM, BN, 2>;
  const int threads = L == H_W ? W_THREADS : Tile<BM, BN>::NTHREADS;
  static int sms = 0;
  Plan plan;
  const int rc = plan_launch(
      (const void*)kern1, (const void*)kern2, threads, BM, BN, false, g,
      [&](int grp) { return smem_bytes(L, BM, BN, grp, g.maxoff); }, sms, plan);
  if (rc != cudaSuccess) return rc;
  g.group = plan.group;
  const dim3 grid((g.mo + BM - 1) / BM, (g.cout + BN - 1) / BN, plan.split ? 2 : 1);
  return launch_cluster(plan.split ? kern2 : kern1, plan.split ? 2 : 1, grid, threads, plan.smem,
                        stream, x, wk, out, rq, g);
}

// Launches K7 or K9 on `stream` at the tile (P_BM, P_BN), up to P_GROUP live
// taps per step, and returns cudaGetLastError() (cudaErrorInvalidValue for
// a tile that is not built, a group out of range, more than 255 taps or
// shared memory above 227 KB).  wk is the weight packed (KH, KW, COUT, CIN).
// On ResNet-50 b8 at 64 x 64 the cost model takes K9 to three taps a step at
// 28^2 and 14^2 (two blocks an SM, and the split at 14^2) and four at 7^2.
template <HLayout L>
int launch(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
           const int32_t* mult, const int32_t* shift, const int32_t* p, void* stream) {
  HGeo g;
  if (!make_geo(p, g)) return (int)cudaErrorInvalidValue;
  const Requant rq = make_rq(bias, mult, shift, p);
  const int bm = p[P_BM] ? p[P_BM] : 64, bn = p[P_BN] ? p[P_BN] : 64;
  if (g.group < 1 || g.group > GMAX || (L == H_W && g.group * bn > 256) ||
      g.khp * g.kwp > 255)
    return (int)cudaErrorInvalidValue;
  if (g.mo <= 0 || g.cout <= 0 || g.oh <= 0 || g.ow <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return launch_tile<L, 64, 64>(x, wk, out, rq, g, s);
  if (bm == 64 && bn == 128) return launch_tile<L, 64, 128>(x, wk, out, rq, g, s);
  if (bm == 128 && bn == 64) return launch_tile<L, 128, 64>(x, wk, out, rq, g, s);
  if (bm == 128 && bn == 128) return launch_tile<L, 128, 128>(x, wk, out, rq, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace hop
}  // namespace tk

extern "C" int tk_qconv_rq_t(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
                             const int32_t* mult, const int32_t* shift, const int32_t* params,
                             void* stream) {
  return tk::hop::launch<tk::hop::H_T>(x, wk, out, bias, mult, shift, params, stream);
}

extern "C" int tk_qconv_rq_w(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
                             const int32_t* mult, const int32_t* shift, const int32_t* params,
                             void* stream) {
  return tk::hop::launch<tk::hop::H_W>(x, wk, out, bias, mult, shift, params, stream);
}
