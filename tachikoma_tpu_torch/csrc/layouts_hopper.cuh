// What the Hopper designs of the flat conv's four layouts share: K7
// qconv_rq_t and K9 qconv_rq_w (qconv_layouts_hopper.cu), K8 qconv_rq_s and
// K10 qconv_rq_r (qconv_layouts.cu).
//
// The frame.  A stride-s conv is the stride-1 conv over the polyphase frame:
// frame row (n, i, j), i < HPH = OH + KHP - 1, j < WPH = OW + KWP - 1, holds
// C = SH*SW*CIN phase channels, channel c = (p*SW + q)*CIN + ci reading
// x[n, i*SH + p - pt, j*SW + q - pl, ci] (the input zero point outside the
// image), and tap (a, b) of phase (p, q) has weight w[a*SH + p, b*SW + q]
// (none past KH or KW).  Over-wide output row m = (n*HPH + oh)*WPH + ow reads
// frame row m + a*WPH + b for tap (a, b).  None of it is built: the stagers
// compute each address from the caller's NHWC image and from the weights
// packed once per weight tensor as (KH, KW, COUT, CIN) (K-major, cached by
// the wrapper), and the epilogues store straight into (N, OH, OW, COUT),
// skipping the over-wide rows and columns.
//
// Taps outside the image read izp, written by 16-byte shared stores (as K11's
// stager does): cp.async's zero fill and TMA's out-of-bounds fill are zero,
// and izp is folded into the bias through the weights' column sums.  The
// divisors are multiply-high constants made on the host (FastDiv), a thread
// keeps its 16-byte segment on every row it stages, and each tap's weight
// offset is made once per step.
//
// Channels run in chunks of 64; a (chunk, tap) pair is multiplied only when
// some phase of the chunk has that tap (a*SH + p < KH and b*SW + q < KW).
// With CIN % 64 == 0 a chunk lies in one phase, and a 3x3 s2 conv runs 9
// tap-phase products, not 16.  The skipped products are exact zeros; int32
// sums wrap in any order.  A step is up to `group` live taps of one chunk
// (and, for K10, of one column tap); its copies are in flight while the step
// before it is multiplied.  Where twice the tiles fit the card at once, a
// cluster of two blocks splits the chunks (cluster_reduce), and the launcher
// picks the taps per step and the split from a cost model (plan_launch).
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "qgemm.cuh"

namespace tk {
namespace hop {

constexpr int KC = 64;    // phase channels per chunk
constexpr int GMAX = 4;   // live taps per step
constexpr size_t SMEM_LIMIT = 232448;

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the divisors are
// runtime geometry; a hardware-less integer division costs ~25 instructions
// and the stagers take several per 16-byte copy).  m = ceil(2^(31+l) / d)
// with 2^l >= d; m == 0 stands for d == 1.
struct FastDiv {
  uint32_t m, s;
  static FastDiv make(int d) {
    FastDiv f{0u, 0u};
    if (d > 1) {
      int l = 0;
      while ((1u << l) < (uint32_t)d) ++l;
      f.m = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
      f.s = (uint32_t)(l - 1);
    }
    return f;
  }
  __device__ __forceinline__ int div(int n) const {
    return m ? (int)(__umulhi((uint32_t)n, m) >> s) : n;
  }
};

struct HGeo {
  int n, h, w, cin, kh, kw, cout, sh, sw, pt, pl, oh, ow;
  int khp, kwp, hph, wph, plane, cs, mo, maxoff, nchunks;
  int group;     // live taps per step
  uint32_t izp4;  // the input zero point in each byte
  bool a_vec;     // 16-byte image loads (CIN % 16 == 0, x aligned)
  bool b_vec;     // 16-byte weight loads (CIN % 16 == 0)
  bool o_vec;     // 4-byte output stores (COUT % 4 == 0)
  FastDiv by_plane, by_wph, by_cin, by_sw, by_kwp, by_khp;
};

// The geometry of a launch from the parameter array (params.cuh), `group`
// as the wrapper gave it; false for a stride or CIN that is not positive.
inline bool make_geo(const int32_t* p, HGeo& g) {
  g.n = p[P_N];
  g.h = p[P_H];
  g.w = p[P_W];
  g.cin = p[P_CIN];
  g.kh = p[P_KH];
  g.kw = p[P_KW];
  g.cout = p[P_COUT];
  g.sh = p[P_SH];
  g.sw = p[P_SW];
  g.pt = p[P_PT];
  g.pl = p[P_PL];
  g.oh = p[P_OH];
  g.ow = p[P_OW];
  if (g.sh <= 0 || g.sw <= 0 || g.cin <= 0) return false;
  g.khp = (g.kh + g.sh - 1) / g.sh;
  g.kwp = (g.kw + g.sw - 1) / g.sw;
  g.hph = g.oh + g.khp - 1;
  g.wph = g.ow + g.kwp - 1;
  g.plane = g.hph * g.wph;
  g.cs = g.sh * g.sw * g.cin;
  g.mo = g.n * g.hph * g.wph;
  g.maxoff = (g.khp - 1) * g.wph + g.kwp - 1;
  g.nchunks = (g.cs + KC - 1) / KC;
  g.group = p[P_GROUP];
  g.izp4 = (uint32_t)(uint8_t)(int8_t)p[P_IZP] * 0x01010101u;
  g.a_vec = p[P_A_VEC] != 0 && g.cin % 16 == 0;
  g.b_vec = g.cin % 16 == 0;
  g.o_vec = g.cout % 4 == 0;
  g.by_plane = FastDiv::make(g.plane);
  g.by_wph = FastDiv::make(g.wph);
  g.by_cin = FastDiv::make(g.cin);
  g.by_sw = FastDiv::make(g.sw);
  g.by_kwp = FastDiv::make(g.kwp);
  g.by_khp = FastDiv::make(g.khp);
  return true;
}

inline Requant make_rq(const int32_t* bias, const int32_t* mult, const int32_t* shift,
                       const int32_t* p) {
  return Requant{bias, mult, shift, p[P_RQ_IZP], p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                 p[P_TONEAREST] != 0};
}

// A phase channel c < cs as its phase (p, q) and image channel ci.
struct PhaseCh {
  int p, q, ci;
};
__device__ __forceinline__ PhaseCh phase_ch(int c, const HGeo& g) {
  const int ph = g.by_cin.div(c), p = g.by_sw.div(ph);
  return {p, ph - p * g.sw, c - ph * g.cin};
}

// A frame row as its image and (i, j) in the frame.
struct FrameRow {
  int img, i, j;
};
__device__ __forceinline__ FrameRow frame_row(int row, const HGeo& g) {
  const int img = g.by_plane.div(row), rem = row - img * g.plane;
  const int i = g.by_wph.div(rem);
  return {img, i, rem - i * g.wph};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
// cp_async16 cached in L1 as well as L2 (.ca, as ld.global caches), for
// copies that the SM reads again soon: an implicit GEMM's im2col rows, which
// the next taps' rows overlap, and weights that the SM's blocks share.  On
// the H100 it took K2's 56^2 call of ResNet-50 b8 from 32 to 12 us and
// VGG-16 b8's 224^2 c64 conv from 255 to 146 us (tools/conv_probe.py
// --cuts=k2_cg builds K2 with its copies in L2 alone, as they were).
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}
// Waits until at most `n` (0, 1 or 2) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2)
    cp_async_wait2();
  else if (n == 1)
    cp_async_wait1();
  else
    cp_async_wait0();
}

__device__ __forceinline__ int tap_off(int t, const HGeo& g) {
  const int a = g.by_kwp.div(t);
  return a * g.wph + t - a * g.kwp;
}

// Whether tap t has a weight in some phase of the chunk at channel k0.
__device__ __forceinline__ bool tap_live(int t, int k0, const HGeo& g) {
  const int a = g.by_kwp.div(t), b = t - a * g.kwp;
  const int ph_hi = g.by_cin.div(min(k0 + KC, g.cs) - 1);
  for (int ph = g.by_cin.div(k0); ph <= ph_hi; ++ph) {
    const int p = g.by_sw.div(ph), q = ph - p * g.sw;
    if (a * g.sh + p < g.kh && b * g.sw + q < g.kw) return true;
  }
  return false;
}

// The 32-byte K steps of the chunk at k0 that hold phase channels (1 or 2):
// past cs both operands are zero, so a narrow CIN skips the second.
__device__ __forceinline__ int chunk_ksteps(int k0, const HGeo& g) {
  return g.cs - k0 > 32 ? 2 : 1;
}

// A step: up to `group` live taps of one chunk, packed a byte each.  `t` is
// the walk's next position; chunk >= nchunks once the steps are done.  A
// block of a K split of KS walks every KS-th chunk (`stride`).  COLS (K10)
// walks the taps column by column, position t = b*KHP + a, and keeps a step
// inside one column tap b (`col`); otherwise position t is tap t and col 0.
struct Step {
  int chunk, t, g, col;
  uint32_t taps;
};

template <bool COLS>
__device__ Step step_from(int chunk, int t, int stride, const HGeo& g) {
  Step s{chunk, t, 0, 0, 0u};
  const int T = g.khp * g.kwp;
  while (s.chunk < g.nchunks) {
    const int k0 = s.chunk * KC;
    for (; s.t < T && s.g < g.group; ++s.t) {
      int tap = s.t, b = 0;
      if constexpr (COLS) {
        b = g.by_khp.div(s.t);
        if (s.g > 0 && b != s.col) break;
        tap = (s.t - b * g.khp) * g.kwp + b;
      }
      if (tap_live(tap, k0, g)) {
        s.col = b;
        s.taps |= (uint32_t)tap << (8 * s.g++);
      }
    }
    if (s.g > 0) return s;
    s.chunk += stride;
    s.t = 0;
  }
  return s;
}

template <bool COLS>
__device__ __forceinline__ Step next_step(const Step& s, int stride, const HGeo& g) {
  return s.t < g.khp * g.kwp ? step_from<COLS>(s.chunk, s.t, stride, g)
                             : step_from<COLS>(s.chunk + stride, 0, stride, g);
}

__device__ __forceinline__ int step_tap(const Step& s, int j) { return (s.taps >> (8 * j)) & 255; }

// The K split over a cluster of KS blocks (KS 1 or 2): rank 1 leaves its
// int32 sums in its shared memory (n per thread, thread-major, after the
// main loop is done with it), rank 0 adds them through distributed shared
// memory and alone goes on to the epilogue.  Returns whether this block
// stores the outputs.
template <int KS, int NT, int N>
__device__ __forceinline__ bool cluster_reduce(uint32_t (&acc)[N], int8_t* smem) {
  if constexpr (KS == 1) {
    return true;
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    uint32_t* red = reinterpret_cast<uint32_t*>(smem);
    const bool lead = cluster.block_rank() == 0;
    __syncthreads();
    if (!lead)
#pragma unroll
      for (int i = 0; i < N; ++i) red[i * NT + threadIdx.x] = acc[i];
    cluster.sync();
    if (lead) {
      const uint32_t* other = cluster.map_shared_rank(red, 1);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += other[i * NT + threadIdx.x];
    }
    cluster.sync();  // rank 1's shared memory lives until rank 0 has read it
    return lead;
  }
}

// How a 64-byte-deep tile (rows of 64 phase channels, four 16-byte segments)
// lies in shared memory:
//   ROWS  plain rows of `ld` bytes (K7);
//   CM    wgmma's no-swizzle core-matrix layout, 8 rows x 16 bytes per
//         128-byte core matrix, (r >> 3) * 512 + seg * 128 (K9; every
//         layout's weights for wgmma): LBO 128, SBO 512;
//   KSM   K-slice-major: for each segment, its `ld` rows contiguous at 16
//         bytes a row (K8, K10).  A core matrix that starts at any row r is
//         then 128 contiguous bytes, so a tap's A operand at a row shift is a
//         descriptor at window + 16 r: LBO 16 * ld, SBO 128.
enum TileLayout { ROWS, CM, KSM };

template <int LAY>
__device__ __forceinline__ int tile_off(int r, int seg, int ld) {
  if constexpr (LAY == CM) return (r >> 3) * 512 + seg * 128 + (r & 7) * 16;
  if constexpr (LAY == KSM) return (seg * ld + r) * 16;
  return r * ld + seg * 16;
}

// dst (tile layout LAY, `ld` as tile_off takes it) row r, r < rows = phase
// channels k0 .. k0 + 63 of frame row r0 + r; izp outside the image and on
// rows past the last image (no kept output reads them), anything past cs
// (their weights are zero).  NT threads; a thread's 16-byte segment
// (threadIdx.x & 3) is the same on every row, so its phase is worked out
// once per chunk.
template <int LAY, int NT>
__device__ void stage_window(int8_t* dst, int ld, const int8_t* __restrict__ x, int r0, int rows,
                             int k0, const HGeo& g) {
  const int seg = threadIdx.x & 3, c = k0 + seg * 16;
  const uint4 fill = make_uint4(g.izp4, g.izp4, g.izp4, g.izp4);
  const bool live = c < g.cs;
  if (g.a_vec) {  // the 16 channels lie in one phase
    const PhaseCh pc = phase_ch(live ? c : 0, g);
    for (int r = threadIdx.x >> 2; r < rows; r += NT / 4) {
      int8_t* d = dst + tile_off<LAY>(r, seg, ld);
      const int row = r0 + r;
      if (live && row < g.mo) {
        const FrameRow f = frame_row(row, g);
        const int iy = f.i * g.sh + pc.p - g.pt, ix = f.j * g.sw + pc.q - g.pl;
        if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w) {
          cp_async16(d, x + (((long long)f.img * g.h + iy) * g.w + ix) * g.cin + pc.ci, true);
          continue;
        }
      }
      *reinterpret_cast<uint4*>(d) = fill;
    }
    return;
  }
  // a narrow or ragged CIN: byte loads, the phase advanced channel by channel
  const PhaseCh pc0 = phase_ch(live ? c : 0, g);
  for (int r = threadIdx.x >> 2; r < rows; r += NT / 4) {
    int8_t* d = dst + tile_off<LAY>(r, seg, ld);
    const int row = r0 + r;
    if (!live || row >= g.mo) {
      *reinterpret_cast<uint4*>(d) = fill;
      continue;
    }
    const FrameRow f = frame_row(row, g);
    uint32_t v[4] = {0, 0, 0, 0};
    int p = pc0.p, q = pc0.q, ci = pc0.ci;
#pragma unroll
    for (int b = 0; b < 16; ++b) {  // unrolled: v stays in registers
      if (c + b >= g.cs) break;
      const int iy = f.i * g.sh + p - g.pt, ix = f.j * g.sw + q - g.pl;
      const uint32_t byte =
          (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w
              ? (uint8_t)x[(((long long)f.img * g.h + iy) * g.w + ix) * g.cin + ci]
              : g.izp4 & 0xffu;
      v[b >> 2] |= byte << (8 * (b & 3));
      if (++ci == g.cin) {  // the next phase (p, q), q fastest
        ci = 0;
        if (++q == g.sw) {
          q = 0;
          ++p;
        }
      }
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// dst rows tl*BN + n, tl < s.g, n < BN (tile layout LAY, plain rows of
// `ld` bytes for ROWS): the weights of the step's tap tl, column n0 + n,
// phase channels k0 .. k0 + 63, from wk (KH, KW, COUT, CIN); zero where the
// phase has no such tap, past cs or past COUT.  NT threads, NT / 4 dividing
// BN: a thread keeps its segment, and each tap's weight offset is worked out
// once per step.
template <int LAY, int BN, int NT>
__device__ void stage_weights(int8_t* dst, int ld, const int8_t* __restrict__ wk, const Step& s,
                              int n0, const HGeo& g) {
  static_assert(BN % (NT / 4) == 0, "a thread's segment must be the same on every row");
  const int seg = threadIdx.x & 3, c = s.chunk * KC + seg * 16;
  const bool live = c < g.cs;
  const PhaseCh pc = phase_ch(live ? c : 0, g);
#pragma unroll
  for (int tl = 0; tl < GMAX; ++tl) {
    if (tl >= s.g) break;
    const int t = step_tap(s, tl);
    const int a = g.by_kwp.div(t), b = t - a * g.kwp;
    if (g.b_vec) {
      const int ky = a * g.sh + pc.p, kx = b * g.sw + pc.q;
      const bool tap_ok = live && ky < g.kh && kx < g.kw;
      const int8_t* src = wk + ((long long)ky * g.kw + kx) * g.cout * g.cin + pc.ci;
      for (int n = threadIdx.x >> 2; n < BN; n += NT / 4) {
        const int co = n0 + n;
        const bool ok = tap_ok && co < g.cout;
        cp_async16(dst + tile_off<LAY>(tl * BN + n, seg, ld), ok ? src + (long long)co * g.cin : wk,
                   ok);
      }
      continue;
    }
    for (int n = threadIdx.x >> 2; n < BN; n += NT / 4) {
      const int co = n0 + n;
      uint32_t v[4] = {0, 0, 0, 0};
      int p = pc.p, q = pc.q, ci = pc.ci;
#pragma unroll
      for (int bb = 0; bb < 16; ++bb) {
        if (!live || co >= g.cout || c + bb >= g.cs) break;
        const int ky = a * g.sh + p, kx = b * g.sw + q;
        if (ky < g.kh && kx < g.kw)
          v[bb >> 2] |=
              (uint32_t)(uint8_t)wk[(((long long)ky * g.kw + kx) * g.cout + co) * g.cin + ci]
              << (8 * (bb & 3));
        if (++ci == g.cin) {
          ci = 0;
          if (++q == g.sw) {
            q = 0;
            ++p;
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + tile_off<LAY>(tl * BN + n, seg, ld)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Writes after the last wait of this thread, in the generic proxy, made
// visible to wgmma's async proxy (each thread, before the barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Where over-wide output row m's outputs start in (N, OH, OW, COUT); -1 for
// a row that is no real output.
__device__ __forceinline__ long long out_index(int m, const HGeo& g) {
  if (m >= g.mo) return -1;
  const FrameRow f = frame_row(m, g);
  if (f.i >= g.oh || f.j >= g.ow) return -1;
  return (((long long)f.img * g.oh + f.i) * g.ow + f.j) * g.cout;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The no-swizzle shared-memory descriptor of a K-major operand at `smem`
// (16-byte aligned): LBO bytes to the next 16-byte K slice, SBO bytes to the
// next 8 rows.
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x BN, int32) += A (64 x 32 bytes) . B (BN x 32 bytes)^T, both from
// shared memory by descriptor.
template <int BN>
__device__ __forceinline__ void wgmma_acc(int32_t (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_acc<64>(int32_t (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_acc<128>(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// tap_live on the host.
inline bool host_tap_live(int t, int k0, const HGeo& g) {
  const int a = t / g.kwp, b = t % g.kwp;
  for (int ph = k0 / g.cin; ph <= (std::min(k0 + KC, g.cs) - 1) / g.cin; ++ph)
    if (a * g.sh + ph / g.sw < g.kh && b * g.sw + ph % g.sw < g.kw) return true;
  return false;
}

// The live (chunk, tap) products of a launch, and its steps at `group` taps
// a step (step_from's walk on the host; `cols` keeps a step in one column).
inline long long host_taps(const HGeo& g) {
  long long n = 0;
  for (int c = 0; c < g.nchunks; ++c)
    for (int t = 0; t < g.khp * g.kwp; ++t) n += host_tap_live(t, c * KC, g);
  return n;
}
inline long long host_steps(int group, bool cols, const HGeo& g) {
  long long n = 0;
  for (int c = 0; c < g.nchunks; ++c) {
    if (!cols) {
      int live = 0;
      for (int t = 0; t < g.khp * g.kwp; ++t) live += host_tap_live(t, c * KC, g);
      n += (live + group - 1) / group;
      continue;
    }
    for (int b = 0; b < g.kwp; ++b) {
      int live = 0;
      for (int a = 0; a < g.khp; ++a) live += host_tap_live(a * g.kwp + b, c * KC, g);
      n += (live + group - 1) / group;
    }
  }
  return n;
}

struct Plan {
  int group;
  bool split;
  size_t smem;
};

// Picks the live taps per step (up to the wrapper's g.group, the most that
// fit 227 KB) and whether to split K over a cluster of two blocks, from a
// cost model fitted on the H100 (a sweep of K9's groups and tiles): a block's time is its
// steps plus twice its tap products (a step's fixed cost is about half a
// tap's), times the waves of blocks.  A smaller group spends fewer bytes, so
// more blocks share an SM (the occupancy API says how many); K is split
// where twice the tiles fit the card at once, a block has two chunks or
// more, and rank 1's sums (BM * BN int32) fit its shared memory.  kern1 and
// kern2 are the kernel unsplit and split, `smem_of(group)` its dynamic
// shared memory, `sms` the caller's once-per-kernel cache of the SM count.
template <class SmemOf>
int plan_launch(const void* kern1, const void* kern2, int threads, int bm, int bn, bool cols,
                const HGeo& g, SmemOf smem_of, int& sms, Plan& plan) {
  if (sms == 0) {  // once per kernel: the SM count, the shared memory ceiling
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kern1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_LIMIT) != cudaSuccess ||
        cudaFuncSetAttribute(kern2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_LIMIT) != cudaSuccess)
      return (int)cudaGetLastError();
    sms = n;
  }
  const long long taps = host_taps(g);
  const long long tiles = (long long)((g.mo + bm - 1) / bm) * ((g.cout + bn - 1) / bn);
  double best = 0.0;
  plan = Plan{0, false, 0};
  for (int grp = 1; grp <= g.group; ++grp) {
    const size_t smem = smem_of(grp);
    if (smem > SMEM_LIMIT) break;
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern2, threads, smem) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    const long long slots = (long long)sms * per_sm;
    if (slots <= 0) continue;
    const bool split = g.nchunks >= 2 && 2 * tiles <= slots && (size_t)bm * bn * 4 <= smem;
    const long long blocks = split ? 2 * tiles : tiles;
    const double cost = (double)((blocks + slots - 1) / slots) *
                        (double)(host_steps(grp, cols, g) + 2 * taps) / (split ? 2 : 1);
    if (plan.group == 0 || cost <= best) {  // a tie goes to the larger group
      best = cost;
      plan = Plan{grp, split, smem};
    }
  }
  return plan.group == 0 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// Launches kern on a grid of (M tiles, N tiles, ks), the ks blocks along z
// one cluster (ks 1 or 2), and returns cudaGetLastError().
template <class... Params, class... Args>
int launch_cluster(void (*kern)(Params...), int ks, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = ks;
  cfg.attrs = cluster;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  if (cudaLaunchKernelEx(&cfg, kern, args...) != cudaSuccess) return (int)cudaGetLastError();
  return (int)cudaGetLastError();
}

}  // namespace hop
}  // namespace tk
