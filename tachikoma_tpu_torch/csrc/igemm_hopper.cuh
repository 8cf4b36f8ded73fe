// The implicit-GEMM body on Hopper's wgmma that the tiled paths of K1 and of
// K4's GEMM mode (qgemm_rq.cu), K2, K3 and K4's conv mode
// (qconv_igemm_hopper.cu) launch:
// persistent blocks over (M tile, N tile) items, a cp.async ring across
// them, three epilogues (Mode), the exact split of K.  The design and its
// measurements are in qconv_igemm_hopper.cu's notes.
//
// Legacy uint8 models (K1, K2, K4; not K3): the A operand may be uint8,
// read as wgmma's .u8 operand (a_u8), and the weights may have a zero point
// kzp[n] (a scalar arrives as a vector).  With the padding filled by izp,
//   sum (x - izp)(w - kzp) = sum (x - izp) w - kzp[n] S[m],
//   S[m] = rowsum(A_pad)[m] - K izp,
// and the wrapper folds -izp colsum(w) + K izp kzp[n] into the bias
// (matmul_int8.py fold_input_zero_point), so the kernel takes kzp[n] times
// the row sums of the A tiles it staged off each sum: the row sums come from
// one more wgmma a step, m64n8k32 against 8 rows of ones in shared memory,
// whose fragment holds a row's sum at the rows of the product's.  A split of
// K takes off its own steps' part, so the splits' sums add to the whole in
// int32 wraparound, as the oracle's int32 does.  uint8 weights arrive as
// int8 (w - 128, kzp - 128: the same differences), packed once.  These
// calls run an instantiation of their own (LEG), so the int8 body's wgmma
// loop stays as it was.
#pragma once

#include "epilogue_hopper.cuh"
#include "layouts_hopper.cuh"

namespace tk {
namespace igemm {

using hop::cp_async16;
using hop::cp_async_commit;
using hop::cp_async_wait_upto;
using hop::fence_proxy_async;
using hop::gmma_desc;
using hop::wgmma_acc;
using hop::wgmma_commit;
using hop::wgmma_fence;
using hop::wgmma_wait0;

constexpr int KSTEP = 64;  // bytes of K per step

// 8 bytes from global to shared memory, zeros where !valid (.ca: the only
// cp.async class that takes 8 bytes).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 8 : 0));
}
constexpr int RPAD = 16;   // bytes of padding per row of the staged output tile

// The epilogue of a launch: K4's raw int32 store (both modes), K2's and K1's
// requantize, K3's requantize and residual add.
enum Mode { RAW, RQ, RES };

struct Geo {
  int n, h, w, cin, kh, kw, cout, oh, ow, sh, sw, pt, pl;
  int dh, dw;  // the dilation: tap (ky, kx) reads input row oy*sh - pt + ky*dh
  // a grouped conv runs as one dense conv a super-group of its groups, whose
  // weights the wrapper expands block-diagonally: an N tile of the super-group
  // n0 / nspan reads the cspan input channels from (n0 / nspan) * cspan on,
  // and K = KH * KW * cspan (a dense conv: cspan = CIN, nspan = COUT)
  int cspan, nspan;
  int M, K, steps, kper;  // steps = Kp / 64; a split walks kper of them
  int m_tiles, n_tiles, gm;  // a block walks M tiles mb, mb + gm, ... of one N tile
  // dynamic shared memory: the ring (STAGES x stage_bytes), then from off_b
  // the resident weights (b_res), the column constants (K4: the bias), the tables (K3),
  // the staged tiles (K2, K3) and K2's arrival flag; smem bytes in all
  int stage_bytes, off_b, off_cols, off_tables, off_rtile, off_flag, smem;
  bool b_res;  // the block's weights (every step of its N tile) staged once
  uint32_t izp4;
  bool a_vec;   // CIN % 16 == 0 and x 16-byte aligned
  bool a_vec8;  // K1's GEMM (1x1): CIN % 16 == 8 and x 8-byte aligned, 8-byte copies
  bool o_vec;  // K2, K3: COUT % 16 == 0, out (and K3's residual) 16-byte aligned
  bool a_u8;   // x is uint8 (wgmma's .u8 A operand; K1, K2, K4)
  bool kzp;    // the weights have a zero point: kzp[n] times the row sums taken off
  int off_ones, off_kzp;  // kzp: 512 bytes of ones (the row sums' B), kzp of the N tile
  hop::FastDiv by_ohow, by_ow;
};

// The block-uniform epilogue constants; K3's tables are built from them.
struct Epi {
  epi::RqConst rq;
  int32_t rq_izp;
  bool l_skip, r_skip, add_tonearest;
  int32_t lm, ls, lzp, rm, rs, rzp, zo, lo, hi;
};

__device__ __forceinline__ int cm_off(int r, int seg) {
  return (r >> 3) * 512 + seg * 128 + (r & 7) * 16;
}

// One side of the residual add at int8 value v (requantize.cuh's
// q_multiply_shift, as plan_res_add plans it).
__device__ __forceinline__ int32_t res_side(int32_t v, bool skip, int32_t m, int32_t s,
                                            int32_t zp, const Epi& e) {
  return skip ? v : wrap_add(q_multiply_shift(wrap_sub(v, zp), m, s, e.add_tonearest), e.zo);
}

constexpr int BRES_STEPS = 2;  // K3 keeps its block's weights resident up to this many steps

template <int MODE, int BM, int BN>
struct Tiles {
  static constexpr int NT = 2 * BM;                        // a warpgroup per 64 rows
  static constexpr int STAGES = MODE == RES ? 3 : 4;       // the cp.async ring
  static constexpr int AHEAD = MODE == RES ? 1 : STAGES - 1;  // items the copies run ahead
  // staged output tiles: K3 one per item in flight (its residual lands
  // there), K2 one
  static constexpr int RSLOTS = MODE == RES ? AHEAD + 1 : MODE == RQ ? 1 : 0;
  static constexpr int RS = BN + RPAD;                     // staged tile row stride
};

// The shared-memory layout of a launch (Geo's offsets).  K3 keeps its
// block's weights resident when K has at most BRES_STEPS steps: its items
// all read the same N tile's K range, so the ring then carries A alone and
// a block holds less.  With more steps the resident copy delays the first
// product (the 14^2 calls of ResNet-50 b8 ran 8% slower so, on the H100).
template <int MODE, int BM, int BN>
void smem_layout(Geo& g) {
  using T = Tiles<MODE, BM, BN>;
  g.b_res = MODE == RES && g.steps <= BRES_STEPS;
  g.stage_bytes = (BM + (g.b_res ? 0 : BN)) * KSTEP;
  g.off_b = T::STAGES * g.stage_bytes;
  g.off_cols = g.off_b + (g.b_res ? g.steps * BN * KSTEP : 0);
  g.off_tables = g.off_cols + (MODE != RAW ? BN * 16 : BN * 4);
  g.off_rtile = g.off_tables + (MODE == RES ? 2 * 256 * 4 : 0);
  g.off_flag = g.off_rtile + T::RSLOTS * BM * T::RS;
  g.off_ones = g.off_flag + (MODE == RQ ? 16 : 0);
  g.off_kzp = g.off_ones + (g.kzp ? 512 : 0);
  g.smem = g.off_kzp + (g.kzp ? BN * 4 : 0);
}

// d (64 x BN, int32) += A (64 x 32 bytes, uint8) . B (BN x 32 bytes, int8)^T
// (hop::wgmma_acc with a .u8 A operand); BN 8 is the row sums' product.
#define TK_WGMMA_U8(N, REGS, ...)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #REGS ", 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.u8.s8 " __VA_ARGS__)
template <int BN>
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[BN / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_u8<8>(int32_t (&d)[4], uint64_t da, uint64_t db) {
  TK_WGMMA_U8(8, 6, "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
              : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
              : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_u8<64>(int32_t (&d)[32], uint64_t da, uint64_t db) {
  TK_WGMMA_U8(64, 34,
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
__device__ __forceinline__ void wgmma_u8<128>(int32_t (&d)[64], uint64_t da, uint64_t db) {
  TK_WGMMA_U8(128, 66,
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
#undef TK_WGMMA_U8

// d (64 x 8) += A (64 x 32 bytes, int8) . ones: the row sums' product on int8 A.
__device__ __forceinline__ void wgmma_s8_n8(int32_t (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// A block of the grid (x: N tile + n_tiles * mb, z: split of K) walks the M
// tiles mb, mb + gm, ... of its N tile, one item each, and the steps of its
// split in each.  The copies run as one stream of stages over the items: up
// to STAGES - 1 stages ahead of the products, and up to AHEAD items ahead,
// so that the next items' copies (and K3's next residual tiles) are in
// flight while this item's epilogue runs.  `ws` is K2's split workspace.
template <int MODE, int BM, int BN, bool LEG = false>
__global__ void __launch_bounds__(2 * BM)
    igemm_hopper(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                 void* __restrict__ out, const int8_t* __restrict__ residual,
                 const int32_t* __restrict__ bias, const int32_t* __restrict__ mult,
                 const int32_t* __restrict__ shift, int32_t* __restrict__ ws,
                 const int32_t* __restrict__ kzp, Epi e, Geo g) {
  using S = Tiles<MODE, BM, BN>;
  constexpr int NT = S::NT, ST = S::STAGES;
  constexpr bool RES_ = MODE == RES;
  constexpr int A_PER = BM * 4 / NT;  // rows a thread stages: 2
  constexpr int B_PER = BN * 4 / NT;  // weight rows a thread stages: 1, 2 or 4
  // no static shared memory: the launch grants the dynamic the whole 227 KB
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x, seg = tid & 3;
  const int nt_idx = blockIdx.x % g.n_tiles;
  const int n0 = nt_idx * BN, mb = blockIdx.x / g.n_tiles;
  const int c0 = n0 / g.nspan * g.cspan;  // the first input channel the N tile reads
  const int n_items = mb < g.m_tiles ? (g.m_tiles - 1 - mb) / g.gm + 1 : 0;
  const int kbeg = blockIdx.z * g.kper;
  const int nst = min(g.steps, kbeg + g.kper) - kbeg;  // steps per item
  // the (ky, kx, ci) of this thread's segment at step kbeg
  int ky0, kx0, ci0;
  {
    const int k = kbeg * KSTEP + seg * 16;
    const int tap = k / g.cspan;
    ci0 = k - tap * g.cspan;
    ky0 = tap / g.kw;
    kx0 = tap - ky0 * g.kw;
  }
  const uint4 fill = make_uint4(g.izp4, g.izp4, g.izp4, g.izp4);
  int8_t* const bres = smem + g.off_b;
  int4* const colc = reinterpret_cast<int4*>(smem + g.off_cols);
  int32_t* const colb = reinterpret_cast<int32_t*>(smem + g.off_cols);  // K4's bias
  int32_t* const tl = reinterpret_cast<int32_t*>(smem + g.off_tables);
  int32_t* const tr = tl + 256;
  int8_t* const rt = smem + g.off_rtile;
  int* const s_last = reinterpret_cast<int*>(smem + g.off_flag);  // K2's split: arrived last
  int8_t* const ones = smem + g.off_ones;                            // kzp: the row sums' B
  int32_t* const kz = reinterpret_cast<int32_t*>(smem + g.off_kzp);  // kzp: the N tile's
  constexpr bool LEGACY = LEG && MODE != RES;  // uint8 A or kzp: K1, K2, K4

  // the producer: the item and step it stages next, its rows, its segment's
  // (ky, kx, ci)
  long long a_base[A_PER];
  int a_iy[A_PER], a_ix[A_PER];
  bool a_ok[A_PER];
  int ky = ky0, kx = kx0, ci = ci0;
  int p_item = 0, p_step = 0, issued = 0;

  auto begin_conv = [&](int item) {
    const int m0 = (mb + item * g.gm) * BM;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int m = m0 + (tid >> 2) + j * (NT / 4);
      a_ok[j] = m < g.M;
      const int mm = a_ok[j] ? m : 0;
      const int img = g.by_ohow.div(mm), rem = mm - img * (g.oh * g.ow);
      const int oy = g.by_ow.div(rem), ox = rem - oy * g.ow;
      a_base[j] = (long long)img * g.h * g.w * g.cin + c0;
      a_iy[j] = oy * g.sh - g.pt;
      a_ix[j] = ox * g.sw - g.pl;
    }
    ky = ky0;
    kx = kx0;
    ci = ci0;
    if constexpr (RES_) {
      if (g.o_vec) {  // the item's residual tile, with its first stage's copies
        int8_t* const rtile = rt + (item % S::RSLOTS) * BM * S::RS;
        for (int i = tid; i < BM * (BN / 16); i += NT) {
          const int r = i / (BN / 16), c = 16 * (i % (BN / 16));
          const int row = m0 + r, col = n0 + c;
          const bool ok = row < g.M && col < g.cout;
          cp_async16(rtile + r * S::RS + c,
                     ok ? residual + (long long)row * g.cout + col : residual, ok);
        }
      }
    }
  };

  // K2's copies are cached in L1 too (its 3x3 calls read each input row at
  // three taps, its blocks on an SM share the weights); K3's and K4's stay
  // in L2 alone, as measured in their redesign
  auto copy16 = [](void* d, const void* src, bool ok) {
    if constexpr (MODE == RQ)
      hop::cp_async16_ca(d, src, ok);
    else
      cp_async16(d, src, ok);
  };

  auto stage_b = [&](int8_t* bs, int kstep) {  // the N tile's weights at step kstep
    const int8_t* const wb = wk + ((long long)kstep * g.cout + n0) * KSTEP + seg * 16;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int r = (tid >> 2) + j * (NT / 4);
      const bool ok = n0 + r < g.cout;
      copy16(bs + cm_off(r, seg), ok ? wb + r * KSTEP : wk, ok);
    }
  };

  auto stage_conv = [&](int slot, int kstep) {  // step kstep of the producer's item
    int8_t* const as = smem + slot * g.stage_bytes;
    int8_t* const bs = as + BM * KSTEP;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      int8_t* d = as + cm_off((tid >> 2) + j * (NT / 4), seg);
      if (g.a_vec || g.a_vec8) {
        const int iy = a_iy[j] + ky * g.dh, ix = a_ix[j] + kx * g.dw;
        if (!a_ok[j] || ky >= g.kh) {
          copy16(d, x, false);  // past K (zero weights) or past M (not stored)
        } else if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w) {
          const int8_t* const src = x + a_base[j] + ((long long)iy * g.w + ix) * g.cin + ci;
          if (g.a_vec) {
            copy16(d, src, true);
          } else {  // a 1x1 conv's segment: its second half may lie past K (zeros)
            cp_async8(d, src, true);
            cp_async8(d + 8, ci + 8 < g.cspan ? src + 8 : x, ci + 8 < g.cspan);
          }
        } else {
          *reinterpret_cast<uint4*>(d) = fill;
        }
        continue;
      }
      uint32_t v[4] = {0, 0, 0, 0};
      if (a_ok[j]) {
        int cy = ky, cx = kx, cc = ci;
#pragma unroll
        for (int b = 0; b < 16; ++b) {  // unrolled: v stays in registers
          if (cy >= g.kh) break;
          const int iy = a_iy[j] + cy * g.dh, ix = a_ix[j] + cx * g.dw;
          const uint32_t byte =
              (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w
                  ? (uint8_t)x[a_base[j] + ((long long)iy * g.w + ix) * g.cin + cc]
                  : g.izp4 & 0xffu;
          v[b >> 2] |= byte << (8 * (b & 3));
          if (++cc == g.cspan) {
            cc = 0;
            if (++cx == g.kw) {
              cx = 0;
              ++cy;
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (!g.b_res) stage_b(bs, kstep);
    // the next step: 64 bytes on
    ci += KSTEP;
    while (ci >= g.cspan && ky < g.kh) {
      ci -= g.cspan;
      if (++kx == g.kw) {
        kx = 0;
        ++ky;
      }
    }
  };

  // issues stages while the ring has room, up to AHEAD items ahead of c_item
  auto produce = [&](int consumed, int c_item) {
    while (issued - consumed < ST - 1 && p_item < n_items && p_item <= c_item + S::AHEAD) {
      if (p_step == 0) begin_conv(p_item);
      stage_conv(issued % ST, kbeg + p_step);
      cp_async_commit();
      ++issued;
      if (++p_step == nst) {
        p_step = 0;
        ++p_item;
      }
    }
  };

  if (g.b_res)  // every step of the block's weights, with the first stage's copies
    for (int st = 0; st < g.steps; ++st) stage_b(bres + st * BN * KSTEP, st);
  produce(0, 0);
  // column constants (and the add's tables; K4's bias, zero on the splits
  // past the first), while the copies fly
  if constexpr (MODE != RAW)
    epi::load_cols(colc, BN, n0, g.cout, bias, mult, shift, e.rq_izp);
  else
    for (int i = tid; i < BN; i += NT)
      colb[i] = blockIdx.z == 0 && n0 + i < g.cout ? bias[n0 + i] : 0;
  if (LEGACY && g.kzp) {  // read by the first step's wgmma, after its fence and barrier
    for (int i = tid; i < 128; i += NT) reinterpret_cast<uint32_t*>(ones)[i] = 0x01010101u;
    for (int i = tid; i < BN; i += NT) kz[i] = n0 + i < g.cout ? kzp[n0 + i] : 0;
  }
  if constexpr (RES_) {
    for (int i = tid; i < 512; i += NT) {
      const int32_t v = (int8_t)(i & 255);
      if (i < 256)
        tl[i] = res_side(v, e.l_skip, e.lm, e.ls, e.lzp, e);
      else
        tr[i - 256] = wrap_sub(res_side(v, e.r_skip, e.rm, e.rs, e.rzp, e), e.zo);
    }
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // fragment: acc[4 jb + e] is row 16 warp + lane / 4 + 8 (e >> 1) of the
  // warpgroup's 64, column 8 jb + 2 (lane % 4) + (e & 1)
  const int rl0 = wg * 64 + 16 * warp + (lane >> 2);
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int32_t rsum[4] = {0, 0, 0, 0};  // kzp: the staged rows' sums (rows rl0, rl0 + 8 in 0, 2)
  int consumed = 0, c_item = 0, c_step = 0;
  while (c_item < n_items) {
    produce(consumed, c_item);
    cp_async_wait_upto(issued - consumed - 1);
    fence_proxy_async();
    __syncthreads();
    const int8_t* const as = smem + (consumed % ST) * g.stage_bytes;
    const int8_t* const bs = g.b_res ? bres + c_step * BN * KSTEP : as + BM * KSTEP;
    wgmma_fence();
    if constexpr (LEGACY) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t da = gmma_desc(as + wg * 4096 + kk * 256, 128, 512);
        const uint64_t d1 = gmma_desc(ones + kk * 256, 128, 512);
        if (g.a_u8) {
          wgmma_u8<BN>(acc, da, gmma_desc(bs + kk * 256, 128, 512));
          if (g.kzp) wgmma_u8<8>(rsum, da, d1);
        } else {
          wgmma_acc<BN>(acc, da, gmma_desc(bs + kk * 256, 128, 512));
          if (g.kzp) wgmma_s8_n8(rsum, da, d1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_acc<BN>(acc, gmma_desc(as + wg * 4096 + kk * 256, 128, 512),
                      gmma_desc(bs + kk * 256, 128, 512));
    }
    wgmma_commit();
    wgmma_wait0();
    ++consumed;
    if (++c_step < nst) continue;

    if (LEGACY && g.kzp) {  // this split's part of -kzp[n] S[m], in int32 wraparound
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int cl = 8 * jb + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * jb + i] =
              wrap_sub(acc[4 * jb + i], (int32_t)((uint32_t)kz[cl + (i & 1)] *
                                                  (uint32_t)rsum[i & 2]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) rsum[i] = 0;
    }

    // the epilogue of item c_item
    const int mt_idx = mb + c_item * g.gm, m0 = mt_idx * BM;
    bool run_epilogue = true;
    if constexpr (MODE == RQ) {
      if (gridDim.z > 1) {  // a split: add into the workspace; the last block on
        int32_t* const cnt = ws + (long long)g.M * g.cout;
#pragma unroll
        for (int jb = 0; jb < BN / 8; ++jb) {
          const int col = n0 + 8 * jb + 2 * (lane & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + rl0 + 8 * h;
            if (row >= g.M) continue;
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1)
              if (col + e1 < g.cout)  // int32 atomics wrap: the same sum in any order
                atomicAdd(ws + (long long)row * g.cout + col + e1, acc[4 * jb + 2 * h + e1]);
          }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0)
          *s_last = atomicAdd(cnt + mt_idx * g.n_tiles + nt_idx, 1) == (int)gridDim.z - 1;
        __syncthreads();
        run_epilogue = *s_last != 0;
        if (run_epilogue) {  // every other split's adds are done: read the total
          __threadfence();
#pragma unroll
          for (int jb = 0; jb < BN / 8; ++jb) {
            const int col = n0 + 8 * jb + 2 * (lane & 3);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = m0 + rl0 + 8 * h;
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1)
                acc[4 * jb + 2 * h + e1] =
                    row < g.M && col + e1 < g.cout
                        ? __ldcg(ws + (long long)row * g.cout + col + e1)
                        : 0;
            }
          }
        }
      }
    }
    if constexpr (MODE != RAW) {
      int8_t* const o8 = static_cast<int8_t*>(out);
      auto dst = [&](int r) -> long long {
        const int row = m0 + r;
        return row < g.M ? (long long)row * g.cout + n0 : -1;
      };
      if (run_epilogue && g.o_vec) {
        int8_t* const rtile = rt + (RES_ ? (c_item % S::RSLOTS) * BM * S::RS : 0);
        if constexpr (RES_) {  // the residual tile landed with the item's first stage
          epi::stage_fragment<BN>(rtile, S::RS, rl0, acc, colc, e.rq,
                                  [&](int32_t q0, int32_t q1, uint16_t rr) {
                                    const int32_t o0 =
                                        min(max(wrap_add(tl[q0 & 255], tr[rr & 255]), e.lo), e.hi);
                                    const int32_t o1 =
                                        min(max(wrap_add(tl[q1 & 255], tr[rr >> 8]), e.lo), e.hi);
                                    return (uint16_t)((o0 & 255) | (o1 & 255) << 8);
                                  });
        } else {
          epi::stage_fragment<BN>(rtile, S::RS, rl0, acc, colc, e.rq, epi::PackPair{});
        }
        __syncthreads();
        epi::store_tile16(o8, rtile, S::RS, BM, min(BN, g.cout - n0), dst);
        // K3's tile is free for item c_item + RSLOTS after this barrier; K2's
        // next write to its one tile follows a barrier of the next item's
        // main loop
        if constexpr (RES_) __syncthreads();
      } else if (run_epilogue) {
#pragma unroll
        for (int jb = 0; jb < BN / 8; ++jb) {
          const int cl = 8 * jb + 2 * (lane & 3);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + rl0 + 8 * h;
            if (row >= g.M) continue;
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const int col = n0 + cl + e1;
              if (col >= g.cout) continue;
              const long long o = (long long)row * g.cout + col;
              int32_t q = epi::requant_wide(acc[4 * jb + 2 * h + e1], colc[cl + e1], e.rq);
              if constexpr (RES_)
                q = min(max(wrap_add(tl[q & 255], tr[(uint8_t)residual[o]]), e.lo), e.hi);
              o8[o] = (int8_t)q;
            }
          }
        }
      }
    } else {
      int32_t* const o32 = static_cast<int32_t*>(out);
      const bool split = gridDim.z > 1;
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int cl = 8 * jb + 2 * (lane & 3), col = n0 + cl;
        if (col >= g.cout) continue;
        const bool pair = col + 1 < g.cout;
        const int32_t b0 = colb[cl], b1 = colb[cl + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + rl0 + 8 * h;
          if (row >= g.M) continue;
          int32_t* p = o32 + (long long)row * g.cout + col;
          const int32_t v0 = wrap_add(acc[4 * jb + 2 * h], b0);
          const int32_t v1 = wrap_add(acc[4 * jb + 2 * h + 1], b1);
          if (split) {  // int32 atomics wrap: the same sum in any order
            atomicAdd(p, v0);
            if (pair) atomicAdd(p + 1, v1);
          } else if (pair && (g.cout & 1) == 0) {
            *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
          } else {
            p[0] = v0;
            if (pair) p[1] = v1;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    c_step = 0;
    ++c_item;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

inline bool make_geo(const int32_t* p, Geo& g) {
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
  g.dh = p[P_DH] ? p[P_DH] : 1;
  g.dw = p[P_DW] ? p[P_DW] : 1;
  g.cspan = p[P_CSPAN] ? p[P_CSPAN] : g.cin;
  if (g.cin <= 0 || g.kh <= 0 || g.kw <= 0 || g.sh <= 0 || g.sw <= 0 || g.dh <= 0 ||
      g.dw <= 0 || g.cspan <= 0 || g.cin % g.cspan != 0 ||
      (long long)g.cout * g.cspan % g.cin != 0)
    return false;
  g.nspan = (int)((long long)g.cout * g.cspan / g.cin);
  if (g.nspan <= 0) g.nspan = 1;  // COUT 0: no tile
  g.M = g.n * g.oh * g.ow;
  g.K = g.kh * g.kw * g.cspan;
  g.steps = (g.K + KSTEP - 1) / KSTEP;
  g.kper = p[P_KPER];
  g.izp4 = (uint32_t)(uint8_t)(int8_t)p[P_IZP] * 0x01010101u;
  g.a_vec = p[P_A_VEC] != 0 && g.cin % 16 == 0 && g.cspan % 16 == 0;
  g.a_vec8 = false;
  g.o_vec = false;
  g.a_u8 = p[P_A_U8] != 0;
  g.kzp = false;  // the entry sets it with its kzp vector
  g.off_ones = g.off_kzp = 0;
  return true;
}

inline Epi make_epi(const int32_t* p) {
  Epi e{};
  e.rq = epi::RqConst{p[P_OUT_ZP], p[P_QMIN], p[P_QMAX], p[P_TONEAREST] != 0};
  e.rq_izp = p[P_RQ_IZP];
  return e;
}

// Whether a split of ks ways, kper steps each, covers the steps with every
// split non-empty.
inline bool split_ok(int ks, const Geo& g) {
  return ks >= 1 && g.kper >= 1 && (long long)ks * g.kper >= g.steps &&
         (ks - 1) * g.kper < g.steps;
}

// Launches the kernel over a grid of (N tiles x gm, 1, ks): gm M-tile lanes,
// each block walking every gm-th M tile of its N tile, with gm as large as
// the card holds blocks at once (the occupancy API, once per kernel and
// shared-memory size) and at most the M tiles.
template <int MODE, int BM, int BN, bool LEG = false>
int launch_tile(const int8_t* x, const int8_t* wk, void* out, const int8_t* residual,
                const int32_t* bias, const int32_t* mult, const int32_t* shift, int32_t* ws,
                const int32_t* kzp, const Epi& e, Geo g, int ks, cudaStream_t stream) {
  using T = Tiles<MODE, BM, BN>;
  if constexpr (MODE != RES && !LEG) {  // uint8 A or kzp: the instantiation that takes them
    if (g.a_u8 || kzp != nullptr)
      return launch_tile<MODE, BM, BN, true>(x, wk, out, residual, bias, mult, shift, ws, kzp,
                                             e, g, ks, stream);
  }
  auto kern = igemm_hopper<MODE, BM, BN, LEG>;
  static int sms = 0;  // once per kernel: the SM count, the shared memory ceiling
  static int occ_smem[8], occ_blocks[8], n_occ = 0;  // blocks an SM, by shared memory
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hop::SMEM_LIMIT) != cudaSuccess)
      return (int)cudaGetLastError();
    sms = n;
  }
  g.kzp = LEG && kzp != nullptr;
  if (MODE == RES && g.a_u8) return (int)cudaErrorInvalidValue;
  smem_layout<MODE, BM, BN>(g);
  if (g.smem > (int)hop::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // an N tile lies inside one super-group
  if (g.nspan != g.cout && g.nspan % BN != 0) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  for (int i = 0; i < n_occ; ++i)
    if (occ_smem[i] == g.smem) per_sm = occ_blocks[i];
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T::NT, g.smem) !=
        cudaSuccess)
      return (int)cudaGetLastError();
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (n_occ < 8) {
      occ_smem[n_occ] = g.smem;
      occ_blocks[n_occ++] = per_sm;
    }
  }
  g.m_tiles = (g.M + BM - 1) / BM;
  g.n_tiles = (g.cout + BN - 1) / BN;
  g.gm = std::max(1, std::min(g.m_tiles, sms * per_sm / (g.n_tiles * ks)));
  g.by_ohow = hop::FastDiv::make(g.oh * g.ow);
  g.by_ow = hop::FastDiv::make(g.ow);
  const dim3 grid(g.n_tiles * g.gm, 1, ks);
  kern<<<grid, T::NT, g.smem, stream>>>(x, wk, out, residual, bias, mult, shift, ws, kzp, e, g);
  return (int)cudaGetLastError();
}

// Launches MODE (K1's tiled path and K2 in RQ, K3, K4's GEMM mode in RAW)
// at the tile (P_BM, P_BN) from {64, 128}^2.
template <int MODE>
int launch_tiled(const int8_t* x, const int8_t* wk, void* out, const int8_t* residual,
                 const int32_t* bias, const int32_t* mult, const int32_t* shift, int32_t* ws,
                 const int32_t* kzp, const Epi& e, const Geo& g, int ks, const int32_t* p,
                 cudaStream_t s) {
  if (g.M <= 0 || g.cout <= 0) return (int)cudaGetLastError();
  const int bm = p[P_BM] ? p[P_BM] : 64, bn = p[P_BN] ? p[P_BN] : 64;
#define TK_TILE(BM, BN)                                                                        \
  if (bm == BM && bn == BN)                                                                    \
    return launch_tile<MODE, BM, BN>(x, wk, out, residual, bias, mult, shift, ws, kzp, e, g, ks, \
                                     s);
  TK_TILE(64, 64)
  TK_TILE(64, 128)
  TK_TILE(128, 64)
  TK_TILE(128, 128)
#undef TK_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace igemm
}  // namespace tk
