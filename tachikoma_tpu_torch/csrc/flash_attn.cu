// K6 flash_attn: float32 attention with an online softmax, in one pass over
// key tiles, so the (S, S) score matrix never reaches device memory.
//
//   out[b, h, i, :] = sum_j p[i, j] v[b, h, j, :],  p[i, :] = softmax(s[i, :]),
//   s[i, j] = (q[b, h, i, :] . k[b, h, j, :]) * scale, or -1e30 where masked
//
// q, k and v are (B, H, S, D) float32 views whose last dimension is
// contiguous, each with its own element strides (batch, head, row): the
// graph's head split hands over (B, S, H, D) tensors viewed as (B, H, S, D),
// and they are read in place.  out is (B, H, S, D), contiguous.  Masked: key
// columns past S (the ragged last tile) and, with `causal`, col > row.  Any
// D >= 1.
//
// Replaces tachikoma_tpu/ops/pallas/flash_attention.py _fa_kernel (built by
// _build_fa, entry flash_attention): the tk.attention nodes that
// ir/transforms.py fuse_attention makes of the float BERT, GPT-2 and ViT
// graphs.  It keeps that kernel's order of operations: the dot first, then
// the multiply by the float32 scale (q is not pre-scaled); masked scores set
// to -1e30; m starts at -1e30, l and acc at 0; per key tile, in order,
//   m' = max(m, max_j s), alpha = exp(m - m'), p = exp(s - m'),
//   l = l * alpha + sum_j p, acc = acc * alpha + p v;
// a row whose l stays 0 gives 0.  expf, not __expf, and IEEE division: the
// tolerance against a float64 softmax is 2e-5 relative.
//
// Products: Q.K^T and P.V run on the tensor cores as 3xTF32 (mma.sync
// m16n8k8 tf32): each operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and the three products lo.hi, hi.lo and hi.hi are summed
// in float32 (lo.lo, below 2^-22 of the product, is dropped).  Plain TF32
// keeps 10 bits and breaks the 2e-5; 3xTF32 keeps float32's accuracy, once
// the tensor cores' own sums are kept short (fa_mma3).
//
// What bounds it on an H100: per call of BERT-base b4 s128 (G = B*H = 48,
// S = 128, D = 64) 4 G S^2 D = 0.2 GFLOP (causal: 4 G D S (S + 1) / 2) at
// the 3xTF32 rate, 495 / 3 = 165 TFLOP/s (1.2 us), against 4 tensors x
// G S D x 4 B = 6.3 MB at 3.35 TB/s (1.9 us): bytes bound it at these
// shapes.  The call is short, so the launch (1.7 us for an empty kernel)
// and the chain of one warp's key tiles set its time in practice
// (tools/fa_probe.py).
//
// Design.  A warp owns 16 query rows; a block of W = 2 or 4 warps shares
// each key tile of 64 keys (32 at D above 128) of K and V.  The tiles are
// copied into shared memory by 16-byte cp.async copies (4-byte ones where D
// or a stride is not a multiple of 4), the next one while this one is
// computed where two fit on an SM, and then split once, by the whole block,
// into a hi plane (in place) and a lo plane, so a warp's fragment loads are
// two plain loads and no split; Q's 16 W rows are copied and split once.
// The depth of Q.K^T, D rounded up to 32, 64, 128 or 256 (zero past D), is
// known at compile time, so every loop over it unrolls.  Per tile a warp
// computes its 16 x BK scores into registers (m16n8 fragments: each thread
// holds rows g and g + 8), masks (only in a tile that reaches past S or the
// diagonal) and scales them, takes the row max and sum over its quad of
// lanes, and feeds the probabilities straight back as the A operand of P.V
// (split per use, by their bits): the score fragment's columns (2t, 2t + 1)
// become the A fragment's (t, t + 4) and V's rows are read in the same
// permuted order, so P never goes through shared memory.  Row padding (Q
// and K rows + 4 floats, V rows + 4) keeps every fragment load on 32
// distinct banks.  The output columns a block computes (DV = 32, 64 or 128)
// may be fewer than D: then CS blocks split the columns, each recomputing
// the same scores in the same order, so m, l and every column equal the
// unsplit computation.  The host (ops/kernels/flash_attention.py fa_plan)
// picks the tile: BERT-base b4 s128 runs 192 blocks of 4 warps with D split
// in two, GPT-2 small b1 s128 48 such blocks, ViT-B/16 b8 384 blocks of 4
// warps.  Where D is above 256, one warp a block reads its Q and K
// fragments from global memory (L1-cached) and stages only V.  With causal,
// key tiles wholly above a warp's diagonal are skipped: every score in them
// is masked, so they would add p = 0 and leave m and l as they are.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "params.cuh"

// The parts of the kernel that tools/fa_probe.py cuts out, one at a time, to
// see what sets its time (each is 1 in the kernel as it runs).
#define FA_SPLIT 1   // 0: one plain TF32 product instead of 3xTF32
#define FA_PV 1      // 0: no P.V product
#define FA_EXP 1     // 0: p = s - m' instead of exp(s - m')
#define FA_COPIES 1  // 0: K and V tiles not staged (Q still is)
#define FA_BODY 1    // 0: the kernel returns as it starts

namespace tk {

constexpr float FA_NEG = -1e30f;  // the Pallas kernel's _NEG_INF
constexpr int FA_MAX_SMEM = 227 * 1024;

struct FaArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  long long qs[3], ks[3], vs[3];  // element strides: batch, head, row
  int H, S, D, Dp;                // Dp: D rounded up to 8
  int q_tiles, G, cs;             // query tiles of 16 W rows, B*H, column blocks
  int stages;                     // K and V tiles in flight: 1, or 2 (the next one copied
                                  // while this one is computed)
  float scale;
  bool causal, vec;               // vec: 16-byte copies
};

// Shared memory of one block, in floats.  Q: its 16 W rows as hi and lo
// planes; K and V tiles: `stages` raw tiles (split into hi in place) and
// one lo plane each.  Rows of DQ + 4 (Q, K) and DV + 4 (V) floats.  With KG
// (Q and K read from global memory) the V planes alone.
__host__ __device__ constexpr int fa_smem_floats(int w, int dq, int dv, int bk, bool kg,
                                                 int stages) {
  return kg ? (stages + 1) * bk * (dv + 4)
            : 2 * 16 * w * (dq + 4) + (stages + 1) * bk * (dq + 4 + dv + 4);
}

// x = hi + lo for a product in three TF32 parts, rounded by their bits (add
// half an ulp of TF32, clear the 13 low bits; a cvt.rna costs more).
// Staged operands (fa_split_rn) round both parts: |x - hi - lo| <= 2^-22 |x|.
// The scores (fa_split) round hi and leave lo to the tensor core, which
// keeps its top 10 bits: |x - hi - tf32(lo)| <= 2^-21 |x|.
__device__ __forceinline__ uint32_t fa_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void fa_split(float x, uint32_t& hi, uint32_t& lo) {
#if FA_SPLIT
  hi = fa_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
#else
  hi = __float_as_uint(x);
  lo = 0u;
#endif
}

__device__ __forceinline__ void fa_split_rn(float x, float& hi, float& lo) {
#if FA_SPLIT
  hi = __uint_as_float(fa_tf32(x));
  lo = __uint_as_float(fa_tf32(x - hi));
#else
  hi = x;
  lo = 0.f;
#endif
}

// d = a b + (acc ? d : 0), one m16n8k8 TF32 product.  Not volatile: the
// compiler may then interleave independent products, where a volatile asm
// would keep program order and wait out each product's latency in turn.
template <bool ACC>
__device__ __forceinline__ void fa_mma(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  const float z = 0.f;
  if (ACC)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

// d (+)= a b in 3xTF32, the small products first.  The tensor cores align
// and truncate each sum to the accumulator's exponent, so a sum taken inside
// them over many steps drifts; the callers run at most 8 k-steps (24
// products) into one fragment and add it to their float32 sum outside.
template <bool ACC>
__device__ __forceinline__ void fa_mma3(float (&d)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2]) {
#if FA_SPLIT
  fa_mma<ACC>(d, al, bh);
  fa_mma<true>(d, ah, bl);
  fa_mma<true>(d, ah, bh);
#else
  fa_mma<ACC>(d, ah, bh);
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) x columns [c0, c0 + COLS) of one (S, D) matrix (row
// stride ss) into shared memory [rows][COLS + 4], zero outside S x D.  COLS
// is known at compile time, so a thread's row and column are shifts.
template <int THREADS, int COLS>
__device__ __forceinline__ void fa_stage(float* dst, const float* src, long long ss, int r0,
                                         int rows, int c0, const FaArgs& a) {
  constexpr int ST = COLS + 4;
  if (a.vec) {
    constexpr int PER = COLS / 4;
    for (int i = threadIdx.x; i < rows * PER; i += THREADS) {
      const int r = i / PER, c = (i % PER) * 4;
      const bool ok = r0 + r < a.S && c0 + c < a.D;
      cp_async16(dst + r * ST + c, ok ? src + (r0 + r) * ss + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r0 + r < a.S && c0 + c < a.D;
      cp_async4(dst + r * ST + c, ok ? src + (r0 + r) * ss + c0 + c : src, ok);
    }
  }
}

// n floats (a multiple of 4) of a staged block split in place into its hi
// plane, the lo parts into `lo` (the same layout).
template <int THREADS>
__device__ __forceinline__ void fa_split_block(float* raw, float* lo, int n) {
  float4* r4 = reinterpret_cast<float4*>(raw);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 4
  for (int i = threadIdx.x; i < (n >> 2); i += THREADS) {
    float4 x = r4[i], h, l;
    fa_split_rn(x.x, h.x, l.x);
    fa_split_rn(x.y, h.y, l.y);
    fa_split_rn(x.z, h.z, l.z);
    fa_split_rn(x.w, h.w, l.w);
    r4[i] = h;
    l4[i] = l;
  }
}

// W warps, DQ the depth of Q.K^T (D rounded up, zero past D; 0: D at run
// time, with KG), DV output columns a block, BK keys a tile; KG: Q and K
// fragments read from global memory (only V staged).
template <int W, int DQ, int DV, int BK, bool KG>
__global__ void __launch_bounds__(32 * W) flash_attn_kernel(const FaArgs a) {
  constexpr int THREADS = 32 * W;
  constexpr int NJ = BK / 8;   // score n-tiles (keys) of a tile
  constexpr int NC = DV / 8;   // output n-tiles (columns)
  constexpr int QST = DQ + 4;  // Q and K row stride in shared memory
  constexpr int VST = DV + 4;  // V row stride
  constexpr int KF = 4;        // k-steps of Q.K^T summed in the tensor cores at a time
  extern __shared__ __align__(16) float smem[];

  const int n_k = (a.S + BK - 1) / BK;
  const int stages = a.stages;
  // Q hi (in place of raw) and lo; then per stage a K tile and a V tile,
  // raw and then hi in place, side by side so that one pass splits both;
  // then the K and V lo planes, side by side
  constexpr int TILE = (KG ? 0 : BK * QST) + BK * VST;
  float* qh = smem;
  float* ql = qh + (KG ? 0 : 16 * W * QST);
  float* kr = ql + (KG ? 0 : 16 * W * QST);  // stage st: kr + st * TILE
  float* kl = kr + stages * TILE;
  float* vl = kl + (KG ? 0 : BK * QST);

  int bx = blockIdx.x;
  const int qt = bx % a.q_tiles;
  bx /= a.q_tiles;
  const int gi = bx % a.G;
  const int cb = bx / a.G;
  const int bi = gi / a.H, hi = gi - bi * a.H;
  const float* qg = a.q + bi * a.qs[0] + hi * a.qs[1];
  const float* kg = a.k + bi * a.ks[0] + hi * a.ks[1];
  const float* vg = a.v + bi * a.vs[0] + hi * a.vs[1];
  const int q0 = qt * 16 * W;
  const int c0 = cb * DV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = q0 + warp * 16;  // the warp's first query row
  const int ra = wr0 + g, rb = ra + 8;

  const int last = a.causal ? min(n_k, (q0 + 16 * W - 1) / BK + 1) : n_k;

  auto issue = [&](int kt) {
    float* tile = kr + (kt % stages) * TILE;
    if (!KG) fa_stage<THREADS, DQ>(tile, kg, a.ks[2], kt * BK, BK, 0, a);
    fa_stage<THREADS, DV>(tile + (KG ? 0 : BK * QST), vg, a.vs[2], kt * BK, BK, c0, a);
  };

#if !FA_BODY
  if (a.S >= 0) return;
#endif
  if (!KG) fa_stage<THREADS, DQ>(qh, qg, a.qs[2], q0, 16 * W, 0, a);
  if (FA_COPIES) issue(0);
  cp_commit();

  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  const float* qwh = qh + warp * 16 * QST;
  const float* qwl = ql + warp * 16 * QST;
  const int kend = KG ? a.Dp : DQ;  // the depth of Q.K^T: compile-time when staged
  for (int kt = 0; kt < last; ++kt) {
    float* kt_h = kr + (kt % stages) * TILE;
    float* vt_h = kt_h + (KG ? 0 : BK * QST);
    if (stages == 2 && kt + 1 < last) {  // the next tile copied while this one is computed
      if (FA_COPIES) issue(kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      if (stages == 1 && kt > 0) {  // one stage: copied once the last tile is done
        if (FA_COPIES) issue(kt);
        cp_commit();
      }
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == 0 && !KG) fa_split_block<THREADS>(qh, ql, 16 * W * QST);
    fa_split_block<THREADS>(kt_h, kl, TILE);
    __syncthreads();

    const int k0 = kt * BK;
    // a warp past S, or whose rows all lie above this tile's keys, skips it
    const bool active = wr0 < a.S && !(a.causal && k0 > wr0 + 15);
    if (active) {
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kb = 0; kb < kend; kb += 8 * KF) {
        float part[NJ][4];
#pragma unroll
        for (int f = 0; f < KF; ++f) {
          const int kk = kb + 8 * f;
          if (kk >= kend) break;
          uint32_t ah[4], al[4];
          if (KG) {
            const int ca = kk + t, cc = ca + 4;
            fa_split(ra < a.S && ca < a.D ? __ldg(qg + ra * a.qs[2] + ca) : 0.f, ah[0], al[0]);
            fa_split(rb < a.S && ca < a.D ? __ldg(qg + rb * a.qs[2] + ca) : 0.f, ah[1], al[1]);
            fa_split(ra < a.S && cc < a.D ? __ldg(qg + ra * a.qs[2] + cc) : 0.f, ah[2], al[2]);
            fa_split(rb < a.S && cc < a.D ? __ldg(qg + rb * a.qs[2] + cc) : 0.f, ah[3], al[3]);
          } else {
            const int i0 = g * QST + kk + t, i1 = i0 + 8 * QST;
            ah[0] = __float_as_uint(qwh[i0]), al[0] = __float_as_uint(qwl[i0]);
            ah[1] = __float_as_uint(qwh[i1]), al[1] = __float_as_uint(qwl[i1]);
            ah[2] = __float_as_uint(qwh[i0 + 4]), al[2] = __float_as_uint(qwl[i0 + 4]);
            ah[3] = __float_as_uint(qwh[i1 + 4]), al[3] = __float_as_uint(qwl[i1 + 4]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t bh[2], bl[2];
            if (KG) {
              const int key = k0 + 8 * j + g, ca = kk + t, cc = ca + 4;
              fa_split(key < a.S && ca < a.D ? __ldg(kg + key * a.ks[2] + ca) : 0.f, bh[0],
                       bl[0]);
              fa_split(key < a.S && cc < a.D ? __ldg(kg + key * a.ks[2] + cc) : 0.f, bh[1],
                       bl[1]);
            } else {
              const int i0 = (8 * j + g) * QST + kk + t;
              bh[0] = __float_as_uint(kt_h[i0]), bl[0] = __float_as_uint(kl[i0]);
              bh[1] = __float_as_uint(kt_h[i0 + 4]), bl[1] = __float_as_uint(kl[i0 + 4]);
            }
            if (f == 0)
              fa_mma3<false>(part[j], ah, al, bh, bl);
            else
              fa_mma3<true>(part[j], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
      }

      // scale, and mask where the tile reaches past S or the diagonal; the
      // row max and sum over the quad (lanes 4g .. 4g + 3)
      float mx[2] = {FA_NEG, FA_NEG};
      if (k0 + BK > a.S || (a.causal && k0 + BK - 1 > wr0)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? ra : rb, col = k0 + 8 * j + 2 * t + (e & 1);
            const bool keep = col < a.S && (!a.causal || col <= row);
            s[j][e] = keep ? s[j][e] * a.scale : FA_NEG;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= a.scale;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = FA_EXP ? expf(s[j][e] - m[e >> 1]) : s[j][e] - m[e >> 1];
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = l[h] * alpha[h] + rs[h];
      }

      // acc = acc * alpha + P V, P V summed over the tile in the tensor
      // cores; the A fragment's columns (t, t + 4) are keys (2t, 2t + 1) of
      // the k-step, and V's rows are read in that order
      float pv[NC][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        fa_split(s[j][0], ph[0], pl[0]);
        fa_split(s[j][2], ph[1], pl[1]);
        fa_split(s[j][1], ph[2], pl[2]);
        fa_split(s[j][3], ph[3], pl[3]);
        const int i0 = (8 * j + 2 * t) * VST + g;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint32_t bh[2] = {__float_as_uint(vt_h[i0 + 8 * c]),
                                  __float_as_uint(vt_h[i0 + VST + 8 * c])};
          const uint32_t bl[2] = {__float_as_uint(vl[i0 + 8 * c]),
                                  __float_as_uint(vl[i0 + VST + 8 * c])};
          if (j == 0)
            fa_mma3<false>(pv[c], ph, pl, bh, bl);
          else
            fa_mma3<true>(pv[c], ph, pl, bh, bl);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c][0] = acc[c][0] * alpha[0] + (FA_PV ? pv[c][0] : 0.f);
        acc[c][1] = acc[c][1] * alpha[0] + (FA_PV ? pv[c][1] : 0.f);
        acc[c][2] = acc[c][2] * alpha[1] + (FA_PV ? pv[c][2] : 0.f);
        acc[c][3] = acc[c][3] * alpha[1] + (FA_PV ? pv[c][3] : 0.f);
      }
    }
    __syncthreads();  // this tile's planes are read by every warp before they are refilled
  }

  float* og = a.out + (long long)gi * a.S * a.D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    if (row >= a.S) continue;
    const float safe = l[h] > 0.f ? l[h] : 1.f;  // no unmasked key: 0, not NaN
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c0 + 8 * c + 2 * t;
      if (col < a.D) og[(long long)row * a.D + col] = acc[c][2 * h] / safe;
      if (col + 1 < a.D) og[(long long)row * a.D + col + 1] = acc[c][2 * h + 1] / safe;
    }
  }
}

template <int W, int DQ, int DV, int BK, bool KG>
int launch_flash_attn(const FaArgs& a, cudaStream_t st) {
  const size_t smem =
      (size_t)fa_smem_floats(W, DQ, DV, BK, KG, a.stages) * sizeof(float);
  if (smem > (size_t)FA_MAX_SMEM || (!KG && a.Dp > DQ)) return (int)cudaErrorInvalidValue;
  // once per instantiation (and so never inside a CUDA-graph capture, which
  // follows a warm-up call): the largest tile this kernel may be given
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel<W, DQ, DV, BK, KG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               FA_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const long long blocks = (long long)a.q_tiles * a.G * a.cs;
  flash_attn_kernel<W, DQ, DV, BK, KG><<<(unsigned)blocks, 32 * W, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The tiles K6 is built for (ops/kernels/flash_attention.py TILES): the
// depth DQ of Q.K^T, DV output columns and BK keys a tile (64; 32 at DQ 256
// for the shared memory, and at DQ 64 for a third block on an SM), staged
// with W = 2 or 4 warps; with Q and K read from global memory (D above 256),
// DQ 0 and W = 1.
template <int W>
int launch_staged(int dq, int dv, int bk, const FaArgs& a, cudaStream_t st) {
  if (dq == 32 && dv == 32 && bk == 64) return launch_flash_attn<W, 32, 32, 64, false>(a, st);
  if (dq == 64 && dv == 32 && bk == 64) return launch_flash_attn<W, 64, 32, 64, false>(a, st);
  if (dq == 64 && dv == 64 && bk == 64) return launch_flash_attn<W, 64, 64, 64, false>(a, st);
  if (dq == 64 && dv == 64 && bk == 32) return launch_flash_attn<W, 64, 64, 32, false>(a, st);
  if (dq == 128 && dv == 64 && bk == 64) return launch_flash_attn<W, 128, 64, 64, false>(a, st);
  if (dq == 128 && dv == 128 && bk == 64)
    return launch_flash_attn<W, 128, 128, 64, false>(a, st);
  if (dq == 256 && dv == 64 && bk == 32) return launch_flash_attn<W, 256, 64, 32, false>(a, st);
  if (dq == 256 && dv == 128 && bk == 32)
    return launch_flash_attn<W, 256, 128, 32, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tk

// Launches on `stream` and returns cudaGetLastError(); cudaErrorInvalidValue
// for a plan K6 is not built for (launch_staged's tiles with W = 2 or 4; with
// Q and K from global memory, DV 32, 64 or 128 and W = 1; CS * DV >= D), a
// tile that does not fit in shared memory, or a grid above 2^31 - 1 blocks.
extern "C" int tk_flash_attn(const float* q, const float* k, const float* v, float* out,
                             const int32_t* p, void* stream) {
  tk::FaArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  const int B = p[tk::P_N];
  a.H = p[tk::P_HEADS];
  a.S = p[tk::P_S];
  a.D = p[tk::P_D];
  a.Dp = (a.D + 7) / 8 * 8;
  a.G = B * a.H;
  const int w = p[tk::P_FA_W], dq = p[tk::P_FA_DQ], dv = p[tk::P_FA_DV], bk = p[tk::P_FA_BK];
  a.cs = p[tk::P_FA_CS];
  a.stages = p[tk::P_FA_STAGES];
  const bool kg = p[tk::P_FA_KG] != 0;
  a.causal = p[tk::P_CAUSAL] != 0;
  a.vec = p[tk::P_FA_VEC] != 0;
  std::memcpy(&a.scale, &p[tk::P_SCALE_BITS], sizeof a.scale);
  const int* st = &p[tk::P_Q_SB];  // q, k, v: batch, head, row
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = st[i];
    a.ks[i] = st[3 + i];
    a.vs[i] = st[6 + i];
  }
  if (B < 0 || a.H < 1 || a.S < 0 || a.D < 1 || a.cs < 1 || (long long)a.cs * dv < a.D ||
      a.stages < 1 || a.stages > 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || a.S == 0) return (int)cudaGetLastError();
  a.q_tiles = (a.S + 16 * w - 1) / (16 * w);
  if ((long long)a.q_tiles * a.G * a.cs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kg) {
    if (w != 1) return (int)cudaErrorInvalidValue;
    if (dv == 32) return tk::launch_flash_attn<1, 0, 32, 64, true>(a, s);
    if (dv == 64) return tk::launch_flash_attn<1, 0, 64, 64, true>(a, s);
    if (dv == 128) return tk::launch_flash_attn<1, 0, 128, 64, true>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (w == 2) return tk::launch_staged<2>(dq, dv, bk, a, s);
  if (w == 4) return tk::launch_staged<4>(dq, dv, bk, a, s);
  return (int)cudaErrorInvalidValue;
}
