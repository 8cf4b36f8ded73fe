// K6 flash_attn: float32 attention with an online softmax, in one pass over
// key tiles, so the (S, S) score matrix never reaches device memory.
//
//   out[g, i, :] = sum_j p[i, j] v[g, j, :],  p[i, :] = softmax(s[i, :]),
//   s[i, j] = (q[g, i, :] . k[g, j, :]) * scale, or -1e30 where masked
//
// q, k, v and out are (G = B*H, S, D) float32, contiguous.  Masked: key
// columns past S (the ragged last tile) and, with `causal`, col > row.
//
// Replaces tachikoma_tpu/ops/pallas/flash_attention.py _fa_kernel (built by
// _build_fa, entry flash_attention): the tk.attention nodes that
// ir/transforms.py fuse_attention makes of the float BERT, GPT-2 and ViT
// graphs.  It keeps that kernel's order of operations: the dot first, then
// the multiply by the float32 scale (q is not pre-scaled); masked scores set
// to -1e30; m starts at -1e30, l and acc at 0; per key tile
//   m' = max(m, max_j s), alpha = exp(m - m'), p = exp(s - m'),
//   l = l * alpha + sum_j p, acc = acc * alpha + p v;
// a row whose l stays 0 gives 0.  expf, not __expf, and IEEE division: the
// tolerance against a float64 softmax is 2e-5 relative.
//
// What bounds it on an H100: per forward of BERT-base b4 s128 (G = 48,
// S = 128, D = 64) 4 G S^2 D = 0.2 GFLOP (causal: 4 G D S (S + 1) / 2) over
// the float32 CUDA-core rate (67 TFLOP/s), against 4 tensors x G S D x 4 B
// = 6.3 MB over 3.35 TB/s: operations bound it (3 us against 1.9 us).
// Not the TPU's design: the sequential third grid axis with VMEM scratch is
// a loop over key tiles inside one block; the (bq, 128) lane-replicated m
// and l and the 128-lane key padding are TPU tactics and are gone (the
// ragged tile is masked here, nothing is padded in device memory).
//
// Design, simple and right first: one block of 128 threads per (g, tile of
// 64 query rows); the block loops over tiles of 64 keys.  Q, K, V and the
// tile's P live in shared memory (rows padded by one float, P rows by 8, so
// every access pattern below hits distinct banks): 115 KB for D = 128,
// 67 KB for D = 64, above the 48 KB default, so the launch raises the
// block's limit.  Thread (tr, tc) = (tid / 8, tid % 8) owns query rows
// tr + 16 i (i < 4) and, for the scores, key columns tc + 8 j (j < 8); for
// P.V, output columns tc + 8 c.  The eight threads of a row are neighbouring
// lanes, so row max and row sum are three shuffles.  Scores and P.V are
// float32 FFMA on CUDA cores, with m, l and acc in registers.  With causal,
// key tiles wholly above the diagonal are skipped: every score in them is
// masked, so they would add p = 0 and leave m and l as they are.  D is taken
// up to 128 (a compile-time tile of 32, 64 or 128 columns, zero-filled past
// D).  Tensor cores (3xTF32 or wgmma), TMA and warp specialization are for a
// later version.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "params.cuh"

namespace tk {

constexpr int FA_BQ = 64;            // query rows per block
constexpr int FA_BK = 64;            // keys per tile
constexpr int FA_THREADS = 128;
constexpr int FA_ROWS = 4;           // query rows per thread: tr + 16 i
constexpr int FA_KEYS = 8;           // score columns per thread: tc + 8 j
constexpr int FA_PSTRIDE = FA_BK + 8;
constexpr int FA_MAX_D = 128;
constexpr float FA_NEG = -1e30f;     // the Pallas kernel's _NEG_INF

template <int DT>
constexpr size_t fa_smem_bytes() {
  return (3 * FA_BQ * (DT + 1) + FA_BQ * FA_PSTRIDE) * sizeof(float);
}

// Rows [r0, r0 + 64) of one (S, D) matrix into shared memory [64][DT + 1],
// 0 outside S x D.
template <int DT>
__device__ __forceinline__ void fa_stage(float* __restrict__ dst, const float* __restrict__ src,
                                         int r0, int S, int D) {
  for (int i = threadIdx.x; i < FA_BQ * DT; i += FA_THREADS) {
    const int r = i / DT, c = i - r * DT;
    dst[r * (DT + 1) + c] = (r0 + r < S && c < D) ? src[(long long)(r0 + r) * D + c] : 0.f;
  }
}

template <int DT>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int S, int D,
                      float scale, bool causal) {
  constexpr int ST = DT + 1;
  constexpr int NC = DT / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + FA_BQ * ST;
  float* vs = ks + FA_BK * ST;
  float* ps = vs + FA_BK * ST;

  const long long base = (long long)blockIdx.x * S * D;
  const int q0 = blockIdx.y * FA_BQ;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;

  fa_stage<DT>(qs, q + base, q0, S, D);

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][NC];
#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (S + FA_BK - 1) / FA_BK;
  const int last = causal ? min(n_k, (q0 + FA_BQ - 1) / FA_BK + 1) : n_k;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // the previous tile's K, V and P are read by now
    fa_stage<DT>(ks, k + base, k0, S, D);
    fa_stage<DT>(vs, v + base, k0, S, D);
    __syncthreads();

    float s[FA_ROWS][FA_KEYS];
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < FA_KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      float qv[FA_ROWS], kv[FA_KEYS];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i) qv[i] = qs[(tr + 16 * i) * ST + d];
#pragma unroll
      for (int j = 0; j < FA_KEYS; ++j) kv[j] = ks[(tc + 8 * j) * ST + d];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < FA_KEYS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i) {
      const int row = q0 + tr + 16 * i;
      float mc = FA_NEG;
#pragma unroll
      for (int j = 0; j < FA_KEYS; ++j) {
        const int col = k0 + tc + 8 * j;
        const bool keep = col < S && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : FA_NEG;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < FA_KEYS; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(tr + 16 * i) * FA_PSTRIDE + tc + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P of the whole tile is in shared memory

#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float pv[FA_ROWS], vv[NC];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i) pv[i] = ps[(tr + 16 * i) * FA_PSTRIDE + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * ST + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= S) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;  // no unmasked key: 0, not NaN
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 8 * c;
      if (col < D) out[base + (long long)row * D + col] = acc[i][c] / safe;
    }
  }
}

template <int DT>
int launch_flash_attn(const float* q, const float* k, const float* v, float* out, int G, int S,
                      int D, float scale, bool causal, cudaStream_t st) {
  constexpr size_t smem = fa_smem_bytes<DT>();
  // once per tile width (and so never inside a CUDA-graph capture, which
  // follows a warm-up call)
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  const dim3 grid((unsigned)G, (unsigned)((S + FA_BQ - 1) / FA_BQ));
  flash_attn_kernel<DT><<<grid, FA_THREADS, smem, st>>>(q, k, v, out, S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tk

// Launches on `stream` and returns cudaGetLastError(); cudaErrorInvalidValue
// for D outside 1..128 or more query tiles than a grid's y dimension takes.
extern "C" int tk_flash_attn(const float* q, const float* k, const float* v, float* out,
                             const int32_t* p, void* stream) {
  const int G = p[tk::P_G], S = p[tk::P_S], D = p[tk::P_D];
  const bool causal = p[tk::P_CAUSAL] != 0;
  float scale;
  std::memcpy(&scale, &p[tk::P_SCALE_BITS], sizeof scale);
  if (G < 0 || S < 0 || D < 1 || D > tk::FA_MAX_D || (S + tk::FA_BQ - 1) / tk::FA_BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return tk::launch_flash_attn<32>(q, k, v, out, G, S, D, scale, causal, st);
  if (D <= 64) return tk::launch_flash_attn<64>(q, k, v, out, G, S, D, scale, causal, st);
  return tk::launch_flash_attn<128>(q, k, v, out, G, S, D, scale, causal, st);
}
