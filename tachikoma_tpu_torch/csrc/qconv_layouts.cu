// K8 and K10: two layouts of the flat conv, qconv_rq_s / _r (K7 and K9, the
// other two, are qconv_layouts_hopper.cu).
//
// Each computes exactly K2's function (NHWC int8 conv, int32 accumulator +
// bias, the exact requantize epilogue of requantize.cuh, int8 out) along
// another data path.  They replace the layout variants of
// tachikoma_tpu/ops/pallas/conv_flat.py _flat_conv_kernel (built by
// _build_flat_conv, chosen per workload by the tuning database's `layout`):
//   K8 qconv_rq_s  <- _flat_conv_kernel_s (:133), staged halo;
//   K10 qconv_rq_r <- _flat_conv_kernel_r (:224), row-stacked K.
//
// The flat frame (built by the wrapper, ops/kernels/conv_layouts.py, as
// _conv_mxu builds it): a stride-s conv is first rewritten as a stride-1
// conv over the polyphase-stacked image (exact relabeling: C = s*s*CIN
// channels, KHP x KWP = ceil(KH/s) x ceil(KW/s) taps, zero weights where a
// phase has no tap), padded with the input zero point, its channels padded
// with zeros to a multiple of 16, and flattened to rows of a (MX, C) matrix
// with WP pixels per image row.  Output row m of the over-wide frame then
// reads input row m + a * WP + b for tap (a, b): a unit-stride shift, with no
// bounds check and no division in the kernel.  The wrapper slices off the
// over-wide garbage columns and rows.  So both kernels are stride-1 and
// accept every geometry, the 7x7 s2 stem (CIN 3 -> C 16) included.
//
// What bounds them on an H100: the same work as K2 (the 3x3 s2 convs of
// ResNet-50 b8 are near the ~590 operations per byte at which the int8 tensor
// cores overtake memory) plus the polyphase zero taps (16 tap-phases for the
// 9 real taps of a 3x3 s2) and the over-wide columns.  Simple and right
// first: mma.sync m16n8k32, BM x BN x 64 tiles of qgemm.cuh's shapes, no
// pipelining beyond cp.async of the staged input.
//   K8 s:  per block and 64-channel chunk, the input rows that the block's BM
//          outputs touch (BM + maxoff rows) are copied into shared memory once
//          (cp.async); every tap's A fragments are then read from there at a
//          row offset.  K2 fetches each input byte once per tap from L2.
//   K10 r: K runs in (kx, ky, ci) order over weights (KWP, KHP, C, COUT); per
//          column tap one window of BM + (KHP-1)*WP rows is staged, and its
//          KHP row taps form one deep-K run (KHP weight tiles staged at once,
//          then KHP x 2 mma steps with no barrier between them).
#include "qgemm.cuh"

namespace tk {

struct Flat {
  int mo, mx, c, wp, khp, kwp, cout;
  bool b_vec;
};

__device__ __forceinline__ int tap_off(int t, const Flat& f) {
  return (t / f.kwp) * f.wp + t % f.kwp;
}

__device__ __forceinline__ int max_off(const Flat& f) { return (f.khp - 1) * f.wp + f.kwp - 1; }

// 16 bytes global -> shared, or 16 zero bytes when !valid (source size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// W[r][0, BK) = x[row0 + r][k0, k0 + BK) for r < nrows (row stride SROW),
// zero past the frame's MX rows or its C channels.
__device__ __forceinline__ void stage_rows(int8_t* W, const int8_t* __restrict__ x, int row0,
                                           int nrows, int k0, const Flat& f) {
  for (int e = threadIdx.x; e < nrows * (BK / 16); e += blockDim.x) {
    const int r = e >> 2, ch = (e & 3) * 16;
    const int row = row0 + r, k = k0 + ch;
    const bool ok = row < f.mx && k < f.c;
    cp_async16(W + r * SROW + ch, ok ? x + (long long)row * f.c + k : x, ok);
  }
}

// Bs[n][kk] = w[(wrow0 + kk) * ldw + col0 + n] for kk < BK, n < NB (the mma's
// B operand, [n][k] rows of stride SROW), zero where kk >= kvalid or
// n >= nvalid; 4-byte loads when b_vec (ldw and col0 % 4 == 0).
template <int NB>
__device__ __forceinline__ void stage_b(int8_t* Bs, const int8_t* __restrict__ w, long long wrow0,
                                        int kvalid, long long ldw, long long col0, int nvalid,
                                        bool b_vec) {
  constexpr int NG = NB / 4;
  for (int e = threadIdx.x; e < (BK / 4) * NG; e += blockDim.x) {
    const int kq = (e & 7) + 8 * ((e >> 3) / NG), nq = (e >> 3) % NG;
    const int n = nq * 4;
    uint32_t v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = kq * 4 + r;
      v[r] = 0;
      if (kk < kvalid && n < nvalid) {
        const int8_t* p = w + (wrow0 + kk) * ldw + col0 + n;
        if (b_vec && n + 4 <= nvalid) {
          v[r] = *reinterpret_cast<const uint32_t*>(p);
        } else {
          for (int j = 0; j < 4 && n + j < nvalid; ++j)
            v[r] |= (uint32_t)(uint8_t)p[j] << (8 * j);
        }
      }
    }
    store_transposed(Bs + n * SROW + kq * 4, SROW, v);
  }
}

// acc += A[a_row + m][0, BK) . Bs[n][0, BK) over the warp's 32 x 32 tile
// (rows wm + .., columns wn + ..); A and Bs have row stride SROW.
__device__ __forceinline__ void mma_tile(int32_t (&acc)[2][4][4], const int8_t* A, int a_row,
                                         const int8_t* Bs, int wm, int wn, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* p = A + (a_row + wm + mt * 16 + gid) * SROW + ks + tig * 4;
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
}

// The requantize epilogue of the warp's 32 x 32 tile into out (MO, COUT).
__device__ __forceinline__ void store_rq(const int32_t (&acc)[2][4][4], int8_t* __restrict__ out,
                                         int m0, int n0, int wm, int wn, int lane, const Flat& f,
                                         const Requant& rq) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mt * 16 + gid + (i >> 1) * 8;
        const int col = n0 + wn + nt * 8 + tig * 2 + (i & 1);
        if (row < f.mo && col < f.cout)
          out[(long long)row * f.cout + col] = (int8_t)requantize_channel(acc[mt][nt][i], col, rq);
      }
}

// ---------------------------------------------------------------------------
// K8 s: staged halo.  smem: (BM + maxoff) window rows, BN weight rows.
// ---------------------------------------------------------------------------
template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NTHREADS)
    qconv_s_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int8_t* __restrict__ out, Requant rq, Flat f) {
  extern __shared__ __align__(16) int8_t smem[];
  const int rows = BM + max_off(f);
  int8_t* win = smem;
  int8_t* bs = smem + rows * SROW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp % Tile<BM, BN>::WARPS_M) * 32, wn = (warp / Tile<BM, BN>::WARPS_M) * 32;
  int32_t acc[2][4][4] = {};
  const int taps = f.khp * f.kwp;
  for (int k0 = 0; k0 < f.c; k0 += BK) {
    stage_rows(win, x, m0, rows, k0, f);
    for (int t = 0; t < taps; ++t) {
      stage_b<BN>(bs, w, (long long)t * f.c + k0, f.c - k0, f.cout, n0, f.cout - n0, f.b_vec);
      cp_async_wait_all();
      __syncthreads();
      mma_tile(acc, win, tap_off(t, f), bs, wm, wn, lane);
      __syncthreads();
    }
  }
  store_rq(acc, out, m0, n0, wm, wn, lane, f, rq);
}

// ---------------------------------------------------------------------------
// K10 r: row-stacked K.  w is (KWP, KHP, C, COUT); smem: one column tap's
// window (BM + (KHP-1)*WP rows) and its KHP weight tiles.
// ---------------------------------------------------------------------------
template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NTHREADS)
    qconv_r_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int8_t* __restrict__ out, Requant rq, Flat f) {
  extern __shared__ __align__(16) int8_t smem[];
  const int rows = BM + (f.khp - 1) * f.wp;
  int8_t* win = smem;
  int8_t* bs = smem + rows * SROW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp % Tile<BM, BN>::WARPS_M) * 32, wn = (warp / Tile<BM, BN>::WARPS_M) * 32;
  int32_t acc[2][4][4] = {};
  for (int k0 = 0; k0 < f.c; k0 += BK) {
    for (int b = 0; b < f.kwp; ++b) {
      stage_rows(win, x, m0 + b, rows, k0, f);
      for (int a = 0; a < f.khp; ++a)
        stage_b<BN>(bs + a * BN * SROW, w, (long long)(b * f.khp + a) * f.c + k0, f.c - k0,
                    f.cout, n0, f.cout - n0, f.b_vec);
      cp_async_wait_all();
      __syncthreads();
      for (int a = 0; a < f.khp; ++a)
        mma_tile(acc, win, a * f.wp, bs + a * BN * SROW, wm, wn, lane);
      __syncthreads();
    }
  }
  store_rq(acc, out, m0, n0, wm, wn, lane, f, rq);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum Layout { LAYOUT_S, LAYOUT_R };

// Dynamic shared memory of each layout; the wrapper mirrors these sums
// (conv_layouts.py smem_bytes) to refuse what does not fit.
inline size_t smem_bytes(Layout l, int bm, int bn, const Flat& f) {
  const int maxoff = (f.khp - 1) * f.wp + f.kwp - 1;
  switch (l) {
    case LAYOUT_S:
      return (size_t)(bm + maxoff + bn) * SROW;
    case LAYOUT_R:
      return (size_t)(bm + (f.khp - 1) * f.wp + f.khp * bn) * SROW;
  }
  return 0;
}

template <Layout L, int BM, int BN>
void launch_layout_tile(const int8_t* x, const int8_t* w, int8_t* out, const Requant& rq,
                        const Flat& f, cudaStream_t stream) {
  auto kern = L == LAYOUT_S ? qconv_s_kernel<BM, BN> : qconv_r_kernel<BM, BN>;
  const int threads = Tile<BM, BN>::NTHREADS;
  const size_t smem = smem_bytes(L, BM, BN, f);
  // raised once per kernel, at its first (eager) launch, never lowered
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
        cudaSuccess)
      return;  // the launch below then fails too, and cudaGetLastError() says why
    granted = smem;
  }
  const dim3 grid((f.mo + BM - 1) / BM, (f.cout + BN - 1) / BN);
  kern<<<grid, threads, smem, stream>>>(x, w, out, rq, f);
}

template <Layout L>
int launch_layout(const int8_t* x, const int8_t* w, int8_t* out, const int32_t* bias,
                  const int32_t* mult, const int32_t* shift, const int32_t* p, void* stream) {
  Flat f;
  f.mo = p[P_MO];
  f.mx = p[P_MX];
  f.c = p[P_CIN];
  f.wp = p[P_WP];
  f.khp = p[P_KH];
  f.kwp = p[P_KW];
  f.cout = p[P_COUT];
  f.b_vec = p[P_B_VEC] != 0;
  const Requant rq{bias, mult, shift, p[P_RQ_IZP], p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                   p[P_TONEAREST] != 0};
  const int bm = p[P_BM] ? p[P_BM] : 64, bn = p[P_BN] ? p[P_BN] : 64;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f.mo <= 0 || f.cout <= 0) return (int)cudaGetLastError();
  if (bm == 64 && bn == 64) {
    launch_layout_tile<L, 64, 64>(x, w, out, rq, f, s);
  } else if (bm == 64 && bn == 128) {
    launch_layout_tile<L, 64, 128>(x, w, out, rq, f, s);
  } else if (bm == 128 && bn == 64) {
    launch_layout_tile<L, 128, 64>(x, w, out, rq, f, s);
  } else if (bm == 128 && bn == 128) {
    launch_layout_tile<L, 128, 128>(x, w, out, rq, f, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace tk

#define TK_LAYOUT_ENTRY(NAME, L)                                                             \
  extern "C" int NAME(const int8_t* x, const int8_t* w, int8_t* out, const int32_t* bias,   \
                      const int32_t* mult, const int32_t* shift, const int32_t* params,     \
                      void* stream) {                                                        \
    return tk::launch_layout<L>(x, w, out, bias, mult, shift, params, stream);              \
  }

TK_LAYOUT_ENTRY(tk_qconv_rq_s, tk::LAYOUT_S)
TK_LAYOUT_ENTRY(tk_qconv_rq_r, tk::LAYOUT_R)
