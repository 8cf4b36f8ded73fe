// K7-K10: the four layouts of the flat conv, qconv_rq_t / _s / _w / _r.
//
// Each computes exactly K2's function (NHWC int8 conv, int32 accumulator +
// bias, the exact requantize epilogue of requantize.cuh, int8 out) along
// another data path.  They replace the layout variants of
// tachikoma_tpu/ops/pallas/conv_flat.py _flat_conv_kernel (built by
// _build_flat_conv, chosen per workload by the tuning database's `layout`):
//   K7 qconv_rq_t  <- _flat_conv_kernel_t (:278), channel-major image;
//   K8 qconv_rq_s  <- _flat_conv_kernel_s (:133), staged halo;
//   K9 qconv_rq_w  <- _flat_conv_kernel_w (:182), wide N;
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
// over-wide garbage columns and rows.  So all four kernels are stride-1 and
// accept every geometry, the 7x7 s2 stem (CIN 3 -> C 16) included; only K9
// has a limit (shared memory, below).
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
//   K7 t:  the image arrives channel-major (C, MX); the window is staged as
//          64 channel rows x (BM + maxoff) pixels with 16-byte loads along M,
//          and per tap 4x4 byte blocks are transposed into [m][k] rows (the
//          B loader's transpose, applied to A).
//   K9 w:  per chunk, one product of the block's (BM + maxoff) window rows
//          against up to G taps' weights side by side (64 x G*BN); the int32
//          partials go to shared memory and each output sums its G shifted
//          partials.  Shared memory: (BM+maxoff) * G*BN * 4 bytes of partials,
//          so the wrapper picks the largest G that fits 227 KB and refuses a
//          tile where even G = 1 does not.
//   K10 r: K runs in (kx, ky, ci) order over weights (KWP, KHP, C, COUT); per
//          column tap one window of BM + (KHP-1)*WP rows is staged, and its
//          KHP row taps form one deep-K run (KHP weight tiles staged at once,
//          then KHP x 2 mma steps with no barrier between them).
#include "qgemm.cuh"

namespace tk {

struct Flat {
  int mo, mx, c, wp, khp, kwp, cout, group;
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
// K7 t: channel-major image xt (C, MX).  smem: 64 channel rows of the window
// (stride span + 16), the transposed A tile, the B tile.
// ---------------------------------------------------------------------------
template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NTHREADS)
    qconv_t_kernel(const int8_t* __restrict__ xt, const int8_t* __restrict__ w,
                   int8_t* __restrict__ out, Requant rq, Flat f) {
  extern __shared__ __align__(16) int8_t smem[];
  const int span = (BM + max_off(f) + 15) & ~15;  // window pixels, whole 16-byte loads
  const int xs = span + 16;                       // + room for the unaligned word reads
  int8_t* xwin = smem;
  int8_t* as = smem + BK * xs;
  int8_t* bs = as + BM * SROW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp % Tile<BM, BN>::WARPS_M) * 32, wn = (warp / Tile<BM, BN>::WARPS_M) * 32;
  int32_t acc[2][4][4] = {};
  const int taps = f.khp * f.kwp, segs = span / 16;
  for (int k0 = 0; k0 < f.c; k0 += BK) {
    for (int e = threadIdx.x; e < BK * segs; e += blockDim.x) {
      const int kk = e / segs, seg = (e - kk * segs) * 16;
      const int k = k0 + kk, m = m0 + seg;
      const bool ok = k < f.c && m < f.mx;
      cp_async16(xwin + kk * xs + seg, ok ? xt + (long long)k * f.mx + m : xt, ok);
    }
    for (int t = 0; t < taps; ++t) {
      const int off = tap_off(t, f);
      stage_b<BN>(bs, w, (long long)t * f.c + k0, f.c - k0, f.cout, n0, f.cout - n0, f.b_vec);
      cp_async_wait_all();
      __syncthreads();
      // A[m][kq*4 .. +3] for m = mq*4 .. +3: channel rows kq*4 + r at pixel
      // m + off, read as aligned words and funnel-shifted, then transposed
      for (int e = threadIdx.x; e < (BK / 4) * (BM / 4); e += blockDim.x) {
        const int kq = e % (BK / 4), mq = e / (BK / 4);
        const int p = mq * 4 + off;
        const int a = p & ~3, sh = (p & 3) * 8;
        uint32_t v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int8_t* row = xwin + (kq * 4 + r) * xs + a;
          v[r] = __funnelshift_r(*reinterpret_cast<const uint32_t*>(row),
                                 *reinterpret_cast<const uint32_t*>(row + 4), sh);
        }
        store_transposed(as + (mq * 4) * SROW + kq * 4, SROW, v);
      }
      __syncthreads();
      mma_tile(acc, as, 0, bs, wm, wn, lane);
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
// K9 w: wide N.  w is (C, T * COUT); smem: the window (rows rounded up to
// 16), G weight tiles side by side, the int32 partials P (rows x G*BN).
// Each thread owns BM*BN/256 outputs (column tid % BN) in registers.
// ---------------------------------------------------------------------------
constexpr int W_THREADS = 256;
constexpr int W_PPAD = 4;  // int32 words of padding per row of P

__host__ __device__ inline int w_rows(int bm, int maxoff) { return (bm + maxoff + 15) & ~15; }

template <int BM, int BN>
__global__ void __launch_bounds__(W_THREADS)
    qconv_w_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int8_t* __restrict__ out, Requant rq, Flat f) {
  extern __shared__ __align__(16) int8_t smem[];
  const int rows = w_rows(BM, max_off(f));
  const int G = f.group, taps = f.khp * f.kwp;
  const int ps = G * BN + W_PPAD;
  int8_t* win = smem;
  int8_t* ws = win + rows * SROW;
  int32_t* P = reinterpret_cast<int32_t*>(ws + G * BN * SROW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  constexpr int OUT_PER = BM * BN / W_THREADS, MSTEP = W_THREADS / BN;
  const int on = tid % BN, om = tid / BN;
  int32_t acc[OUT_PER] = {};
  const long long ldw = (long long)taps * f.cout;
  const int mtiles = rows / 16;
  for (int k0 = 0; k0 < f.c; k0 += BK) {
    stage_rows(win, x, m0, rows, k0, f);
    for (int t0 = 0; t0 < taps; t0 += G) {
      const int g = min(G, taps - t0);
      for (int tl = 0; tl < g; ++tl)
        stage_b<BN>(ws + tl * BN * SROW, w, k0, f.c - k0, ldw, (long long)(t0 + tl) * f.cout + n0,
                    f.cout - n0, f.b_vec);
      cp_async_wait_all();
      __syncthreads();
      // P = window . [W_t0 .. W_t0+g-1]: 16 x 32 subtiles spread over the warps
      const int ntiles = g * BN / 32;
      for (int s = warp; s < mtiles * ntiles; s += W_THREADS / 32) {
        const int mt = s % mtiles, nt = s / mtiles;
        int32_t c4[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < BK; ks += 32) {
          uint32_t af[4];
          const int8_t* p = win + (mt * 16 + gid) * SROW + ks + tig * 4;
          af[0] = *reinterpret_cast<const uint32_t*>(p);
          af[1] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW);
          af[2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[3] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW + 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int8_t* q = ws + (nt * 32 + j * 8 + gid) * SROW + ks + tig * 4;
            mma_s8(c4[j], af, *reinterpret_cast<const uint32_t*>(q),
                   *reinterpret_cast<const uint32_t*>(q + 16));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            P[(mt * 16 + gid + 8 * (i >> 1)) * ps + nt * 32 + j * 8 + 2 * tig + (i & 1)] = c4[j][i];
      }
      __syncthreads();
      // each output sums its taps' partials, shifted by the taps' offsets
#pragma unroll
      for (int i = 0; i < OUT_PER; ++i) {
        const int m = om + i * MSTEP;
        int32_t sum = acc[i];
        for (int tl = 0; tl < g; ++tl)
          sum = wrap_add(sum, P[(m + tap_off(t0 + tl, f)) * ps + tl * BN + on]);
        acc[i] = sum;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < OUT_PER; ++i) {
    const int row = m0 + om + i * MSTEP, col = n0 + on;
    if (row < f.mo && col < f.cout)
      out[(long long)row * f.cout + col] = (int8_t)requantize_channel(acc[i], col, rq);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum Layout { LAYOUT_T, LAYOUT_S, LAYOUT_W, LAYOUT_R };

// Dynamic shared memory of each layout; the wrapper mirrors these sums
// (conv_layouts.py smem_bytes) to refuse what does not fit.
inline size_t smem_bytes(Layout l, int bm, int bn, const Flat& f) {
  const int maxoff = (f.khp - 1) * f.wp + f.kwp - 1;
  switch (l) {
    case LAYOUT_S:
      return (size_t)(bm + maxoff + bn) * SROW;
    case LAYOUT_T:
      return (size_t)BK * (((bm + maxoff + 15) & ~15) + 16) + (size_t)(bm + bn) * SROW;
    case LAYOUT_R:
      return (size_t)(bm + (f.khp - 1) * f.wp + f.khp * bn) * SROW;
    case LAYOUT_W: {
      const int rows = w_rows(bm, maxoff);
      return (size_t)(rows + f.group * bn) * SROW +
             (size_t)rows * (f.group * bn + W_PPAD) * sizeof(int32_t);
    }
  }
  return 0;
}

template <Layout L, int BM, int BN>
void launch_layout_tile(const int8_t* x, const int8_t* w, int8_t* out, const Requant& rq,
                        const Flat& f, cudaStream_t stream) {
  auto kern = L == LAYOUT_S   ? qconv_s_kernel<BM, BN>
              : L == LAYOUT_T ? qconv_t_kernel<BM, BN>
              : L == LAYOUT_R ? qconv_r_kernel<BM, BN>
                              : qconv_w_kernel<BM, BN>;
  const int threads = L == LAYOUT_W ? W_THREADS : Tile<BM, BN>::NTHREADS;
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
  f.group = p[P_GROUP] > 0 ? p[P_GROUP] : 1;
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

TK_LAYOUT_ENTRY(tk_qconv_rq_t, tk::LAYOUT_T)
TK_LAYOUT_ENTRY(tk_qconv_rq_s, tk::LAYOUT_S)
TK_LAYOUT_ENTRY(tk_qconv_rq_w, tk::LAYOUT_W)
TK_LAYOUT_ENTRY(tk_qconv_rq_r, tk::LAYOUT_R)
