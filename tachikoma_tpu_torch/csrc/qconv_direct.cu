// K11 qconv_direct and K12 qdwconv_direct: the round-1 direct int8 conv,
// NHWC, with the exact requantize epilogue, storing int8 or uint8 bytes.
//
// K11 replaces tachikoma_tpu/ops/pallas/conv_int8.py _conv_kernel (groups 1,
// any kernel size, stride and padding); K12 replaces _dw_kernel (depthwise,
// groups == C, any kernel size and stride).  Entry on both packages:
// qconv2d_int8 (ops/kernels/conv_direct.py), reached by tune/tuner.py
// tune_conv.
//
//   acc[n, oy, ox, co] = sum_{ky, kx, ci} x_pad[n, oy*sh + ky, ox*sw + kx, ci] * w[ky, kx, ci, co]
//
// where taps outside the image read the input zero point izp; the wrapper
// folds - izp * colsum(w) into the bias (int32 wraparound), so the sum is
// that of (x_pad - izp) * w, as qnn.conv2d pads.  The epilogue is
// requantize.cuh's: clip(q_multiply_shift(acc + bias[c], m[c], s[c]) +
// out_zp, qmin, qmax), per-channel multiplier and shift, UPWARD or TONEAREST;
// the low byte of the clipped value is stored, so an int8 or a uint8 output
// (qmin 0, qmax 255) takes the same store.
//
// K11 (tensor cores, mma.sync m16n8k32 s8.s8.s32) follows the TPU kernel's
// data path, "im2col in VMEM": one block of four warps owns an 8 x 8 output
// tile of one image by 64 output channels.  For each chunk of CC input
// channels (CC = 4, 8, 16 or 32; the wrapper picks it from CIN and the shared
// memory) it stages, once, the tile's input window ((8-1)*sh + KH rows by
// (8-1)*sw + KW columns by CC bytes; 16-byte cp.async copies when CIN % 16 ==
// 0, else bytes; the halo and the channels past CIN hold izp) and the chunk's
// weights (KH*KW*CC rows, zero past CIN or the taps, transposed to [n][k] for
// the mma), then runs the KH*KW taps as one product of depth KD =
// KH*KW*CC rounded up to 32 into one int32 accumulator.  A table koff[k]
// gives the window offset of reduction index k = (tap, channel), so strided
// windows are read straight out of shared memory, and a CIN-3 stem packs
// its taps four channels at a time (7x7: KD 224, not 49 * 32).  The window
// of the next chunk is copied (cp.async) while the current one is
// multiplied; the epilogue runs once, after the last chunk.
//
// K12 (CUDA cores; depthwise has no tensor-core form) follows _dw_kernel's
// whole-window block, cut to fit shared memory: one block per (image, tile
// of TH output rows by TW output columns, 64 channels) stages the tile's
// ((TH-1)*sh + KH) x ((TW-1)*sw + KW) x 64 input window (16-byte copies when
// C % 16 == 0, halo izp) and the block's KH*KW x 64 weights; each thread then
// sums the taps of one output pixel for 4 neighbouring channels in int32 and
// runs the epilogue.  The wrapper picks TH and TW so the window stays within
// 64 KB.
//
// What bounds them on the H100: K11 the tensor cores at VGG-16's 3x3 convs
// (operations), K12 the bytes (one read of the image, one write of the
// output).  Simple and right first: mma.sync, not wgmma; no TMA.
#include <cuda_runtime.h>

#include <cstdint>

#include "params.cuh"
#include "qgemm.cuh"  // mma_s8, store_transposed (and requantize.cuh)

namespace tk {

constexpr int D_TH = 8, D_TW = 8;  // K11's output tile (rows x columns)
constexpr int D_BN = 64;           // K11's output channels per block
constexpr int D_THREADS = 128;     // four warps, one per 32 x 32 of the 64 x 64 tile
constexpr int DWD_THREADS = 256;
constexpr int DWD_CB = 64;  // K12's channels per block
constexpr size_t D_SMEM_LIMIT = 232448;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// K11 qconv_direct
// ---------------------------------------------------------------------------

struct DGeo {
  int n, h, w, cin, kh, kw, cout, oh, ow, sh, sw, pt, pl;
  int cc;              // input channels per staged chunk
  int kd;              // the chunk's reduction depth: KH*KW*CC rounded up to 32
  int wh, ww;          // the window's rows and columns
  int winb;            // the window's bytes, rounded up to 16
  int tiles_y, tiles_x;
  uint32_t izp4;       // the input zero point in each byte
  bool a_vec, b_vec;   // 16-byte window copies; 4-byte weight loads
};

// win[pixel][CC] = the window of chunk channels c0 .. c0 + CC of image xi,
// izp outside the image and past CIN.
__device__ __forceinline__ void stage_window(int8_t* win, const int8_t* __restrict__ xi, int iy0,
                                             int ix0, int c0, const DGeo& g) {
  if (g.a_vec) {
    const int per = g.cc >> 4;
    const int total = g.wh * g.ww * per;
    for (int e = threadIdx.x; e < total; e += D_THREADS) {
      const int pix = e / per, part = e - pix * per;
      const int r = pix / g.ww, col = pix - r * g.ww;
      const int iy = iy0 + r, ix = ix0 + col, c = c0 + part * 16;
      int8_t* dst = win + pix * g.cc + part * 16;
      if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w && c < g.cin)
        cp_async16(dst, xi + ((long long)iy * g.w + ix) * g.cin + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(g.izp4, g.izp4, g.izp4, g.izp4);
    }
    return;
  }
  const int per = g.cc >> 2;
  const int total = g.wh * g.ww * per;
  const uint32_t izp = g.izp4 & 0xffu;
  for (int e = threadIdx.x; e < total; e += D_THREADS) {
    const int pix = e / per, part = e - pix * per;
    const int r = pix / g.ww, col = pix - r * g.ww;
    const int iy = iy0 + r, ix = ix0 + col, c = c0 + part * 4;
    uint32_t v = g.izp4;
    if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w) {
      const int8_t* p = xi + ((long long)iy * g.w + ix) * g.cin;
      v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v |= (c + j < g.cin ? (uint32_t)(uint8_t)p[c + j] : izp) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(win + pix * g.cc + part * 4) = v;
  }
}

// bs[n][k] = w[tap][c0 + c][n0 + n] for k = tap * CC + c < KD (row stride
// KD + 16), zero past the taps, CIN or COUT.
__device__ __forceinline__ void stage_weights(int8_t* bs, const int8_t* __restrict__ w, int c0,
                                              int n0, const DGeo& g) {
  const int stride = g.kd + 16;
  const int ntaps = g.kh * g.kw;
  const int total = (g.kd >> 2) * (D_BN / 4);
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += D_THREADS) {
    const int nq = e & (D_BN / 4 - 1), k = (e / (D_BN / 4)) * 4;
    const int tap = k / g.cc, c = c0 + k - tap * g.cc, n = n0 + nq * 4;
    uint32_t v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[r] = 0;
      if (tap < ntaps && c + r < g.cin && n < g.cout) {
        const int8_t* p = w + ((long long)tap * g.cin + c + r) * g.cout + n;
        if (g.b_vec) {
          v[r] = *reinterpret_cast<const uint32_t*>(p);
        } else {
          for (int j = 0; j < 4 && n + j < g.cout; ++j) v[r] |= (uint32_t)(uint8_t)p[j] << (8 * j);
        }
      }
    }
    store_transposed(bs + nq * 4 * stride + k, stride, v);
  }
}

__global__ void __launch_bounds__(D_THREADS)
    qconv_direct_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        uint8_t* __restrict__ out, Requant rq, DGeo g) {
  extern __shared__ __align__(16) int8_t smem[];
  const int stride = g.kd + 16;
  int* koff = reinterpret_cast<int*>(smem);
  // two buffers each of the window and the weights: [koff | win0 win1 | bs0 bs1]
  int8_t* win_buf = smem + g.kd * 4;
  int8_t* bs_buf = win_buf + 2 * g.winb;

  const int tiles = g.tiles_y * g.tiles_x;
  const int img = blockIdx.x / tiles;
  const int t = blockIdx.x - img * tiles;
  const int oy0 = (t / g.tiles_x) * D_TH, ox0 = (t % g.tiles_x) * D_TW;
  const int iy0 = oy0 * g.sh - g.pt, ix0 = ox0 * g.sw - g.pl;
  const int n0 = blockIdx.y * D_BN;
  const int8_t* xi = x + (long long)img * g.h * g.w * g.cin;

  const int ntaps = g.kh * g.kw;
  for (int k = threadIdx.x; k < g.kd; k += D_THREADS) {
    const int tap = k / g.cc;
    koff[k] = tap < ntaps ? ((tap / g.kw) * g.ww + tap % g.kw) * g.cc + k - tap * g.cc : 0;
  }
  const int nch = (g.cin + g.cc - 1) / g.cc;
  stage_window(win_buf, xi, iy0, ix0, 0, g);
  cp_async_commit();
  stage_weights(bs_buf, w, 0, n0, g);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  // window offset of each of the thread's fragment rows (output pixels)
  int rb[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = wm + mt * 16 + gid + 8 * hh;
      rb[mt][hh] = ((m / D_TW) * g.sh * g.ww + (m % D_TW) * g.sw) * g.cc;
    }
  int32_t acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  for (int ch = 0; ch < nch; ++ch) {
    const int8_t* win = win_buf + (ch & 1) * g.winb;
    const int8_t* bs = bs_buf + (ch & 1) * D_BN * stride;
    const bool more = ch + 1 < nch;
    if (more) {
      stage_window(win_buf + ((ch + 1) & 1) * g.winb, xi, iy0, ix0, (ch + 1) * g.cc, g);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int k0 = 0; k0 < g.kd; k0 += 32) {
      const int ka = koff[k0 + tig * 4], kb = koff[k0 + 16 + tig * 4];
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        af[mt][0] = lds32(win + rb[mt][0] + ka);
        af[mt][1] = lds32(win + rb[mt][1] + ka);
        af[mt][2] = lds32(win + rb[mt][0] + kb);
        af[mt][3] = lds32(win + rb[mt][1] + kb);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* q = bs + (wn + nt * 8 + gid) * stride + k0 + tig * 4;
        bf[nt][0] = lds32(q);
        bf[nt][1] = lds32(q + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    // the other weight buffer was last read in the previous chunk, before
    // that chunk's closing barrier
    if (more) stage_weights(bs_buf + ((ch + 1) & 1) * D_BN * stride, w, (ch + 1) * g.cc, n0, g);
    __syncthreads();
  }

  // accumulator (gid + 8 (i >> 1), 2 tig + (i & 1)) of each m16n8 tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + mt * 16 + gid + (i >> 1) * 8;
        const int oy = oy0 + m / D_TW, ox = ox0 + m % D_TW;
        const int col = n0 + wn + nt * 8 + tig * 2 + (i & 1);
        if (oy < g.oh && ox < g.ow && col < g.cout)
          out[(((long long)img * g.oh + oy) * g.ow + ox) * g.cout + col] =
              (uint8_t)requantize_channel(acc[mt][nt][i], col, rq);
      }
}

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Launches K11 on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a chunk other than 4, 8, 16 or 32 channels, or
// shared memory above 227 KB).
int launch_qconv_direct(const int8_t* x, const int8_t* w, uint8_t* out, const int32_t* bias,
                        const int32_t* mult, const int32_t* shift, const int32_t* p,
                        void* stream) {
  DGeo g;
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
  g.cc = p[P_CC];
  if (g.cc != 4 && g.cc != 8 && g.cc != 16 && g.cc != 32) return (int)cudaErrorInvalidValue;
  g.kd = round_up(g.kh * g.kw * g.cc, 32);
  g.wh = (D_TH - 1) * g.sh + g.kh;
  g.ww = (D_TW - 1) * g.sw + g.kw;
  g.winb = round_up(g.wh * g.ww * g.cc, 16);
  g.tiles_y = (g.oh + D_TH - 1) / D_TH;
  g.tiles_x = (g.ow + D_TW - 1) / D_TW;
  g.izp4 = (uint32_t)(uint8_t)(int8_t)p[P_IZP] * 0x01010101u;
  g.a_vec = p[P_A_VEC] != 0 && g.cc >= 16;
  g.b_vec = p[P_B_VEC] != 0;
  const Requant rq{bias, mult, shift, 0, p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                   p[P_TONEAREST] != 0};
  const size_t smem = (size_t)g.kd * 4 + 2 * (size_t)g.winb + 2 * (size_t)D_BN * (g.kd + 16);
  const long long blocks = (long long)g.n * g.tiles_y * g.tiles_x;
  if (smem > D_SMEM_LIMIT || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || g.cout <= 0) return (int)cudaGetLastError();
  // raised once, at the first launch that needs more, never lowered
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    if (cudaFuncSetAttribute(qconv_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return (int)cudaGetLastError();
    granted = smem;
  }
  const dim3 grid((unsigned)blocks, (g.cout + D_BN - 1) / D_BN);
  qconv_direct_kernel<<<grid, D_THREADS, smem, (cudaStream_t)stream>>>(x, w, out, rq, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K12 qdwconv_direct
// ---------------------------------------------------------------------------

struct DwdGeo {
  int n, h, w, c, kh, kw, oh, ow, sh, sw, pt, pl;
  int th, tw;          // the block's output tile
  int wh, ww;          // its input window
  int tiles_y, tiles_x;
  uint32_t izp4;
  bool a_vec;          // C % 16 == 0 and x 16-byte aligned: 16-byte window copies
  bool o_vec;          // C % 4 == 0 and out 4-byte aligned: 4-byte stores
};

// K = KH = KW known at compile time (3: the taps' weights live in registers
// and the tap loops unroll), or 0 for any size.
template <int K>
__global__ void __launch_bounds__(DWD_THREADS)
    qdwconv_direct_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                          uint8_t* __restrict__ out, Requant rq, DwdGeo g) {
  extern __shared__ __align__(16) int8_t smem[];
  const int kh = K ? K : g.kh, kw = K ? K : g.kw;
  int8_t* win = smem;                               // [row][column][64 channels]
  int8_t* ws = smem + g.wh * g.ww * DWD_CB;         // [tap][64 channels]
  const int tiles = g.tiles_y * g.tiles_x;
  const int img = blockIdx.x / tiles;
  const int t = blockIdx.x - img * tiles;
  const int oy0 = (t / g.tiles_x) * g.th, ox0 = (t % g.tiles_x) * g.tw;
  const int iy0 = oy0 * g.sh - g.pt, ix0 = ox0 * g.sw - g.pl;
  const int c0 = blockIdx.y * DWD_CB;
  const int8_t* xi = x + (long long)img * g.h * g.w * g.c;

  for (int i = threadIdx.x; i < kh * kw * DWD_CB; i += DWD_THREADS) {
    const int tap = i / DWD_CB, cc = c0 + i % DWD_CB;
    ws[i] = cc < g.c ? w[(long long)tap * g.c + cc] : 0;
  }
  const uint32_t izp = g.izp4 & 0xffu;
  for (int e = threadIdx.x; e < g.wh * g.ww * 4; e += DWD_THREADS) {
    const int pix = e >> 2, cc = c0 + (e & 3) * 16;
    const int r = pix / g.ww, col = pix - r * g.ww;
    const int iy = iy0 + r, ix = ix0 + col;
    int8_t* dst = win + pix * DWD_CB + (e & 3) * 16;
    const bool in = (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w && cc < g.c;
    const int8_t* src = xi + ((long long)iy * g.w + ix) * g.c + cc;
    if (in && g.a_vec) {
      cp_async16(dst, src);
    } else if (in) {
      uint32_t v[4] = {0, 0, 0, 0};
      for (int j = 0; j < 16; ++j)
        v[j >> 2] |= (cc + j < g.c ? (uint32_t)(uint8_t)src[j] : izp) << ((j & 3) * 8);
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(g.izp4, g.izp4, g.izp4, g.izp4);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cl = (threadIdx.x & 15) * 4, slot = threadIdx.x >> 4;
  const int c = c0 + cl;
  if (c >= g.c) return;
  char4 wr[K ? K * K : 1];
  if (K) {
#pragma unroll
    for (int i = 0; i < K * K; ++i) wr[i] = *reinterpret_cast<const char4*>(ws + i * DWD_CB + cl);
  }
  for (int p = slot; p < g.th * g.tw; p += DWD_THREADS / 16) {
    const int oy = p / g.tw, ox = p - oy * g.tw;
    const int goy = oy0 + oy, gox = ox0 + ox;
    if (goy >= g.oh || gox >= g.ow) continue;
    const int8_t* base = win + ((oy * g.sh) * g.ww + ox * g.sw) * DWD_CB + cl;
    uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ky = 0; ky < kh; ++ky)
#pragma unroll
      for (int kx = 0; kx < kw; ++kx) {
        const char4 xv = *reinterpret_cast<const char4*>(base + (ky * g.ww + kx) * DWD_CB);
        const char4 wv = K ? wr[K ? ky * K + kx : 0]
                           : *reinterpret_cast<const char4*>(ws + (ky * kw + kx) * DWD_CB + cl);
        acc[0] += (uint32_t)(xv.x * wv.x);
        acc[1] += (uint32_t)(xv.y * wv.y);
        acc[2] += (uint32_t)(xv.z * wv.z);
        acc[3] += (uint32_t)(xv.w * wv.w);
      }
    uint8_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < g.c ? (uint8_t)requantize_channel((int32_t)acc[j], c + j, rq) : 0;
    uint8_t* dst = out + (((long long)img * g.oh + goy) * g.ow + gox) * g.c + c;
    if (g.o_vec) {
      *reinterpret_cast<uchar4*>(dst) = make_uchar4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < 4 && c + j < g.c; ++j) dst[j] = v[j];
    }
  }
}

template <int K>
int launch_dwd(const int8_t* x, const int8_t* w, uint8_t* out, const Requant& rq,
               const DwdGeo& g, size_t smem, unsigned blocks, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    if (cudaFuncSetAttribute(qdwconv_direct_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return (int)cudaGetLastError();
    granted = smem;
  }
  const dim3 grid(blocks, (g.c + DWD_CB - 1) / DWD_CB);
  qdwconv_direct_kernel<K><<<grid, DWD_THREADS, smem, stream>>>(x, w, out, rq, g);
  return (int)cudaGetLastError();
}

// Launches K12 on `stream` at the tile (P_TH, P_TW) and returns
// cudaGetLastError() (cudaErrorInvalidValue when the window and weights
// exceed 227 KB of shared memory).
int launch_qdwconv_direct(const int8_t* x, const int8_t* w, uint8_t* out, const int32_t* bias,
                          const int32_t* mult, const int32_t* shift, const int32_t* p,
                          void* stream) {
  DwdGeo g;
  g.n = p[P_N];
  g.h = p[P_H];
  g.w = p[P_W];
  g.c = p[P_CIN];
  g.kh = p[P_KH];
  g.kw = p[P_KW];
  g.oh = p[P_OH];
  g.ow = p[P_OW];
  g.sh = p[P_SH];
  g.sw = p[P_SW];
  g.pt = p[P_PT];
  g.pl = p[P_PL];
  g.th = p[P_TH];
  g.tw = p[P_TW];
  if (g.th <= 0 || g.tw <= 0) return (int)cudaErrorInvalidValue;
  g.wh = (g.th - 1) * g.sh + g.kh;
  g.ww = (g.tw - 1) * g.sw + g.kw;
  g.tiles_y = (g.oh + g.th - 1) / g.th;
  g.tiles_x = (g.ow + g.tw - 1) / g.tw;
  g.izp4 = (uint32_t)(uint8_t)(int8_t)p[P_IZP] * 0x01010101u;
  g.a_vec = p[P_A_VEC] != 0;
  g.o_vec = p[P_B_VEC] != 0;
  const Requant rq{bias, mult, shift, 0, p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                   p[P_TONEAREST] != 0};
  const size_t smem = ((size_t)g.wh * g.ww + (size_t)g.kh * g.kw) * DWD_CB;
  const long long blocks = (long long)g.n * g.tiles_y * g.tiles_x;
  if (smem > D_SMEM_LIMIT || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || g.c <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.kh == 3 && g.kw == 3) return launch_dwd<3>(x, w, out, rq, g, smem, (unsigned)blocks, s);
  return launch_dwd<0>(x, w, out, rq, g, smem, (unsigned)blocks, s);
}

}  // namespace tk

extern "C" int tk_qconv_direct(const int8_t* x, const int8_t* w, uint8_t* out,
                               const int32_t* bias, const int32_t* mult, const int32_t* shift,
                               const int32_t* params, void* stream) {
  return tk::launch_qconv_direct(x, w, out, bias, mult, shift, params, stream);
}

extern "C" int tk_qdwconv_direct(const int8_t* x, const int8_t* w, uint8_t* out,
                                 const int32_t* bias, const int32_t* mult, const int32_t* shift,
                                 const int32_t* params, void* stream) {
  return tk::launch_qdwconv_direct(x, w, out, bias, mult, shift, params, stream);
}
