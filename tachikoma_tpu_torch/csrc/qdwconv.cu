// K5 qdwconv_rq / qdwconv_raw: depthwise int8 or uint8 convolution, NHWC,
// any kernel size, stride, dilation and padding (top, left, bottom, right).
//
//   acc[n, oy, ox, c] = sum_{ky, kx} (x_pad[n, oy*sh + ky*dh, ox*sw + kx*dw, c] - izp)
//                                    * (w[ky, kx, 0, c] - kzp[c])
//
// where taps outside the image read izp, so they add 0.  x is int8, or uint8
// (P_A_U8: legacy uint8 models, izp 0..255); kzp, where not null, is the
// weights' zero point a channel (uint8 weights arrive as int8 w - 128 with
// kzp - 128, the same differences); a uint8 output is the same bytes at
// qmin 0, qmax 255.
//   * qdwconv_rq (RAW = false): the requantize.cuh epilogue of K1-K3 with
//     per-channel multiplier and shift (ReLU6 arrives as qmin / qmax) -> int8.
//   * qdwconv_raw (RAW = true): acc + bias[c] in int32 wraparound -> int32,
//     like K4's RAW epilogue.
//
// qdwconv_rq replaces tachikoma_tpu/ops/pallas/conv_flat.py _flat_dw_kernel
// (built by _build_flat_dw, driven by _conv_dw_vpu, entry qconv2d_flat with
// groups == C): the 17 depthwise convs of a fused MobileNetV2 forward.
//   * qdwconv_direct (K12, tk_qdwconv_direct) replaces
//     tachikoma_tpu/ops/pallas/conv_int8.py _dw_kernel (entry qconv2d_int8
//     with groups == C, reached by tune/tuner.py tune_conv): the requantize
//     mode with rq_izp = 0 and an int8 or uint8 output.  Its first port
//     (qconv_direct.cu, PR 6: a thread per pixel x 4 channels, nine 4-byte
//     window loads a pixel, the int64 epilogue, a 64 KB window budget) ran
//     MobileNetV2 b8's 17 calls in 0.1936 ms against this body's 0.1046
//     (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W); it now launches
//     this body at dw_plan's tile.
// qdwconv_raw is the port's counterpart of the JAX package's unfused grouped
// qnn.conv2d (ops/jax_ops.py, lax.conv with feature_group_count), which has
// no Pallas kernel: the 17 grouped convs of the unfused (trace) graph.
//
// What bounds it on an H100: bytes.  MobileNetV2 b8 224^2 moves 48.6 MB
// through its 17 depthwise calls (each input byte read once, each output
// written once: 14.5 us at 3.35 TB/s) for 0.17 G multiply-adds; at b1 each
// call is a few microseconds of launch and one trip to memory.  The first
// design (a thread per pixel x 4 channels, each of the nine taps its
// own 4-byte load through L1) ran 13x that bound; tools/dw_probe.py cut it
// apart: the loads were 30% of its time, the int64 requantize 14%, the
// launch and grid alone 15% at b8 and 30% at b1.
//
// Design.  A block owns a tile of TH output rows x TW output columns x CT
// channels (CT = 16, 32, 48 or 64) of one image and stages its input window,
// ((TH-1) sh + KH) rows x ((TW-1) sw + KW) columns x CT channels, in shared
// memory once: 16-byte cp.async copies where C % 16 == 0 (byte copies
// otherwise); window positions outside the image are filled with izp, so the
// taps need no bounds test and sum x * w, and izp * sum(w) is taken off once
// per channel (exact in uint32, like the oracle's int32).  A thread owns 4
// channels (one 32-bit word of the window) and a strip of R = 4 output
// pixels along x: for 3x3 it reads R + 2 window columns a row at stride 1
// (2R + 1 at stride 2), not 9R taps, sign-extends each byte once (prmt),
// and holds the nine taps x 4 channels of weights and the per-channel
// epilogue constants (bias - rq_izp, multiplier, shifts and rounding) in
// registers.  Other kernel sizes keep the weights in shared memory and read
// each tap from the window.  The window's row pitch is padded so that a
// warp's reads fall on distinct banks.  ops/kernels/depthwise.py dw_plan
// picks the tile: blocks of about 128 threads, two strips wide, up to 8
// rows tall (tools/dw_probe.py --plans: at the b1 calls too, where such a
// grid leaves SMs idle, smaller blocks that fill the card ran slower).
// Depthwise has no reduction over channels, so there is no tensor-core form
// to seek.
//
// Range: |x - izp| <= 255 and |w - kzp| <= 255, so a 3x3 tap sum stays
// below 2^20; the accumulator is summed in uint32, so even a kernel deep
// enough to wrap wraps as the oracle's int32 does.  izp is a zero point of
// x's type (the window's fill byte).  A tap is x times (w - kzp), the
// weight less its zero point when the thread loads it, and izp * sum(w -
// kzp) comes off once a channel, as at kzp 0.
//
// Dilation (DeepLab-MobileNetV2's atrous depthwise convs): tap (ky, kx)
// reads window row ty sh + ky dh and column x sw + kx dw, the window spans
// (TH - 1) sh + (KH - 1) dh + 1 rows (depthwise.py dw_plan sizes it alike),
// and a dilated call runs the generic body (the weights in shared memory,
// each tap read from the window); the 3x3 body reuses a row's columns
// across the strip only undilated.
//
// qdwconv_wide (tk_qdwconv_wide: the body with T = int16_t) is W8A16's
// depthwise qnn.conv2d into int64 (the JAX package's grouped qnn.conv2d on
// XLA, ops/jax_ops.py _qconv2d_jax; no Pallas kernel): int16 data, int8
// weights, no bias.  The window holds int16 (8 bytes a thread's 4 channels,
// izp's 16 bits where the image is not; 16-byte copies where C % 8 == 0),
// and a tap is x * w in int32.  Depthwise sums no channels, so it needs no
// byte planes: |x - izp| <= 65535 and |w| <= 128, so each term is below
// 2^23 and a sum of up to 256 taps (DW_WIDE_TAPS) is exact in int32; the
// uint32 sum minus izp * sum(w) is that int32, stored sign-extended as
// int64.  The launch refuses more taps.  A dilated call (DeepLab-
// MobileNetV2's atrous convs at W8A16) runs the generic body as K5's int8
// modes do.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "params.cuh"
#include "requantize.cuh"

// The parts that tools/dw_probe.py cuts out, one at a time, to see what sets
// the kernel's time (each is 1 in the kernel as it runs).
#define DW_STAGE_INPUT 1  // 0: the window is not staged (its taps read what shared memory holds)
#define DW_EPILOGUE 1     // 0: the accumulator is stored as it is
#define DW_BODY 1         // 0: the kernel returns as it starts

namespace tk {

constexpr int DW_R = 4;  // output pixels a thread, along x
constexpr int DW_MAX_SMEM = 227 * 1024;
constexpr int DW_WIDE_TAPS = 256;  // (2^31 - 1) / (65535 * 128): qdwconv_wide's exact taps

struct DwGeo {
  int n, h, w, c, kh, kw, oh, ow, sh, sw, pt, pl, izp;
  int dh, dw;            // the dilation
  int ct, th, tw;        // a block's tile: channels, output rows, output columns
  int ih, iw, rp;        // its input window: rows, columns, row pitch in 4-byte words
  int tiles_x, tiles_y;  // output tiles along x and y (the grid's x is images x tiles)
  bool vec16;            // x 16-byte aligned and C a whole number of 16-byte copies
  bool vec4;             // C % 4 == 0 and x, w 4-byte aligned: word loads and stores
};

// The per-channel constants of the requantize epilogue, computed once: the
// arithmetic of requantize.cuh q_multiply_shift, with (acc + bias) - rq_izp
// folded into acc + (bias - rq_izp) (both wrap in uint32).
struct DwRq {
  uint32_t bz;     // bias - rq_izp (RAW: bias)
  uint64_t m;      // the multiplier, sign-extended
  uint64_t round;  // 2^(tr - 1)
  int left, tr;    // max(s, 0), 31 + max(-s, 0)
};

// Byte e of `word`, sign-extended: prmt's default mode, result byte 0 the
// byte itself (selector nibble e), bytes 1-3 its sign (nibble 8 | e: the high
// bit replicates the sign; __byte_perm reads only the low 3 bits).
__device__ __forceinline__ int32_t sext_byte(uint32_t word, int e) {
  int32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(word), "r"(0x8880u + 0x1111u * (uint32_t)e));
  return r;
}

__device__ __forceinline__ int32_t dw_requantize(uint32_t acc, const DwRq& r, const Requant& p) {
  uint64_t v = (uint64_t)(int64_t)(int32_t)(acc + r.bz) << r.left;
  v *= r.m;
  uint64_t round = r.round;
  if (p.tonearest && (int64_t)v < 0) round -= 1;
  v += round;
  const int32_t q = wrap_add((int32_t)(uint32_t)(uint64_t)((int64_t)v >> r.tr), p.out_zp);
  return min(max(q, p.qmin), p.qmax);
}

// 4 channels of the window at `p` (int8: one word, sign-extended; uint8:
// one word, zero-extended; int16: two, sign-extended).
template <typename T>
__device__ __forceinline__ void dw_load4(const uint32_t* p, int32_t (&v)[4]) {
  if constexpr (std::is_same_v<T, uint8_t>) {
    const uint32_t word = *p;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (int32_t)((word >> (8 * e)) & 255u);
  } else if constexpr (sizeof(T) == 1) {
    const uint32_t word = *p;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = sext_byte(word, e);
  } else {
    const uint2 d = *reinterpret_cast<const uint2*>(p);
    v[0] = (int32_t)(int16_t)(d.x & 0xffffu);
    v[1] = (int32_t)d.x >> 16;
    v[2] = (int32_t)(int16_t)(d.y & 0xffffu);
    v[3] = (int32_t)d.y >> 16;
  }
}

// The block's input window into shared memory (`win`, [ih][rp] words, each
// position CT * sizeof(T) / 4 words of channels), izp outside the image and
// past C.
template <typename T>
__device__ __forceinline__ void dw_stage(uint32_t* win, const T* __restrict__ x, int img,
                                         int iy0, int ix0, int c0, const DwGeo& g) {
  const uint32_t fill = sizeof(T) == 1 ? (uint32_t)(uint8_t)g.izp * 0x01010101u
                                       : (uint32_t)(uint16_t)g.izp * 0x00010001u;
  const int cw = g.ct * (int)sizeof(T) / 4;
  const T* xi = x + (long long)img * g.h * g.w * g.c;
  if (g.vec16) {
    const int cq = g.ct * (int)sizeof(T) / 16;  // 16-byte chunks a position
    constexpr int CH = 16 / sizeof(T);          // channels a chunk
    const int total = g.ih * g.iw * cq;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int q = i % cq, pos = i / cq;
      const int r = pos / g.iw, col = pos - r * g.iw;
      const int iy = iy0 + r, ix = ix0 + col, ch = c0 + CH * q;
      uint32_t* dst = win + r * g.rp + col * cw + 4 * q;
      if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w && ch < g.c) {
        const T* src = xi + ((long long)iy * g.w + ix) * g.c + ch;
        const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(fill, fill, fill, fill);
      }
    }
    asm volatile("cp.async.commit_group;");
  } else {
    T* wb = reinterpret_cast<T*>(win);
    const int total = g.ih * g.iw * g.ct;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int cc = i % g.ct, pos = i / g.ct;
      const int r = pos / g.iw, col = pos - r * g.iw;
      const int iy = iy0 + r, ix = ix0 + col, ch = c0 + cc;
      const bool in = (unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w && ch < g.c;
      wb[(r * g.rp + col * cw) * (4 / (int)sizeof(T)) + cc] =
          in ? xi[((long long)iy * g.w + ix) * g.c + ch] : (T)g.izp;
    }
  }
}

// 4 channels of tap `tap` of w (KH, KW, 1, C) as one word, 0 past C.
__device__ __forceinline__ uint32_t dw_weight_word(const int8_t* __restrict__ w, int tap, int c,
                                                   const DwGeo& g) {
  const int8_t* p = w + (long long)tap * g.c + c;
  if (g.vec4) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < g.c) v |= (uint32_t)(uint8_t)p[e] << (8 * e);
  return v;
}

// `out` is int8 (N, OH, OW, C), or int32 when RAW; int64 for T = int16_t
// (qdwconv_wide: RAW with no bias).  K = KH = KW = 3 with the column stride
// SW known at compile time (MobileNetV2's convs: the weights live in
// registers and the window's columns are reused across the strip), or K = 0
// for any size and stride (the weights in shared memory after the window).
template <bool RAW, int K, int SW, typename T = int8_t>
__global__ void __launch_bounds__(256)
    qdwconv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   void* __restrict__ out, const int32_t* __restrict__ kzp, Requant rq,
                   DwGeo g) {
  constexpr bool WIDE = sizeof(T) == 2;
  static_assert(!WIDE || RAW, "the int16 mode stores the raw sum");
  extern __shared__ __align__(16) uint32_t win[];
#if !DW_BODY
  if (g.n >= 0) return;
#endif
  const int kh = K ? K : g.kh, kw = K ? K : g.kw, sw = SW ? SW : g.sw;
  const int cw_n = g.ct >> 2;                    // 4-channel groups a position
  const int wp = cw_n * (int)sizeof(T);          // window words a position
  int bx = blockIdx.x;
  const int tx = bx % g.tiles_x;
  bx /= g.tiles_x;
  const int tyb = bx % g.tiles_y, img = bx / g.tiles_y;
  const int c0 = blockIdx.y * g.ct, oy0 = tyb * g.th, ox0 = tx * g.tw;

#if DW_STAGE_INPUT
  dw_stage(win, x, img, oy0 * g.sh - g.pt, ox0 * sw - g.pl, c0, g);
#endif
  uint32_t* ws = win + g.ih * g.rp;  // K = 0: [tap][CT / 4] words of weights
  if (K == 0)
    for (int i = threadIdx.x; i < kh * kw * cw_n; i += blockDim.x) {
      const int tap = i / cw_n, q = i - tap * cw_n;
      ws[i] = c0 + 4 * q < g.c ? dw_weight_word(w, tap, c0 + 4 * q, g) : 0u;
    }

  const int cw = threadIdx.x % cw_n, rest = threadIdx.x / cw_n;
  const int ty = rest % g.th, sx = rest / g.th;
  const int c = c0 + 4 * cw, oy = oy0 + ty, ox = ox0 + sx * DW_R;
  const bool live = c < g.c && oy < g.oh && ox < g.ow;

  // the thread's weights (3x3) and epilogue constants, loaded while the
  // window's copies are in flight
  int32_t wt[K ? K * K : 1][4];
  uint32_t wsum[4] = {0, 0, 0, 0};
  int32_t wz[4] = {0, 0, 0, 0};  // the weights' zero point of each channel
  DwRq rc[4];
  if (live) {
    if (kzp != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wz[e] = c + e < g.c ? kzp[c + e] : 0;
    }
    if (K) {
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const uint32_t word = dw_weight_word(w, tap, c, g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wt[tap][e] = sext_byte(word, e) - wz[e];
          wsum[e] += (uint32_t)wt[tap][e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ce = c + e < g.c ? c + e : c;
      rc[e].bz = WIDE ? 0u
                 : RAW  ? (uint32_t)rq.bias[ce]
                        : (uint32_t)rq.bias[ce] - (uint32_t)rq.rq_izp;
      if (!RAW) {
        const int s = rq.shift[ce];
        rc[e].m = (uint64_t)(int64_t)rq.mult[ce];
        rc[e].left = s > 0 ? s : 0;
        rc[e].tr = 31 + (s < 0 ? -s : 0);
        rc[e].round = (uint64_t)1 << (rc[e].tr - 1);
      }
    }
  }
#if DW_STAGE_INPUT
  if (g.vec16) asm volatile("cp.async.wait_all;" ::: "memory");
#endif
  __syncthreads();
  if (!live) return;

  uint32_t acc[DW_R][4];
#pragma unroll
  for (int j = 0; j < DW_R; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0u;
  const uint32_t* row0 = win + ty * g.sh * g.rp + sx * DW_R * sw * wp + cw * (int)sizeof(T);
  if (K) {
    constexpr int NCOL = (DW_R - 1) * (SW ? SW : 1) + K;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      int32_t xv[NCOL][4];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) dw_load4<T>(row0 + ky * g.rp + i * wp, xv[i]);
#pragma unroll
      for (int j = 0; j < DW_R; ++j)
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] += (uint32_t)(xv[j * SW + kx][e] * wt[ky * K + kx][e]);
    }
  } else {
    for (int tap = 0; tap < kh * kw; ++tap) {
      const int ky = tap / kw, kx = tap - ky * kw;
      const uint32_t wword = ws[tap * cw_n + cw];
      int32_t wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wv[e] = sext_byte(wword, e) - wz[e];
        wsum[e] += (uint32_t)wv[e];
      }
#pragma unroll
      for (int j = 0; j < DW_R; ++j) {
        int32_t xv[4];
        dw_load4<T>(row0 + ky * g.dh * g.rp + (j * sw + kx * g.dw) * wp, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += (uint32_t)(xv[e] * wv[e]);
      }
    }
  }

  // the window holds izp where the image does not: take izp * sum(w) off
  uint32_t zw[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) zw[e] = (uint32_t)g.izp * wsum[e];
  const long long pix0 = ((long long)img * g.oh + oy) * g.ow + ox;
#pragma unroll
  for (int j = 0; j < DW_R; ++j) {
    if (ox + j >= g.ow) break;
    const long long o = (pix0 + j) * g.c + c;
    if constexpr (WIDE) {  // the exact int32 sum, sign-extended
      long long v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = (int32_t)(acc[j][e] - zw[e]);
      long long* dst = static_cast<long long*>(out) + o;
      if (g.vec4) {
        reinterpret_cast<longlong2*>(dst)[0] = make_longlong2(v[0], v[1]);
        reinterpret_cast<longlong2*>(dst)[1] = make_longlong2(v[2], v[3]);
      } else {
        for (int e = 0; e < 4 && c + e < g.c; ++e) dst[e] = v[e];
      }
    } else if constexpr (RAW) {
      int32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = DW_EPILOGUE ? (int32_t)(acc[j][e] - zw[e] + rc[e].bz) : (int32_t)acc[j][e];
      int32_t* dst = static_cast<int32_t*>(out) + o;
      if (g.vec4) {
        *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
        for (int e = 0; e < 4 && c + e < g.c; ++e) dst[e] = v[e];
      }
    } else {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int32_t v = DW_EPILOGUE ? dw_requantize(acc[j][e] - zw[e], rc[e], rq)
                                      : (int32_t)acc[j][e];
        packed |= (uint32_t)(uint8_t)v << (8 * e);
      }
      int8_t* dst = static_cast<int8_t*>(out) + o;
      if (g.vec4) {
        *reinterpret_cast<uint32_t*>(dst) = packed;
      } else {
        for (int e = 0; e < 4 && c + e < g.c; ++e) dst[e] = (int8_t)(packed >> (8 * e));
      }
    }
  }
}

template <bool RAW, int K, int SW, typename T>
int launch_dw(const T* x, const int8_t* w, void* out, const int32_t* kzp, const Requant& rq,
              const DwGeo& g, dim3 grid, int threads, size_t smem, cudaStream_t st) {
  // once per instantiation (and so never inside a CUDA-graph capture, which
  // follows a warm-up call)
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        qdwconv_kernel<RAW, K, SW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  qdwconv_kernel<RAW, K, SW, T><<<grid, threads, smem, st>>>(x, w, out, kzp, rq, g);
  return (int)cudaGetLastError();
}

// Launches on `stream` at the tile the wrapper planned (P_CC channels,
// P_TH x P_TW outputs, window row pitch P_RP words; depthwise.py dw_plan)
// and returns cudaGetLastError(); cudaErrorInvalidValue for a tile K5 does
// not take (CT not one of 16, 32, 48, 64; TW not a multiple of 4; more than
// 256 threads; a row pitch below the window's width or not a multiple of 4;
// the window and weights above 227 KB), an izp outside T, more than
// 2^31 output pixels, or (T = int16_t) more than DW_WIDE_TAPS taps.  With
// RAW, `mult` and `shift` are not read; with T = int16_t, `bias` neither.
// kzp: null, or the weights' zero point a channel.
template <bool RAW, typename T = int8_t>
int launch_qdwconv(const T* x, const int8_t* w, void* out, const int32_t* bias,
                   const int32_t* mult, const int32_t* shift, const int32_t* kzp,
                   const int32_t* p, void* stream) {
  constexpr bool WIDE = sizeof(T) == 2;
  DwGeo g;
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
  g.dh = p[P_DH] ? p[P_DH] : 1;
  g.dw = p[P_DW] ? p[P_DW] : 1;
  g.izp = p[P_IZP];
  g.vec4 = p[P_A_VEC] != 0;
  g.vec16 = p[P_B_VEC] != 0;
  g.ct = p[P_CC];
  g.th = p[P_TH];
  g.tw = p[P_TW];
  g.rp = p[P_DW_RP];
  const Requant rq{bias, mult, shift, p[P_RQ_IZP], p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                   p[P_TONEAREST] != 0};
  const long long npix = (long long)g.n * g.oh * g.ow;
  constexpr int zlo = std::is_same_v<T, uint8_t> ? 0 : WIDE ? -32768 : -128;
  constexpr int zhi = std::is_same_v<T, uint8_t> ? 255 : WIDE ? 32767 : 127;
  if (npix >= (1LL << 31) || g.izp < zlo || g.izp > zhi || g.dh < 1 || g.dw < 1 ||
      (WIDE && (long long)g.kh * g.kw > DW_WIDE_TAPS))
    return (int)cudaErrorInvalidValue;
  if (npix == 0 || g.c == 0) return (int)cudaGetLastError();
  if ((g.ct != 16 && g.ct != 32 && g.ct != 48 && g.ct != 64) || g.th < 1 || g.tw < DW_R ||
      g.tw % DW_R || (g.vec16 && g.c * (int)sizeof(T) % 16))
    return (int)cudaErrorInvalidValue;
  g.ih = (g.th - 1) * g.sh + (g.kh - 1) * g.dh + 1;
  g.iw = (g.tw - 1) * g.sw + (g.kw - 1) * g.dw + 1;
  g.tiles_y = (g.oh + g.th - 1) / g.th;
  g.tiles_x = (g.ow + g.tw - 1) / g.tw;
  const int threads = (g.ct / 4) * g.th * (g.tw / DW_R);
  const int wp = g.ct / 4 * (int)sizeof(T);  // window words a position
  const bool k3 = g.kh == 3 && g.kw == 3 && (g.sw == 1 || g.sw == 2) && g.dh == 1 && g.dw == 1;
  const size_t smem =
      4 * ((size_t)g.ih * g.rp + (k3 ? 0 : (size_t)g.kh * g.kw * (g.ct / 4)));
  if (threads > 256 || g.rp < g.iw * wp || g.rp % 4 || smem > (size_t)DW_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long bx = (long long)g.n * g.tiles_y * g.tiles_x;
  const long long by = (g.c + g.ct - 1) / g.ct;
  if (bx > 0x7fffffffLL || by > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by);
  cudaStream_t st = (cudaStream_t)stream;
  if (k3 && g.sw == 1)
    return launch_dw<RAW, 3, 1, T>(x, w, out, kzp, rq, g, grid, threads, smem, st);
  if (k3) return launch_dw<RAW, 3, 2, T>(x, w, out, kzp, rq, g, grid, threads, smem, st);
  return launch_dw<RAW, 0, 0, T>(x, w, out, kzp, rq, g, grid, threads, smem, st);
}

}  // namespace tk

// K5's modes: x int8, or uint8 where P_A_U8 is set; kzp null or (C,).
extern "C" int tk_qdwconv_rq(const int8_t* x, const int8_t* w, int8_t* out, const int32_t* bias,
                             const int32_t* mult, const int32_t* shift, const int32_t* kzp,
                             const int32_t* params, void* stream) {
  if (params[tk::P_A_U8])
    return tk::launch_qdwconv<false, uint8_t>(reinterpret_cast<const uint8_t*>(x), w, out, bias,
                                              mult, shift, kzp, params, stream);
  return tk::launch_qdwconv<false>(x, w, out, bias, mult, shift, kzp, params, stream);
}

extern "C" int tk_qdwconv_raw(const int8_t* x, const int8_t* w, int32_t* out,
                              const int32_t* bias, const int32_t* kzp, const int32_t* params,
                              void* stream) {
  if (params[tk::P_A_U8])
    return tk::launch_qdwconv<true, uint8_t>(reinterpret_cast<const uint8_t*>(x), w, out, bias,
                                             nullptr, nullptr, kzp, params, stream);
  return tk::launch_qdwconv<true>(x, w, out, bias, nullptr, nullptr, kzp, params, stream);
}

// K12 qdwconv_direct: K5's requantize mode with rq_izp = 0, storing the low
// byte of the clipped value, so an int8 or a uint8 output (qmin 0, qmax 255)
// takes the same store.  The bias arrives as the caller's (the kernel takes
// izp * sum(w) off, as for K5).
extern "C" int tk_qdwconv_direct(const int8_t* x, const int8_t* w, uint8_t* out,
                                 const int32_t* bias, const int32_t* mult, const int32_t* shift,
                                 const int32_t* params, void* stream) {
  int32_t p[tk::P_COUNT];
  for (int i = 0; i < tk::P_COUNT; ++i) p[i] = params[i];
  p[tk::P_RQ_IZP] = 0;
  p[tk::P_DH] = p[tk::P_DW] = 0;
  return tk::launch_qdwconv<false>(x, w, out, bias, mult, shift, nullptr, p, stream);
}

// qdwconv_wide: int16 x (N, H, W, C), int8 w (KH, KW, 1, C) -> int64 (N, OH,
// OW, C), sum (x_pad - izp) * w with izp an int16 zero point and no bias, at
// most DW_WIDE_TAPS taps, at the dilation (P_DH, P_DW; 0 means 1).
extern "C" int tk_qdwconv_wide(const int16_t* x, const int8_t* w, int64_t* out,
                               const int32_t* params, void* stream) {
  return tk::launch_qdwconv<true, int16_t>(x, w, out, nullptr, nullptr, nullptr, nullptr,
                                           params, stream);
}
