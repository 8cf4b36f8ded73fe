// K5 qdwconv_rq / qdwconv_raw: depthwise int8 convolution, NHWC, any kernel
// size, stride and padding (top, left, bottom, right).
//
//   acc[n, oy, ox, c] = sum_{ky, kx} (x_pad[n, oy*sh + ky, ox*sw + kx, c] - izp) * w[ky, kx, 0, c]
//
// where taps outside the image read izp, so they add 0.
//   * qdwconv_rq (RAW = false): the requantize.cuh epilogue of K1-K3 with
//     per-channel multiplier and shift (ReLU6 arrives as qmin / qmax) -> int8.
//   * qdwconv_raw (RAW = true): acc + bias[c] in int32 wraparound -> int32,
//     like K4's RAW epilogue.
//
// qdwconv_rq replaces tachikoma_tpu/ops/pallas/conv_flat.py _flat_dw_kernel
// (built by _build_flat_dw, driven by _conv_dw_vpu, entry qconv2d_flat with
// groups == C): the 17 depthwise convs of a fused MobileNetV2 forward.
// qdwconv_raw is the port's counterpart of the JAX package's unfused grouped
// qnn.conv2d (ops/jax_ops.py, lax.conv with feature_group_count), which has
// no Pallas kernel: the 17 grouped convs of the unfused (trace) graph.
//
// The TPU kernel stacks the stride phases of a padded, flattened image and
// pads channels to 128 lanes; none of that is needed here.  Depthwise has no
// tensor-core form, so CUDA cores do the work, in a simple design: a block of
// 256 threads covers up to 32 groups of 4 channels (a channel tile) of
// 256 / groups output pixels; each thread computes one pixel x 4 channels,
// reading each tap as one char4 when C % 4 == 0 (else byte by byte, masked
// at C), with the accumulator in registers and the block's weights
// (KH * KW taps x its channels) in shared memory.  When C <= 128 the block
// reads and writes one contiguous run of NHWC memory.
//
// Range: |x - izp| <= 255 and |w| <= 128, so a 3x3 tap sum stays below 2^19;
// the accumulator is summed in uint32, so even a kernel deep enough to wrap
// wraps as the oracle's int32 does.
#include <cuda_runtime.h>

#include <cstdint>

#include "params.cuh"
#include "requantize.cuh"

namespace tk {

constexpr int DW_THREADS = 256;
constexpr int DW_MAX_GROUPS = 32;  // channel groups of 4 per block
constexpr int DW_MAX_SMEM = 48 * 1024;

struct DwGeo {
  int n, h, w, c, kh, kw, oh, ow, sh, sw, pt, pl, izp;
  int groups_per_block;  // channel groups of 4 in a block's tile
  int pix_per_block;
  bool vec;  // C % 4 == 0 and every operand 4-byte aligned
};

__device__ __forceinline__ void load4(const int8_t* __restrict__ p, int c, const DwGeo& g,
                                      int32_t (&v)[4]) {
  if (g.vec) {
    const char4 q = *reinterpret_cast<const char4*>(p + c);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < g.c ? p[c + j] : 0;
  }
}

// `out` is int8 (N, OH, OW, C), or int32 when RAW.  K = KH = KW known at
// compile time (the 3x3 of MobileNetV2: the tap loops unroll, so a thread
// issues its nine loads before it needs the first), or 0 for any size.
template <bool RAW, int K>
__global__ void __launch_bounds__(DW_THREADS)
    qdwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   void* __restrict__ out, Requant rq, DwGeo g) {
  extern __shared__ __align__(16) int8_t ws[];  // [tap][channel of the tile]
  const int kh = K ? K : g.kh, kw = K ? K : g.kw;
  const int tile_c = g.groups_per_block * 4;
  const int c0 = blockIdx.y * tile_c;
  for (int i = threadIdx.x; i < kh * kw * tile_c; i += DW_THREADS) {
    const int tap = i / tile_c, cc = c0 + i - tap * tile_c;
    ws[i] = cc < g.c ? w[(long long)tap * g.c + cc] : 0;
  }
  __syncthreads();

  const int slot = threadIdx.x / g.groups_per_block;
  const int grp = threadIdx.x - slot * g.groups_per_block;
  const int c = c0 + grp * 4;
  const int pix = blockIdx.x * g.pix_per_block + slot;  // < N * OH * OW < 2^31
  if (slot >= g.pix_per_block || pix >= g.n * g.oh * g.ow || c >= g.c) return;

  const int img = pix / (g.oh * g.ow);
  const int rem = pix - img * (g.oh * g.ow);
  const int oy = rem / g.ow, ox = rem - oy * g.ow;
  const int iy0 = oy * g.sh - g.pt, ix0 = ox * g.sw - g.pl;
  const int8_t* xi = x + (long long)img * g.h * g.w * g.c;

  uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int ky = 0; ky < kh; ++ky) {
    const int iy = iy0 + ky;
#pragma unroll
    for (int kx = 0; kx < kw; ++kx) {
      const int ix = ix0 + kx;
      if ((unsigned)iy >= (unsigned)g.h || (unsigned)ix >= (unsigned)g.w) continue;
      int32_t xv[4];
      load4(xi + ((long long)iy * g.w + ix) * g.c, c, g, xv);
      const char4 wv = *reinterpret_cast<const char4*>(ws + (ky * kw + kx) * tile_c + grp * 4);
      acc[0] += (uint32_t)((xv[0] - g.izp) * wv.x);
      acc[1] += (uint32_t)((xv[1] - g.izp) * wv.y);
      acc[2] += (uint32_t)((xv[2] - g.izp) * wv.z);
      acc[3] += (uint32_t)((xv[3] - g.izp) * wv.w);
    }
  }

  const long long o = (long long)pix * g.c + c;
  if constexpr (RAW) {
    int32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < g.c ? wrap_add((int32_t)acc[j], rq.bias[c + j]) : 0;
    int32_t* dst = static_cast<int32_t*>(out) + o;
    if (g.vec) {
      *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < 4 && c + j < g.c; ++j) dst[j] = v[j];
    }
  } else {
    int8_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < g.c ? (int8_t)requantize_channel((int32_t)acc[j], c + j, rq) : 0;
    int8_t* dst = static_cast<int8_t*>(out) + o;
    if (g.vec) {
      *reinterpret_cast<char4*>(dst) = make_char4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < 4 && c + j < g.c; ++j) dst[j] = v[j];
    }
  }
}

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// when the block's weights do not fit in shared memory).  With RAW, `mult`
// and `shift` are not read.
template <bool RAW>
int launch_qdwconv(const int8_t* x, const int8_t* w, void* out, const int32_t* bias,
                   const int32_t* mult, const int32_t* shift, const int32_t* p, void* stream) {
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
  g.izp = p[P_IZP];
  g.vec = p[P_A_VEC] != 0;
  // channel tiles of at most 32 groups, as even as they can be (C = 144:
  // two tiles of 18 groups, not 32 + 4)
  const int groups = (g.c + 3) / 4;
  const int tiles = (groups + DW_MAX_GROUPS - 1) / DW_MAX_GROUPS;
  g.groups_per_block = (groups + tiles - 1) / tiles;
  g.pix_per_block = DW_THREADS / g.groups_per_block;
  const Requant rq{bias, mult, shift, p[P_RQ_IZP], p[P_OUT_ZP], p[P_QMIN], p[P_QMAX],
                   p[P_TONEAREST] != 0};
  const long long npix = (long long)g.n * g.oh * g.ow;
  const size_t smem = (size_t)g.kh * g.kw * g.groups_per_block * 4;
  if (smem > DW_MAX_SMEM || npix >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (npix > 0 && g.c > 0) {
    const dim3 grid((unsigned)((npix + g.pix_per_block - 1) / g.pix_per_block), tiles);
    cudaStream_t st = (cudaStream_t)stream;
    if (g.kh == 3 && g.kw == 3)
      qdwconv_kernel<RAW, 3><<<grid, DW_THREADS, smem, st>>>(x, w, out, rq, g);
    else
      qdwconv_kernel<RAW, 0><<<grid, DW_THREADS, smem, st>>>(x, w, out, rq, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace tk

extern "C" int tk_qdwconv_rq(const int8_t* x, const int8_t* w, int8_t* out, const int32_t* bias,
                             const int32_t* mult, const int32_t* shift, const int32_t* params,
                             void* stream) {
  return tk::launch_qdwconv<false>(x, w, out, bias, mult, shift, params, stream);
}

extern "C" int tk_qdwconv_raw(const int8_t* x, const int8_t* w, int32_t* out,
                              const int32_t* bias, const int32_t* params, void* stream) {
  return tk::launch_qdwconv<true>(x, w, out, bias, nullptr, nullptr, params, stream);
}
