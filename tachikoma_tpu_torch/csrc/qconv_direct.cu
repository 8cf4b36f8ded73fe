// K11 qconv_direct: the direct int8 conv, NHWC, with the exact requantize
// epilogue, storing int8 or uint8 bytes.
//
// K11 replaces tachikoma_tpu/ops/pallas/conv_int8.py _conv_kernel (groups 1,
// any kernel size, stride and padding).  Entry on both packages:
// qconv2d_int8 (ops/kernels/conv_direct.py), reached by tune/tuner.py
// tune_conv.  Its depthwise twin K12 (_dw_kernel) runs K5's body
// (qdwconv.cu tk_qdwconv_direct).
//
//   acc[n, oy, ox, co] = sum_{ky, kx, ci} x_pad[n, oy*sh + ky, ox*sw + kx, ci] * w[ky, kx, ci, co]
//
// where taps outside the image read the input zero point izp; the wrapper
// folds - izp * colsum(w) into the bias (int32 wraparound), so the sum is
// that of (x_pad - izp) * w, as qnn.conv2d pads.  The epilogue clips
// q_multiply_shift(acc + bias[c], m[c], s[c]) + out_zp to [qmin, qmax], per
// channel, UPWARD or TONEAREST; the low byte of the clipped value is stored,
// so an int8 or a uint8 output (qmin 0, qmax 255) takes the same store.
//
// K11 keeps the TPU kernel's data path, "im2col in VMEM": a block stages its
// output tile's input window once per chunk of input channels and runs the
// KH*KW taps as one deep product over it.  On Hopper (qconv_direct_hopper):
//   * The output tile is 16 rows by 8 columns of one image by BN output
//     channels, two warpgroups of 64 rows (8 output rows each).  Eight output
//     pixels of one row are one wgmma core matrix.
//   * The window of a 64-channel chunk is staged K-slice-major: for each
//     16-byte channel segment, the window's pixels contiguous at 16 bytes
//     each (cp.async where CIN % 16 == 0, bytes otherwise; izp outside the
//     image by 16-byte shared stores).  At stride s it is deinterleaved into
//     its phases (p, q) < (min(SH, KH), min(SW, KW)), phase (p, q) holding
//     input rows iy0 + i*SH + p and columns ix0 + j*SW + q; a phase's rows
//     are padded to a multiple of 8 pixels.  Tap (ky, kx) = (a*SH + p, b*SW
//     + q) of output pixel (r, c) reads phase (p, q) at (r + a, c + b): at a
//     unit stride, whatever the conv's.
//   * So tap (ky, kx)'s A operand is a no-swizzle descriptor at window +
//     16 * (its phase's first pixel + a * PW + b): SBO 16 * PW (the next
//     output row), LBO 16 * (window pixels) (the next segment).  Every tap
//     is one wgmma.mma_async m64nBNk32 .s32.s8.s8 pair per warpgroup on the
//     staged window, with no copy per tap (two where the chunk has more than
//     32 channels, one otherwise).
//   * The weights are packed once per weight tensor by chunk and tap, as
//     (CINP / 64, KH*KW, COUT, 64), CINP = CIN rounded up to 64 with zeros
//     (ops/kernels/conv_direct.py direct_weights): a (chunk, tap) slab of BN
//     output channels is BN * 64 contiguous bytes, staged by cp.async into
//     the core-matrix layout (LBO 128, SBO 512), no transposes and no masks
//     past CIN.
//   * Shared memory: a chunk's taps of weights, not its window, set the size
//     of a step (9 x BN x 64 bytes: 36.9 KB at BN 64, 73.7 KB at BN 128;
//     the 3x3 window at stride 1 is 18 x 16 pixels, 18.4 KB).  A block is
//     persistent: it keeps one N tile and walks M tiles, and where every
//     chunk's slabs of its N tile fit beside the windows (CIN <= 128 at BN
//     128, <= 256 at BN 64) it stages them once and keeps them resident, so
//     that an item moves its windows alone.  Elsewhere a step is a group of
//     up to `group` taps of one chunk (all nine of a 3x3 where they fit), its
//     weights streamed.  The wrapper sizes BN, the group and the depth from
//     227 KB (direct_plan).  The copies run `ahead` steps ahead across the
//     items, ahead + 1 buffers of windows and of streamed weights: the next
//     steps' copies are in flight while this step's wgmmas and an item's
//     epilogue run.  One barrier a step.  The copies are cached in L1 too
//     (.ca): neighbouring tiles' windows overlap, and an SM's blocks share
//     the weights.
//   * The epilogue (epilogue_hopper.cuh) requantizes with the column
//     constants in shared memory into a staged tile that leaves in 16-byte
//     rows where COUT % 16 == 0 (else byte by byte).
// Where the window and one tap of weights do not fit (kernels of hundreds of
// taps at large strides), or the wrapper asks for it by shape (P_CC 4 to 32:
// the 7x7 CIN-3 stem, whose 49 taps of 3 channels the Hopper path would run
// as 49 steps of 32 bytes of K), K11 runs the first port's kernel
// (qconv_direct_narrow): mma.sync, an 8 x 8 output tile, chunks of 4 to 32
// channels staged packed, a table of window offsets per reduction index,
// weights transposed per chunk.
//
// What bounds it on the H100: the tensor cores at VGG-16's 3x3 convs
// (operations: 0.1318 ms for VGG-16 b8's 122.8 GMAC at 1979 TOP/s).  What
// holds it above its bound (tools/conv_probe.py --cuts, on this design's
// first versions): not wgmma (cutting it saved 6-15%) but the copies (the
// windows and, where they stream, the weights) and the epilogue's integer
// work (37% of VGG-16 b8's 224^2 c64 call).
#include <cuda_runtime.h>

#include <cstdint>

#include "params.cuh"
#include "epilogue_hopper.cuh"
#include "layouts_hopper.cuh"  // wgmma, FastDiv (and qgemm.cuh: mma_s8, store_transposed)

namespace tk {

constexpr int D_TH = 8, D_TW = 8;  // K11's output tile (rows x columns)
constexpr int D_BN = 64;           // K11's output channels per block
constexpr int D_THREADS = 128;     // four warps, one per 32 x 32 of the 64 x 64 tile
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
// K11 qconv_direct: the narrow path (the first port's kernel, mma.sync)
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
    qconv_direct_narrow(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        uint8_t* __restrict__ out, Requant rq, DGeo g) {
  extern __shared__ __align__(128) int8_t smem[];
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

// Launches K11's narrow path on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a chunk other than 4, 8, 16 or 32 channels, or
// shared memory above 227 KB).  w is HWIO.
int launch_qconv_direct_narrow(const int8_t* x, const int8_t* w, uint8_t* out, const int32_t* bias,
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
    if (cudaFuncSetAttribute(qconv_direct_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return (int)cudaGetLastError();
    granted = smem;
  }
  const dim3 grid((unsigned)blocks, (g.cout + D_BN - 1) / D_BN);
  qconv_direct_narrow<<<grid, D_THREADS, smem, (cudaStream_t)stream>>>(x, w, out, rq, g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11 qconv_direct on Hopper: the staged window, each tap a wgmma at a
// shifted descriptor
// ---------------------------------------------------------------------------

constexpr int H_TR = 16, H_TC = 8;  // the output tile: 16 rows x 8 columns
constexpr int H_NT = 256;           // two warpgroups, 8 output rows each
constexpr int H_KC = 64;            // input channels per chunk
constexpr int H_RPAD = 16;          // bytes of padding per row of the staged tile

struct WGeo {
  int n, h, w, cin, kh, kw, cout, oh, ow, sh, sw, pt, pl;
  int lph, lpw, khp, kwp;  // live phases (rows, columns); taps a phase holds
  int ph_rows, ph_cols;    // a phase's pixel rows; its pixels a row (padded to 8)
  int real_cols;           // the staged pixels of a phase row
  int ph_pix, npix;        // pixels a phase; in the window
  int segs, seg_shift;     // 16-byte segments a window pixel (2 or 4), log2
  int nch, taps, group, ngroups, nsteps;
  bool wres;               // the N tile's weights (every chunk and tap) resident
  int ahead;               // steps the copies run ahead (1 to 3): ahead + 1 buffers each
  int tiles_y, tiles_x, m_tiles, n_tiles, gm;
  int win_bytes, wt_bytes, off_wt, off_tile, off_cols, off_toff, smem;
  uint32_t izp4;
  bool a_vec;  // CIN % 16 == 0 and x 16-byte aligned
  bool o_vec;  // COUT % 16 == 0 and out 16-byte aligned
  hop::FastDiv by_real_cols, by_ph_rows, by_lpw, by_tiles, by_tiles_x;
};

// The window of chunk `ch` (K-slice-major, phases deinterleaved) of the tile
// at input origin (iy0, ix0) of image xi.  Segments past CIN are left as
// they are (their weights are zero); izp outside the image.
__device__ __forceinline__ void stage_window_h(int8_t* win, const int8_t* __restrict__ xi,
                                               int iy0, int ix0, int ch, const WGeo& g) {
  const int c0 = ch * H_KC;
  const uint4 fill = make_uint4(g.izp4, g.izp4, g.izp4, g.izp4);
  const int total = g.lph * g.lpw * g.ph_rows * g.real_cols * g.segs;
  for (int e = threadIdx.x; e < total; e += H_NT) {
    const int sg = e & (g.segs - 1), pix = e >> g.seg_shift;
    const int row = g.by_real_cols.div(pix), j = pix - row * g.real_cols;
    const int ph = g.by_ph_rows.div(row), i = row - ph * g.ph_rows;
    const int p = g.by_lpw.div(ph), q = ph - p * g.lpw;
    const int c = c0 + 16 * sg;
    if (c >= g.cin) continue;
    int8_t* d = win + (sg * g.npix + ph * g.ph_pix + i * g.ph_cols + j) * 16;
    const int iy = iy0 + i * g.sh + p, ix = ix0 + j * g.sw + q;
    if ((unsigned)iy >= (unsigned)g.h || (unsigned)ix >= (unsigned)g.w) {
      *reinterpret_cast<uint4*>(d) = fill;
      continue;
    }
    const int8_t* src = xi + ((long long)iy * g.w + ix) * g.cin + c;
    if (g.a_vec) {
      hop::cp_async16_ca(d, src, true);
      continue;
    }
    uint32_t v[4] = {g.izp4, g.izp4, g.izp4, g.izp4};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (c + b >= g.cin) break;
      const uint32_t sh8 = 8 * (b & 3);
      v[b >> 2] = (v[b >> 2] & ~(0xffu << sh8)) | (uint32_t)(uint8_t)src[b] << sh8;
    }
    *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// `nslab` consecutive (chunk, tap) slabs from slab `slab0` (chunk-major:
// slab = chunk * taps + tap) of the N tile at n0: slab i's BN x 64 bytes at
// wt + i * BN * 64 in the core-matrix layout, zero past COUT.  The packed
// weights hold a slab's rows contiguous, so a warp copies 512 contiguous
// bytes (256 where a pixel has two segments).
template <int BN>
__device__ __forceinline__ void stage_slabs_h(int8_t* wt, const int8_t* __restrict__ wk,
                                              int slab0, int nslab, int n0, const WGeo& g) {
  const int total = nslab * BN * g.segs;
  for (int e = threadIdx.x; e < total; e += H_NT) {
    const int sg = e & (g.segs - 1), rr = e >> g.seg_shift;
    const int r = rr & (BN - 1), i = rr / BN;
    const bool ok = n0 + r < g.cout;
    const int8_t* src = wk + ((long long)(slab0 + i) * g.cout + n0 + r) * H_KC + 16 * sg;
    hop::cp_async16_ca(wt + i * BN * 64 + (r >> 3) * 512 + sg * 128 + (r & 7) * 16, ok ? src : wk,
                    ok);
  }
}

// A block (x: N tile + n_tiles * mb) walks the M tiles (image, 16 x 8 output
// tile) mb, mb + gm, ... of its N tile, one item each, and each item's steps:
// a step is up to `group` taps of one chunk, all of them where the N tile's
// weights are resident.  The copies run `ahead` steps ahead across the
// items, one commit group a step: the next steps' windows (where they start
// a chunk) and, unless resident, their weights are in flight while this
// step's wgmmas run and while an item's epilogue runs.
template <int BN>
__global__ void __launch_bounds__(H_NT, 1)
    qconv_direct_hopper(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                        uint8_t* __restrict__ out, const int32_t* __restrict__ bias,
                        const int32_t* __restrict__ mult, const int32_t* __restrict__ shift,
                        epi::RqConst rq, WGeo g) {
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int RS = BN + H_RPAD;
  int8_t* const win = smem;                 // two windows
  int8_t* const wt = smem + g.off_wt;       // every slab (wres), else two steps of weights
  int8_t* const tile = smem + g.off_tile;   // the staged output tile
  int4* const colc = reinterpret_cast<int4*>(smem + g.off_cols);
  int* const toff = reinterpret_cast<int*>(smem + g.off_toff);
  const int n0 = (blockIdx.x % g.n_tiles) * BN, mb = blockIdx.x / g.n_tiles;
  const int n_items = mb < g.m_tiles ? (g.m_tiles - 1 - mb) / g.gm + 1 : 0;
  const int total = n_items * g.nsteps;
  if (total == 0) return;

  // the item's image and input origin
  struct Org {
    const int8_t* xi;
    int img, oy0, ox0;
  };
  auto origin = [&](int item) {
    const int mt = mb + item * g.gm;
    const int img = g.by_tiles.div(mt), t = mt - img * (g.tiles_y * g.tiles_x);
    const int ty = g.by_tiles_x.div(t);
    return Org{x + (long long)img * g.h * g.w * g.cin, img, ty * H_TR,
                (t - ty * g.tiles_x) * H_TC};
  };
  // the copies of global step q: its window where it starts a chunk, its
  // weights unless resident
  const int nbuf = g.ahead + 1;
  auto stage_step = [&](int q) {
    const int item = q / g.nsteps, s = q - item * g.nsteps;
    const int ch = s / g.ngroups, grp = s - ch * g.ngroups;
    if (grp == 0) {
      const Org o = origin(item);
      stage_window_h(win + ((item * g.nch + ch) % nbuf) * g.win_bytes, o.xi,
                     o.oy0 * g.sh - g.pt, o.ox0 * g.sw - g.pl, ch, g);
    }
    if (!g.wres) {
      const int t0 = grp * g.group;
      stage_slabs_h<BN>(wt + (q % nbuf) * g.wt_bytes, wk, ch * g.taps + t0,
                        min(g.group, g.taps - t0), n0, g);
    }
  };

  if (g.wres) stage_slabs_h<BN>(wt, wk, 0, g.nch * g.taps, n0, g);
  for (int q = 0; q < g.ahead; ++q) {  // one commit group a step, empty past the last
    if (q < total) stage_step(q);
    hop::cp_async_commit();
  }
  // while the first copies fly: each tap's window offset, the column constants
  for (int tap = threadIdx.x; tap < g.taps; tap += H_NT) {
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
    const int a = ky / g.sh, p = ky - a * g.sh, b = kx / g.sw, q = kx - b * g.sw;
    toff[tap] = 16 * ((p * g.lpw + q) * g.ph_pix + a * g.ph_cols + b);
  }
  epi::load_cols(colc, BN, n0, g.cout, bias, mult, shift, 0);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int lbo = 16 * g.npix, sbo = 16 * g.ph_cols;
  const int a_wg = 16 * 8 * wg * g.ph_cols;  // this warpgroup's 8 output rows
  // fragment: acc[4 jb + e] is row 16 warp + lane / 4 + 8 (e >> 1) of the
  // warpgroup's 64, column 8 jb + 2 (lane % 4) + (e & 1); tile row r is
  // output pixel (oy0 + r / 8, ox0 + r % 8)
  const int rl0 = wg * 64 + 16 * warp + (lane >> 2);
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int q = 0; q < total; ++q) {
    hop::cp_async_wait_upto(g.ahead - 1);  // step q's copies have landed
    hop::fence_proxy_async();
    __syncthreads();
    const int item = q / g.nsteps, s = q - item * g.nsteps;
    const int ch = s / g.ngroups, t0 = (s - ch * g.ngroups) * g.group;
    const int8_t* const wa = win + ((item * g.nch + ch) % nbuf) * g.win_bytes + a_wg;
    const int8_t* const wb =
        g.wres ? wt + (ch * g.taps + t0) * BN * 64 : wt + (q % nbuf) * g.wt_bytes;
    const int ksteps = g.cin - ch * H_KC > 32 ? 2 : 1;
    const int nt = min(g.group, g.taps - t0);
    hop::wgmma_fence();
    for (int tl = 0; tl < nt; ++tl) {
      const int8_t* const a = wa + toff[t0 + tl];
      const int8_t* const b = wb + tl * BN * 64;
      hop::wgmma_acc<BN>(acc, hop::gmma_desc(a, lbo, sbo), hop::gmma_desc(b, 128, 512));
      if (ksteps == 2)
        hop::wgmma_acc<BN>(acc, hop::gmma_desc(a + 2 * lbo, lbo, sbo),
                           hop::gmma_desc(b + 256, 128, 512));
    }
    hop::wgmma_commit();
    // step q + ahead's copies while the tensor cores run: its buffers were
    // last read by step q - 1, which every warpgroup finished before the
    // barrier above
    if (q + g.ahead < total) stage_step(q + g.ahead);
    hop::cp_async_commit();
    hop::wgmma_wait0();
    if (s + 1 < g.nsteps) continue;

    // the epilogue of the item; the tile is next written after a barrier of
    // the next item's steps
    const Org o = origin(item);
    auto dst = [&](int r) -> long long {
      const int oy = o.oy0 + (r >> 3), ox = o.ox0 + (r & 7);
      return oy < g.oh && ox < g.ow ? (((long long)o.img * g.oh + oy) * g.ow + ox) * g.cout + n0
                                    : -1;
    };
    if (g.o_vec) {
      epi::stage_fragment<BN>(tile, RS, rl0, acc, colc, rq, epi::PackPair{});
      __syncthreads();
      epi::store_tile16(reinterpret_cast<int8_t*>(out), tile, RS, 2 * 64, min(BN, g.cout - n0),
                        dst);
    } else {
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int cl = 8 * jb + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long d = dst(rl0 + 8 * h);
          if (d < 0) continue;
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            if (n0 + cl + e1 < g.cout)
              out[d + cl + e1] =
                  (uint8_t)epi::requant_wide(acc[4 * jb + 2 * h + e1], colc[cl + e1], rq);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  }
}

// The Hopper path's geometry and shared memory (conv_direct.py direct_smem
// mirrors it): ahead + 1 windows; every slab of the N tile (wres) or ahead +
// 1 steps of `group` taps of weights; the staged tile, the column constants,
// the taps' window offsets.
inline void wgeo_layout(WGeo& g, int bn) {
  g.lph = std::min(g.sh, g.kh);
  g.lpw = std::min(g.sw, g.kw);
  g.khp = (g.kh + g.sh - 1) / g.sh;
  g.kwp = (g.kw + g.sw - 1) / g.sw;
  g.ph_rows = H_TR - 1 + g.khp;
  g.real_cols = H_TC - 1 + g.kwp;
  g.ph_cols = (g.real_cols + 7) / 8 * 8;
  g.ph_pix = g.ph_rows * g.ph_cols;
  g.npix = g.lph * g.lpw * g.ph_pix;
  g.segs = g.cin > 32 ? 4 : 2;
  g.seg_shift = g.segs == 4 ? 2 : 1;
  g.nch = (g.cin + H_KC - 1) / H_KC;
  g.taps = g.kh * g.kw;
  if (g.wres) g.group = g.taps;
  g.ngroups = (g.taps + g.group - 1) / g.group;
  g.nsteps = g.nch * g.ngroups;
  g.win_bytes = g.npix * 16 * g.segs;
  g.wt_bytes = g.group * bn * 64;
  g.off_wt = (g.ahead + 1) * g.win_bytes;
  g.off_tile = g.off_wt + (g.wres ? g.nch * g.taps * bn * 64 : (g.ahead + 1) * g.wt_bytes);
  g.off_cols = g.off_tile + 2 * 64 * (bn + H_RPAD);
  g.off_toff = g.off_cols + bn * 16;
  g.smem = g.off_toff + round_up(4 * g.taps, 16);
}

// Launches over a grid of (N tiles x gm): gm M-tile lanes, as many as the
// card holds blocks at once (the occupancy API) and at most the M tiles.
template <int BN>
int launch_hopper_bn(const int8_t* x, const int8_t* wk, uint8_t* out, const int32_t* bias,
                     const int32_t* mult, const int32_t* shift, const epi::RqConst& rq, WGeo g,
                     cudaStream_t stream) {
  auto kern = qconv_direct_hopper<BN>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hop::SMEM_LIMIT) != cudaSuccess)
      return (int)cudaGetLastError();
    sms = n;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, H_NT, g.smem) != cudaSuccess)
    return (int)cudaGetLastError();
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  g.gm = std::max(1, std::min(g.m_tiles, sms * per_sm / g.n_tiles));
  kern<<<g.n_tiles * g.gm, H_NT, g.smem, stream>>>(x, wk, out, bias, mult, shift, rq, g);
  return (int)cudaGetLastError();
}

// Launches K11's Hopper path at BN = P_BN (64 or 128), the N tile's weights
// resident (P_WRES) or P_GROUP taps a step, the copies P_AHEAD steps ahead
// (1 to 3; 0 means 1); wk is the weight packed
// (CINP / 64, KH*KW, COUT, 64).  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a BN not built, a group out of range or shared
// memory above 227 KB).
int launch_qconv_direct_hopper(const int8_t* x, const int8_t* wk, uint8_t* out,
                               const int32_t* bias, const int32_t* mult, const int32_t* shift,
                               const int32_t* p, void* stream) {
  WGeo g;
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
  g.group = p[P_GROUP];
  g.wres = p[P_WRES] != 0;
  g.ahead = p[P_AHEAD] ? p[P_AHEAD] : 1;
  const int bn = p[P_BN];
  if (g.cin <= 0 || g.kh <= 0 || g.kw <= 0 || g.sh <= 0 || g.sw <= 0 || (bn != 64 && bn != 128) ||
      (!g.wres && (g.group < 1 || g.group > g.kh * g.kw)) || g.ahead > 3)
    return (int)cudaErrorInvalidValue;
  wgeo_layout(g, bn);
  g.tiles_y = (g.oh + H_TR - 1) / H_TR;
  g.tiles_x = (g.ow + H_TC - 1) / H_TC;
  const long long m_tiles = (long long)g.n * g.tiles_y * g.tiles_x;
  g.n_tiles = (g.cout + bn - 1) / bn;
  g.izp4 = (uint32_t)(uint8_t)(int8_t)p[P_IZP] * 0x01010101u;
  g.a_vec = p[P_A_VEC] != 0 && g.cin % 16 == 0;
  g.o_vec = g.cout % 16 == 0 && (uintptr_t)out % 16 == 0;
  g.by_real_cols = hop::FastDiv::make(g.real_cols);
  g.by_ph_rows = hop::FastDiv::make(g.ph_rows);
  g.by_lpw = hop::FastDiv::make(g.lpw);
  g.by_tiles = hop::FastDiv::make(g.tiles_y * g.tiles_x);
  g.by_tiles_x = hop::FastDiv::make(g.tiles_x);
  if (g.smem > (int)hop::SMEM_LIMIT || m_tiles >= (1LL << 31) ||
      m_tiles * g.nsteps >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (m_tiles <= 0 || g.cout <= 0) return (int)cudaGetLastError();
  g.m_tiles = (int)m_tiles;
  const epi::RqConst rq{p[P_OUT_ZP], p[P_QMIN], p[P_QMAX], p[P_TONEAREST] != 0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bn == 64) return launch_hopper_bn<64>(x, wk, out, bias, mult, shift, rq, g, s);
  return launch_hopper_bn<128>(x, wk, out, bias, mult, shift, rq, g, s);
}

}  // namespace tk

// K11: the Hopper path (P_CC 64, its chunk; w packed (KH*KW, COUT, CINP)) or
// the narrow path (P_CC = its chunk, 4 to 32 channels; w HWIO).
extern "C" int tk_qconv_direct(const int8_t* x, const int8_t* w, uint8_t* out,
                               const int32_t* bias, const int32_t* mult, const int32_t* shift,
                               const int32_t* params, void* stream) {
  if (params[tk::P_CC] == tk::H_KC)
    return tk::launch_qconv_direct_hopper(x, w, out, bias, mult, shift, params, stream);
  return tk::launch_qconv_direct_narrow(x, w, out, bias, mult, shift, params, stream);
}
