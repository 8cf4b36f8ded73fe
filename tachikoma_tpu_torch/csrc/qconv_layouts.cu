// K8 qconv_rq_s and K10 qconv_rq_r, the Hopper designs of two layouts of the
// flat conv (K7 and K9, the other two, are qconv_layouts_hopper.cu).
//
// Each computes exactly K2's function: the NHWC int8 conv, the int32
// accumulator plus the folded bias, the exact requantize epilogue of
// requantize.cuh, the low byte of the clipped value stored (int8 or uint8).
// They replace the layout variants of tachikoma_tpu/ops/pallas/conv_flat.py
// (both reach pl.pallas_call at :370 through _build_flat_conv, :321):
//   K8 qconv_rq_s  <- _flat_conv_kernel_s (:133): the block's window staged
//      once per chunk, every tap read from it at a row shift;
//   K10 qconv_rq_r <- _flat_conv_kernel_r (:224): for each column tap, its
//      row taps as one deep-K run over a window staged for that column.
// The polyphase frame, the stagers, the step walk, the cluster split and the
// cost model are layouts_hopper.cuh's, shared with K7 and K9.
//
// What bounds them on the H100.  The three 3x3 s2 convs of ResNet-50 b8 move
// about 10 MB and do 5.5 GOP: 3 us at 3.35 TB/s, 2.8 us at the int8 peak, so
// neither bound is near; what a flat-frame design loses is overhead.  The
// first port of these two (mma.sync, a flat frame built by the wrapper on
// every call, all 16 tap-phase products of a 3x3 s2 conv, a full copy wait
// and two barriers per tap) took 0.43-0.46 ms per forward for the three
// calls on one H100 80GB HBM3 (700 W), 2.7-2.9x K2; this design takes 0.11
// (K8) and 0.13 ms (K10) at 64 x 64, against K2's 0.16 ms (chip_smoke.py
// phase 15b).  The design:
//   1. No frame: the wrapper hands over the NHWC image and the packed
//      weights; the stagers address them, and the epilogue stores straight
//      into (N, OH, OW, COUT).
//   2. The zero taps are skipped (tap_live): 9 products, not 16, for a 3x3
//      s2 conv with CIN % 64 == 0.
//   3. wgmma on a shifted window.  The chunk's window (K8: BM + maxoff frame
//      rows from the block's first; K10: BM + (KHP-1)*WPH rows from it plus
//      the column tap b) is staged K-slice-major: each 16-byte channel slice
//      holds its rows contiguous at 16 bytes a row (tile_off<KSM>).  A
//      no-swizzle core matrix (8 rows x 16 bytes) starting at any row is then
//      128 contiguous bytes, so tap t's A operand (64 output rows, K-major)
//      is the descriptor at window + 16 * (its row shift + 64 * warpgroup),
//      SBO 128 (the next 8 rows), LBO 16 * rows (the next slice): no copy
//      per tap and no partials.  B is the tap's weights [n][k] in the
//      core-matrix layout (LBO 128, SBO 512).  A step's live taps x its K
//      steps run as wgmma.mma_async m64nBNk32 .s32.s8.s8 back to back into
//      the same registers, with one commit (no .satfinite: int32 sums wrap,
//      as the reference's do).  One warpgroup per 64 rows.  K8 stages the
//      window once per chunk; K10 once per (chunk, live column tap), its row
//      taps at +a*WPH rows: a window KWP - 1 rows shorter than K8's, staged
//      KWP times a chunk; the tuner weighs that trade.
//   4. The copies are pipelined: two buffers each of window and weights;
//      the next step's copies (its window only when it starts a new window)
//      are issued while the current step's wgmmas run, then the warpgroup
//      waits.  One barrier per step: the copies of a step, waited by each
//      thread and fenced to the async proxy, are visible to every warpgroup
//      after it, and every warpgroup is then done with the buffers that the
//      next copies overwrite.
//   5. The card is filled as K7 and K9 fill it: the cluster split over the
//      chunks and the cost model's taps per step (plan_launch).
// The 16-byte aligned (not 128-byte aligned) descriptor start is what the
// no-swizzle mode allows; tests/test_torch_port_cuda.py holds a tap at an
// odd row shift == the plain version.  With no swizzle, the core matrices of
// one wgmma fall on banks that the row shift decides; no swizzle can take an
// arbitrary shift.  The over-wide columns (KWP - 1 a frame row) are computed
// and dropped.
#include "layouts_hopper.cuh"

namespace tk {
namespace hop {

// Window rows of K8 (every tap's shift, up to maxoff) or K10 (COLS: its row
// taps' shifts, up to (KHP-1)*WPH), rounded to a core matrix's 8 rows.
__host__ __device__ inline int sr_rows(bool cols, int bm, const HGeo& g) {
  return (bm + (cols ? (g.khp - 1) * g.wph : g.maxoff) + 7) / 8 * 8;
}

// Dynamic shared memory: two windows and two weight tiles of `group` taps.
// The wrapper mirrors this sum (conv_layouts.py smem_bytes) to refuse a tile
// that does not fit.
inline size_t sr_smem(bool cols, int bm, int bn, int group, const HGeo& g) {
  return 2 * (size_t)sr_rows(cols, bm, g) * KC + 2 * (size_t)group * bn * KC;
}

template <bool COLS, int BM, int BN, int KS>
__global__ void __launch_bounds__(2 * BM)
    qconv_sr_hopper(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                    int8_t* __restrict__ out, Requant rq, HGeo g) {
  constexpr int NT = 2 * BM;  // a warpgroup per 64 rows
  extern __shared__ __align__(128) int8_t smem[];
  const int rows = sr_rows(COLS, BM, g);
  // two windows, two weight tiles (buffer b at base + b * size)
  const int win_sz = rows * KC, wt_sz = g.group * BN * KC;
  int8_t* const win = smem;
  int8_t* const wt = smem + 2 * win_sz;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wg_row = (threadIdx.x >> 7) * 64;
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  Step cur = step_from<COLS>(KS > 1 ? (int)blockIdx.z : 0, 0, KS, g);
  int wb = 0;  // the window buffer of cur
  if (cur.chunk < g.nchunks) {
    stage_window<KSM, NT>(win, rows, x, m0 + cur.col, rows, cur.chunk * KC, g);
    stage_weights<CM, BN, NT>(wt, 0, wk, cur, n0, g);
  }
  cp_async_commit();
  for (int s = 0; cur.chunk < g.nchunks; ++s) {
    cp_async_wait0();
    fence_proxy_async();
    __syncthreads();
    const int8_t* const ws = win + wb * win_sz;
    const int8_t* const bs = wt + (s & 1) * wt_sz;
    const int ksteps = chunk_ksteps(cur.chunk * KC, g);
    wgmma_fence();
#pragma unroll
    for (int tl = 0; tl < GMAX; ++tl) {
      if (tl >= cur.g) break;
      const int row = tap_off(step_tap(cur, tl), g) - cur.col + wg_row;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        if (kk < ksteps)
          wgmma_acc<BN>(acc, gmma_desc(ws + row * 16 + kk * 32 * rows, 16 * rows, 128),
                        gmma_desc(bs + tl * BN * KC + kk * 256, 128, 512));
    }
    wgmma_commit();
    // the next step's copies while the tensor cores run
    const Step nxt = next_step<COLS>(cur, KS, g);
    const bool new_win = nxt.chunk != cur.chunk || nxt.col != cur.col;
    const int nwb = new_win ? wb ^ 1 : wb;
    if (nxt.chunk < g.nchunks) {
      if (new_win)
        stage_window<KSM, NT>(win + nwb * win_sz, rows, x, m0 + nxt.col, rows, nxt.chunk * KC, g);
      stage_weights<CM, BN, NT>(wt + ((s + 1) & 1) * wt_sz, 0, wk, nxt, n0, g);
    }
    cp_async_commit();
    wgmma_wait0();
    cur = nxt;
    wb = nwb;
  }
  if (!cluster_reduce<KS, NT>(reinterpret_cast<uint32_t(&)[BN / 2]>(acc), smem)) return;

  // fragment: acc[4 jb + e] is row 16 warp + lane / 4 + 8 (e >> 1) of the
  // warpgroup's 64, column 8 jb + 2 (lane % 4) + (e & 1)
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool pairs = (g.cout & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long o = out_index(m0 + wg_row + 16 * warp + (lane >> 2) + 8 * h, g);
    if (o < 0) continue;
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
      const int col = n0 + 8 * jb + 2 * (lane & 3);
      if (col >= g.cout) break;
      const uint32_t v0 = (uint8_t)requantize_channel(acc[4 * jb + 2 * h], col, rq);
      if (col + 1 >= g.cout) {
        out[o + col] = (int8_t)v0;
        break;
      }
      const uint32_t v1 = (uint8_t)requantize_channel(acc[4 * jb + 2 * h + 1], col + 1, rq);
      if (pairs) {
        *reinterpret_cast<uint16_t*>(out + o + col) = (uint16_t)(v0 | v1 << 8);
      } else {
        out[o + col] = (int8_t)v0;
        out[o + col + 1] = (int8_t)v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <bool COLS, int BM, int BN>
int launch_tile(const int8_t* x, const int8_t* wk, int8_t* out, const Requant& rq, HGeo g,
                cudaStream_t stream) {
  auto kern1 = qconv_sr_hopper<COLS, BM, BN, 1>;
  auto kern2 = qconv_sr_hopper<COLS, BM, BN, 2>;
  static int sms = 0;
  Plan plan;
  const int rc = plan_launch(
      (const void*)kern1, (const void*)kern2, 2 * BM, BM, BN, COLS, g,
      [&](int grp) { return sr_smem(COLS, BM, BN, grp, g); }, sms, plan);
  if (rc != cudaSuccess) return rc;
  g.group = plan.group;
  const dim3 grid((g.mo + BM - 1) / BM, (g.cout + BN - 1) / BN, plan.split ? 2 : 1);
  return launch_cluster(plan.split ? kern2 : kern1, plan.split ? 2 : 1, grid, 2 * BM, plan.smem,
                        stream, x, wk, out, rq, g);
}

// Launches K8 (COLS false) or K10 on `stream` at the tile (P_BM, P_BN), up to
// P_GROUP live taps per step, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a tile that is not built, a group out of range,
// more than 255 taps or shared memory above 227 KB).  wk is the weight
// packed (KH, KW, COUT, CIN).
template <bool COLS>
int launch(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
           const int32_t* mult, const int32_t* shift, const int32_t* p, void* stream) {
  HGeo g;
  if (!make_geo(p, g)) return (int)cudaErrorInvalidValue;
  const Requant rq = make_rq(bias, mult, shift, p);
  const int bm = p[P_BM] ? p[P_BM] : 64, bn = p[P_BN] ? p[P_BN] : 64;
  if (g.group < 1 || g.group > GMAX || g.khp * g.kwp > 255) return (int)cudaErrorInvalidValue;
  if (g.mo <= 0 || g.cout <= 0 || g.oh <= 0 || g.ow <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return launch_tile<COLS, 64, 64>(x, wk, out, rq, g, s);
  if (bm == 64 && bn == 128) return launch_tile<COLS, 64, 128>(x, wk, out, rq, g, s);
  if (bm == 128 && bn == 64) return launch_tile<COLS, 128, 64>(x, wk, out, rq, g, s);
  if (bm == 128 && bn == 128) return launch_tile<COLS, 128, 128>(x, wk, out, rq, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace hop
}  // namespace tk

extern "C" int tk_qconv_rq_s(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
                             const int32_t* mult, const int32_t* shift, const int32_t* params,
                             void* stream) {
  return tk::hop::launch<false>(x, wk, out, bias, mult, shift, params, stream);
}

extern "C" int tk_qconv_rq_r(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
                             const int32_t* mult, const int32_t* shift, const int32_t* params,
                             void* stream) {
  return tk::hop::launch<true>(x, wk, out, bias, mult, shift, params, stream);
}
