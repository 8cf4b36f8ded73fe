// K1 qgemm_rq and K4's GEMM mode qgemm_raw: int8 x (M, K) times int8 w
// (K, N), int32 accumulator; K1 requantizes exactly to int8 (M, N), K4 stores
// acc + bias as int32 (M, N), in int32 wraparound.
//
// K1 replaces tachikoma_tpu/ops/pallas/matmul_int8.py _mm_kernel (built by
// _build_qmatmul, entry qmatmul_int8): on the int8 run paths the 1x1 convs of
// ResNet-50 and MobileNetV2 (M = batch * H * W, K = CIN, N = COUT), their
// classifiers and VGG-16's three dense layers (M = batch).  K4's GEMM mode
// replaces _mm_kernel_raw of the same file (entry qmatmul_int8 without a
// multiplier): on the unfused graphs the trace path runs, every 1x1
// qnn.conv2d and the qnn.dense (at batch 1: ResNet-50's 37 calls,
// MobileNetV2's 35).  The weight arrives packed K-major once per weight
// tensor, (Kp / 64, N, 64) (ops/kernels/matmul_int8.py kmajor_weights): the
// 64 bytes of K step s of output channel n are one row, and a step's rows for
// consecutive channels are contiguous.
//
// What bounds them on an H100: bytes.  A 1x1 conv does 2 * CIN * COUT /
// (CIN + COUT) operations per activation byte moved, at most 512 on these
// paths, under the ~590 int8 operations per byte at which the tensor cores
// (1979 TOP/s) overtake memory (3.35 TB/s); K4's int32 output is four times
// K1's int8 one; the dense layers at M = 8 read their weights once for 16
// operations a byte (VGG-16's 124 MB of dense weights: 0.037 ms); at batch 1
// a call is a few microseconds of latency, its launch included.  Two paths,
// picked by the wrapper's plan (gemm_plan, P_QG_PATH), each with both
// epilogues:
//
//   * the tiled path (M above 64): K2's implicit-GEMM body
//     (igemm_hopper.cuh) on the GEMM as a 1x1 conv of 1 x 1 images:
//     wgmma.mma_async m64nBNk32 on both operands K-major in shared memory,
//     persistent blocks with a 4-stage cp.async ring across their items, and
//     the split of K where the tiles leave SMs idle.  K1 takes the requantize
//     epilogue of epilogue_hopper.cuh (column constants once a block in
//     shared memory, one mul.wide.s32, a staged output tile leaving in
//     16-byte rows), its split the exact one whose last block requantizes;
//     K4 takes the body's RAW epilogue, whose split adds int32 partial sums
//     atomically into a zeroed output, the bias on split 0 (no workspace, no
//     arrival counter, no read-back).  x is copied 16 bytes at a time, or 8
//     where K % 16 == 8 (MobileNetV2's K = 24).  The tile is the caller's
//     (the tuner's `blocks`), else rq_tile's.
//   * the skinny path (M <= 64: the dense layers at batch 1 to 64, and
//     K4's stage-4 1x1 convs at batch 1, M = 49): the bytes are the
//     weights, so the operands swap, out^T (N, M) = W^T (N, K) x^T (K, M),
//     and the packed weight rows are the mma.sync m16n8k32 A operand (16
//     output channels a warp, 64 a block of four warps), x the B operand
//     (n = 8 rows of M a product, up to eight products).  Each lane copies
//     16 bytes of two weight rows and of each x row and runs two products a
//     step; the k order inside a step is permuted alike on both operands (a
//     lane's 16 bytes are k 16 tig .. 16 tig + 15), which the sum does not
//     see.  K is split (skinny_split) over about four blocks an SM, and each
//     block streams its slice of steps through a ring of SK_STAGES stages of
//     16-byte cp.async copies, SK_STAGES - 1 of them in flight.  K1's splits
//     add their int32 sums into a zeroed workspace and the last block of an
//     N tile to arrive requantizes the whole sum, as K2's split does; K4's
//     add theirs atomically into the zeroed output, split 0 with the bias.
//     The skinny path reads no tile: a tuner's `blocks` sets the tiled
//     path's alone.
// Integer sums wrap alike in any order, so every split gives the same
// integers on every run.
//
// Legacy uint8 models: x may be uint8 (P_A_U8: the tiled path's .u8 A
// operand, the skinny path's .u8 B operand of mma.sync) and the weights may
// have a zero point a column (kzp, not null); each path takes kzp[n] times
// the row sums of the x it staged off its sums (the tiled path as
// igemm_hopper.cuh says; the skinny path with one more mma a product,
// against ones), a split its own steps' part, each path in an
// instantiation of its own (LEG), so the int8 loops stay as they were.  The
// wrapper folds -izp colsum(w) + K izp kzp[n] into the bias.  A uint8 output
// is the same bytes at qmin 0, qmax 255.
//
// K1's batched mode (tk_qbmm_rq, tk_qbmm_raw) is a kernel of its own:
// qbmm_hopper.cu.
#include "igemm_hopper.cuh"

// The parts of the skinny path that tools/gemm_probe.py cuts out, one at a
// time (each is 1 in the kernel as it runs).
#define QG_EPILOGUE 1  // 0: K1 stores the sum's low byte, no requantize (the split still
                       // adds); K4 stores nothing
#define QG_A_LOADS 1   // 0: x is not copied (its tile holds what shared memory held)
#define QG_BODY 1      // 0: the kernel returns as it starts

namespace tk {
namespace skinny {

constexpr int KSTEP = 64;          // bytes of K a step
constexpr int WARPS = 4;
constexpr int SK_BN = 16 * WARPS;  // output channels a block (matmul_int8.py SKINNY_BN)
constexpr int NT = 32 * WARPS;
constexpr int SK_STAGES = 8;       // the ring
constexpr int MAX_M = 64;          // matmul_int8.py SKINNY_M

struct Geo {
  int M, K, N, steps, kper;
  bool x16, x8;  // x copied 16 (K % 16 == 0) or 8 (K % 8 == 0) bytes at a time, else by bytes
  bool x_u8;     // x is uint8: mma.sync's .u8 B operand
};

// mma_s8 (qgemm.cuh) with a uint8 B operand.
__device__ __forceinline__ void mma_s8u8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return (SK_BN + 8 * MT) * KSTEP;
}

// Stage `slot` <- step s: the block's SK_BN weight rows (contiguous in wk)
// and x's rows 0 .. 8 MT - 1 at k = 64 s .. 64 s + 63, zeros past M, K or N.
template <int MT>
__device__ __forceinline__ void stage(int8_t* st, const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ wk, int s, int n0,
                                      const Geo& g) {
  const int tid = threadIdx.x;
  const int8_t* const wsrc = wk + ((long long)s * g.N + n0) * KSTEP;
#pragma unroll
  for (int i = tid; i < SK_BN * 4; i += NT) {
    const bool ok = n0 + (i >> 2) < g.N;
    hop::cp_async16(st + 16 * i, ok ? wsrc + 16 * i : wk, ok);
  }
#if QG_A_LOADS
  int8_t* const xs = st + SK_BN * KSTEP;
  for (int i = tid; i < 8 * MT * 4; i += NT) {
    const int r = i >> 2, k = s * KSTEP + 16 * (i & 3);
    const int8_t* const src = x + (long long)r * g.K + k;
    int8_t* const d = xs + 16 * i;
    if (g.x16) {
      const bool ok = r < g.M && k < g.K;
      hop::cp_async16(d, ok ? src : x, ok);
    } else if (g.x8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = r < g.M && k + 8 * h < g.K;
        igemm::cp_async8(d + 8 * h, ok ? src + 8 * h : x, ok);
      }
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      for (int b = 0; b < 16; ++b)
        if (r < g.M && k + b < g.K) v[b >> 2] |= (uint32_t)(uint8_t)src[b] << (8 * (b & 3));
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#endif
}

// Block (x: N tile, y: split of K) sums steps [y kper, min((y + 1) kper,
// steps)) of its SK_BN channels for the M <= 8 MT rows of x.  Warp w owns
// channels n0 + 16 w .. + 15; lane (gid, tig) = (lane / 4, lane % 4) holds
// acc[mt] = channels (gid, gid + 8) x rows 8 mt + 2 tig + (0, 1).  `out` is
// int8 (K1), or int32 with RAW (K4: mult, shift, ws and rq are not read).
// LEG: the instantiation for legacy operands (uint8 x, kzp), so the int8
// loop stays as it was; kzp, where not null, the weights' zero point a
// channel (rs[mt] then holds the row sums of x at acc[mt]'s rows, from
// products against ones).
template <int MT, bool RAW, bool LEG>
__global__ void __launch_bounds__(NT)
    qgemm_skinny(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                 void* __restrict__ out, const int32_t* __restrict__ bias,
                 const int32_t* __restrict__ mult, const int32_t* __restrict__ shift,
                 int32_t* __restrict__ ws, const int32_t* __restrict__ kzp, epi::RqConst rq,
                 int32_t rq_izp, Geo g) {
  constexpr int ST = stage_bytes<MT>();
  extern __shared__ __align__(128) int8_t smem[];
  int4* const colc = reinterpret_cast<int4*>(smem + SK_STAGES * ST);
  int* const s_last = reinterpret_cast<int*>(colc + SK_BN);
#if !QG_BODY
  if (g.M >= 0) return;
#endif
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * SK_BN;
  const int kbeg = blockIdx.y * g.kper;
  const int nst = min(g.steps, kbeg + g.kper) - kbeg;

#pragma unroll
  for (int i = 0; i < SK_STAGES - 1; ++i) {
    if (i < nst) stage<MT>(smem + i * ST, x, wk, kbeg + i, n0, g);
    hop::cp_async_commit();
  }
  // while the copies fly: K1's column constants; K4's bias of the lane's
  // two channels (below), zero on the splits past the first
  int32_t braw[2] = {0, 0};
  if constexpr (!RAW) {
    epi::load_cols(colc, SK_BN, n0, g.N, bias, mult, shift, rq_izp);
  } else if (blockIdx.y == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * warp + gid + 8 * h;
      braw[h] = col < g.N ? bias[col] : 0;
    }
  }

  int32_t acc[MT][4], rs[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = rs[mt][e] = 0;
  const uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u};
  const int w_off = (16 * warp + gid) * KSTEP + 16 * tig;  // a lane's 16 bytes of its row
  const int x_off = SK_BN * KSTEP + gid * KSTEP + 16 * tig;
  for (int it = 0; it < nst; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SK_STAGES - 2) : "memory");
    __syncthreads();  // step it landed for every thread; step it - 1's slot is free
    if (it + SK_STAGES - 1 < nst)
      stage<MT>(smem + ((it + SK_STAGES - 1) % SK_STAGES) * ST, x, wk, kbeg + it + SK_STAGES - 1,
                n0, g);
    hop::cp_async_commit();
    const int8_t* const st = smem + (it % SK_STAGES) * ST;
    const uint4 wa = *reinterpret_cast<const uint4*>(st + w_off);
    const uint4 wb = *reinterpret_cast<const uint4*>(st + w_off + 8 * KSTEP);
    const uint32_t a0[4] = {wa.x, wb.x, wa.y, wb.y}, a1[4] = {wa.z, wb.z, wa.w, wb.w};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 xv = *reinterpret_cast<const uint4*>(st + x_off + mt * 8 * KSTEP);
      if (!LEG) {
        mma_s8(acc[mt], a0, xv.x, xv.y);
        mma_s8(acc[mt], a1, xv.z, xv.w);
      } else if (g.x_u8) {
        mma_s8u8(acc[mt], a0, xv.x, xv.y);
        mma_s8u8(acc[mt], a1, xv.z, xv.w);
        if (kzp != nullptr) {
          mma_s8u8(rs[mt], ones, xv.x, xv.y);
          mma_s8u8(rs[mt], ones, xv.z, xv.w);
        }
      } else {
        mma_s8(acc[mt], a0, xv.x, xv.y);
        mma_s8(acc[mt], a1, xv.z, xv.w);
        if (kzp != nullptr) {
          mma_s8(rs[mt], ones, xv.x, xv.y);
          mma_s8(rs[mt], ones, xv.z, xv.w);
        }
      }
    }
  }

  // element e of acc[mt]: channel n0 + 16 warp + gid + 8 (e >> 1), row 8 mt + 2 tig + (e & 1)
  const int cl = 16 * warp + gid;
  if (LEG && kzp != nullptr) {  // this split's part of -kzp[n] S[m], in int32 wraparound
    int32_t z[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) z[h] = n0 + cl + 8 * h < g.N ? kzp[n0 + cl + 8 * h] : 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][e] = wrap_sub(acc[mt][e], (int32_t)((uint32_t)z[e >> 1] * (uint32_t)rs[mt][e]));
  }
  if constexpr (RAW) {  // acc + bias stored, or with a split added into the zeroed output
    if (!QG_EPILOGUE) return;
    int32_t* const o32 = static_cast<int32_t*>(out);
    const bool split = gridDim.y > 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * mt + 2 * tig + (e & 1), col = n0 + cl + 8 * (e >> 1);
        if (row >= g.M || col >= g.N) continue;
        int32_t* const p = o32 + (long long)row * g.N + col;
        const int32_t v = wrap_add(acc[mt][e], braw[e >> 1]);
        if (split)
          atomicAdd(p, v);  // int32 atomics wrap: the same sum in any order
        else
          *p = v;
      }
    return;
  }
  if (gridDim.y > 1) {  // a split: add into the workspace; the last block of the N tile goes on
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * mt + 2 * tig + (e & 1), col = n0 + cl + 8 * (e >> 1);
        if (row < g.M && col < g.N)  // int32 atomics wrap: the same sum in any order
          atomicAdd(ws + (long long)row * g.N + col, acc[mt][e]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      *s_last = atomicAdd(ws + (long long)g.M * g.N + blockIdx.x, 1) == (int)gridDim.y - 1;
    __syncthreads();
    if (!*s_last) return;
    __threadfence();  // every other split's adds are done: read the total
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * mt + 2 * tig + (e & 1), col = n0 + cl + 8 * (e >> 1);
        acc[mt][e] = row < g.M && col < g.N ? __ldcg(ws + (long long)row * g.N + col) : 0;
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * mt + 2 * tig + (e & 1), c = cl + 8 * (e >> 1);
      if (row < g.M && n0 + c < g.N)
        static_cast<int8_t*>(out)[(long long)row * g.N + n0 + c] =
            (int8_t)(QG_EPILOGUE ? epi::requant_wide(acc[mt][e], colc[c], rq) : acc[mt][e]);
    }
}

template <int MT, bool RAW, bool LEG>
int launch_mt(const int8_t* x, const int8_t* wk, void* out, const int32_t* bias,
              const int32_t* mult, const int32_t* shift, int32_t* ws, const int32_t* kzp,
              const epi::RqConst& rq, int32_t rq_izp, const Geo& g, int ks,
              cudaStream_t stream) {
  constexpr size_t smem = SK_STAGES * stage_bytes<MT>() + SK_BN * 16 + 16;
  static bool raised = false;  // once per instantiation, before any graph capture
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        qgemm_skinny<MT, RAW, LEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const dim3 grid((g.N + SK_BN - 1) / SK_BN, ks);
  qgemm_skinny<MT, RAW, LEG>
      <<<grid, NT, smem, stream>>>(x, wk, out, bias, mult, shift, ws, kzp, rq, rq_izp, g);
  return (int)cudaGetLastError();
}

// The skinny path at P_KS splits of P_KPER steps: M <= 64, rounded up to 8,
// 16, 32 or 64 rows of products.  K1's split needs the workspace `ws`; K4's
// (RAW) adds into `out`, which the caller zeroed.
template <bool RAW>
int launch(const int8_t* x, const int8_t* wk, void* out, const int32_t* bias,
           const int32_t* mult, const int32_t* shift, int32_t* ws, const int32_t* kzp,
           const int32_t* p, cudaStream_t s) {
  Geo g;
  g.M = p[P_N];
  g.K = p[P_CIN];
  g.N = p[P_COUT];
  g.steps = (g.K + KSTEP - 1) / KSTEP;
  g.kper = p[P_KPER];
  const int ks = p[P_KS];
  g.x16 = p[P_A_VEC] != 0 && g.K % 16 == 0;
  g.x8 = p[P_B_VEC] != 0 && g.K % 8 == 0;
  g.x_u8 = p[P_A_U8] != 0;
  if (g.M > MAX_M || ks < 1 || g.kper < 1 || (long long)ks * g.kper < g.steps ||
      (ks - 1) * g.kper >= g.steps || ks > 65535 || (!RAW && ks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (g.M <= 0 || g.N <= 0) return (int)cudaGetLastError();
  const epi::RqConst rq{p[P_OUT_ZP], p[P_QMIN], p[P_QMAX], p[P_TONEAREST] != 0};
  const int rq_izp = p[P_RQ_IZP];
  const bool leg = g.x_u8 || kzp != nullptr;  // legacy operands: their own instantiation
#define TK_MT(MT) (leg ? launch_mt<MT, RAW, true>(x, wk, out, bias, mult, shift, ws, kzp, rq,   \
                                                  rq_izp, g, ks, s)                             \
                       : launch_mt<MT, RAW, false>(x, wk, out, bias, mult, shift, ws, nullptr, \
                                                   rq, rq_izp, g, ks, s))
  if (g.M <= 8) return TK_MT(1);
  if (g.M <= 16) return TK_MT(2);
  if (g.M <= 32) return TK_MT(4);
  return TK_MT(8);
#undef TK_MT
}

}  // namespace skinny

// The tiled path's geometry: the GEMM as a 1x1 conv of 1 x 1 images, split
// P_KS ways; false for what the path does not take.
inline bool tiled_geo(const int32_t* p, const void* out, igemm::Geo& g) {
  if (p[P_QG_PATH] != 0 || p[P_KH] != 1 || p[P_KW] != 1 || p[P_H] != 1 || p[P_W] != 1 ||
      !igemm::make_geo(p, g) || !igemm::split_ok(p[P_KS], g))
    return false;
  g.a_vec8 = !g.a_vec && p[P_B_VEC] != 0 && g.cin % 16 == 8;
  g.o_vec = g.cout % 16 == 0 && (uintptr_t)out % 16 == 0;
  return true;
}

}  // namespace tk

// K1.  wk is w packed (Kp / 64, N, 64); P_QG_PATH 0 runs the tiled path at
// the tile (P_BM, P_BN) from {64, 128}^2, 1 the skinny path (M <= 64); K is
// split P_KS ways, P_KPER steps of 64 each (every split non-empty).  With
// P_KS > 1, ws is an int32 workspace of M * N sums and then one arrival
// counter a tile ((BM, BN) tiles on the tiled path, N / 64 on the skinny
// one), zeroed by the caller.  P_A_VEC: x may be copied 16 bytes at a time
// (K % 16 == 0, 16-byte aligned); P_B_VEC: 8 bytes (K % 8 == 0, 8-byte
// aligned).  P_A_U8: x is uint8; kzp, where not null, the weights' zero
// point a column.  Returns cudaGetLastError() (cudaErrorInvalidValue for a path,
// tile or split the kernel does not take).
extern "C" int tk_qgemm_rq(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
                           const int32_t* mult, const int32_t* shift, int32_t* ws,
                           const int32_t* kzp, const int32_t* p, void* stream) {
  using namespace tk;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p[P_QG_PATH] == 1)
    return skinny::launch<false>(x, wk, out, bias, mult, shift, ws, kzp, p, s);
  igemm::Geo g;
  if (!tiled_geo(p, out, g) || (p[P_KS] > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  return igemm::launch_tiled<igemm::RQ>(x, wk, out, nullptr, bias, mult, shift, ws, kzp,
                                        igemm::make_epi(p), g, p[P_KS], p, s);
}

// K4's GEMM mode.  wk, the paths, tiles, splits, P_A_U8 and kzp as K1's;
// with P_KS > 1 the splits add into `out`, which the caller zeroed, and split
// 0 adds the bias.  Returns cudaGetLastError() (cudaErrorInvalidValue for a
// path, tile or split the kernel does not take).
extern "C" int tk_qgemm_raw(const int8_t* x, const int8_t* wk, int32_t* out, const int32_t* bias,
                            const int32_t* kzp, const int32_t* p, void* stream) {
  using namespace tk;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p[P_QG_PATH] == 1)
    return skinny::launch<true>(x, wk, out, bias, nullptr, nullptr, nullptr, kzp, p, s);
  igemm::Geo g;
  if (!tiled_geo(p, out, g)) return (int)cudaErrorInvalidValue;
  return igemm::launch_tiled<igemm::RAW>(x, wk, out, nullptr, bias, nullptr, nullptr, nullptr,
                                         kzp, igemm::Epi{}, g, p[P_KS], p, s);
}
