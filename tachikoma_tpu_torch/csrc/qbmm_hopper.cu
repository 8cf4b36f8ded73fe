// K1's batched mode: tk_qbmm_rq (tk.bmm_rq, requantized to int8) and
// tk_qbmm_raw (qnn.batch_matmul, int32 in wraparound).  The JAX package
// leaves both to XLA (runtime/fuse.py tk.bmm_rq, ops/jax_ops.py
// qnn.batch_matmul); no Pallas kernel is replaced.  Each call is a batch of
// products (a - za)(b - zb) + bias, the batch two merged axes of the grid,
// each operand read in place through its element strides: the attention's
// scores q . k^T (q and k head-split views, k contiguous in K), its context
// softmax . v (the softmax output contiguous, zero point -128; v a view
// with N contiguous), the decode step's products against the caches at M =
// 1, the ring's chunks.
//
// What bounds it on an H100: latency.  Every call of the main path but the
// ring's moves under 2 MB (under 1 us of HBM time) and does under 0.5 GOP;
// the ring's scores write 12 x 2048^2 int32 (201 MB) a call, and there the
// store is the bound.  An earlier design, a template flag on K1-K4's
// persistent wgmma body, lost its time to five things (PERF.md, measured
// with tools/bmm_probe.py): (1) operands that are not K-major staged a byte
// at a time, (2) a 64-row tile at M = 1, (3) K = 64 as one step of a ring
// that then had nothing in flight, (4) unstaged stores (a byte a store at N
// = 197), (5) the -128 zero point folded arithmetically.  This kernel:
//
//   * Path S, M <= 16 (the decode step; point 2): no wgmma and no tile.  A
//     warp computes one row of one product at a group of columns with no
//     shared memory and no barrier (qbmm_row), its row of A read straight
//     from global memory; the rows of a product are consecutive warps, so
//     B's bytes reach the later rows from L1 or L2.  B K-major (the scores
//     against the K cache): four lanes a column, 16 bytes a load, dp4a, the
//     lanes' sums added by shuffles.  B with N contiguous (the context
//     against the V cache): 16 columns a lane, four rows of k transposed in
//     registers with __byte_perm into the dp4a operands, the k-splits' sums
//     added by shuffles.
//   * Path T (tiles: every other call).  One block per (product, M tile, N
//     tile), no persistent walk (point 3: one to four items a block had
//     nothing to amortise); BM 64 or 128 rows (a consumer warpgroup each),
//     BN 64 or 256 columns as n64 wgmma sub-tiles (256: ViT's N = 197 one
//     tile, its rows stored whole; tools/bmm_probe.py --plans; 128-column
//     tiles, QB_BN128, were slower at every call).  Where K fits (K <= 256:
//     D 64, S 128 and 197) it is staged whole, once: one wait and one
//     barrier a tile instead of one a 64-byte step (point 3).  Above that
//     (the ring's context at K 1024-2048) in chunks of 256 bytes, two
//     buffers, the next chunk's loads in flight while the current chunk's
//     wgmmas run (64-byte chunks, QB_KC 64, were slower at every tiled call
//     and twice as slow at the ring's context).
//   * Staging (point 1).  A K-major operand with 16-byte aligned rows
//     arrives by 16-byte cp.async copies (zero-filled past K; .ca); one
//     whose rows are not 16-byte aligned (the softmax output at S 197) by
//     aligned 16-byte loads realigned in registers (load16: a funnel shift),
//     written with 16-byte shared stores; an operand with its rows
//     contiguous (v) 16 rows of one k a 16-byte load, four k at a time,
//     transposed in registers four bytes at a time (__byte_perm) and written
//     K-major with 4-byte shared stores in a lane-rotated order that spreads
//     them over the banks.  A thread issues all its loads of both operands
//     before its first shared store.  No byte-a-load path is left: an
//     operand with neither stride 1 is copied by the wrapper.
//   * Zero point -128 on either side (point 5).  a - (-128) is a's bit
//     pattern with the sign bit flipped, read unsigned: the operand is
//     flipped while it is staged (in registers, or for a cp.async copy in
//     shared memory once it has landed, by the thread that issued it) and
//     the product runs as wgmma ... .s32.u8.s8 (.s8.u8, .u8.u8),
//     dp4a.u32.s32 on path S, with no column or row sum for that side (the
//     fold in its place, QB_FLIP 0, was 3-19% slower at every context
//     product but the ring's, where the flip pass over the copies costs
//     7%).  Any
//     other zero point keeps the exact fold -za colsum(B) - zb rowsum(A) +
//     K za zb (int32 wraparound), its sums taken from the staged tiles with
//     dp4a.
//   * Epilogue (point 4).  RQ requantizes each fragment value with
//     requantize.cuh's exact q_multiply_shift (epilogue_hopper.cuh
//     requant_wide, the column constants loaded once a block) and stages
//     the tile in shared memory: rows that start 16-byte aligned (N % 16 ==
//     0) as pairs of columns, leaving in 16-byte stores; a tile of whole
//     rows at any N (ViT-B/16's N = 197 at BN 256) as one run keeping its
//     alignment mod 16, leaving in aligned 16-byte stores with only the
//     run's two ends a byte at a time.  A tile that is part of rows that
//     are not aligned stores a byte a value from the fragments (staged,
//     QB_PARTIAL_STAGED, each row leaves through two ragged ends: ViT-L/16's
//     scores 9.1 against 6.8 us).  RAW adds the bias and stores straight
//     from the fragments, an int2 a pair of columns where N is even (a
//     warp's store is whole 32-byte sectors; a staged int32 tile,
//     QB_RAW_STAGED, took 130.9 against 96.0 us at the ring's scores and
//     1.3x at BERT's trace: the tile's pass through shared memory and its
//     barrier are not hidden).  Path S stores a warp's outputs in one
//     transaction.
//
// Integer sums wrap alike in any order, so every path gives the same
// integers on every run.
#include "epilogue_hopper.cuh"
#include "layouts_hopper.cuh"

// The parts that tools/bmm_probe.py cuts out, one at a time (each is 1 in
// the kernel as it runs).
#define QB_LOADS 1     // 0: no operand is read (the tiles hold what shared memory held)
#define QB_MMA 1       // 0: no product (no wgmma on path T, no dp4a on path S)
#define QB_EPILOGUE 1  // 0: nothing is stored
#define QB_BODY 1      // 0: every block returns as it starts
#define QB_REQUANT 1   // 0: the RQ epilogue stores the sum plus the bias's low byte, no requantize
// The designs that tools/bmm_probe.py holds this one against (each is as
// below in the kernel as it runs; every one gives the same integers).
#define QB_FLIP 1      // 0: a zero point of -128 folded like any other (no u8 operand)
#define QB_KC 0        // 64, 128 or 256: path T stages K in chunks of QB_KC bytes at any K
#define QB_RAW_STAGED 0      // 1: the RAW tile staged in shared memory, leaving in 16-byte stores
#define QB_PARTIAL_STAGED 0  // 1: an RQ tile that is part of unaligned rows staged too
#define QB_BN128 0     // 1: path T also takes 128-column tiles

namespace tk {
namespace bmm {

using hop::fence_proxy_async;
using hop::gmma_desc;
using hop::wgmma_commit;
using hop::wgmma_fence;
using hop::wgmma_wait0;

// How an operand is staged (ops/kernels/matmul_int8.py BMM_STAGES): k
// contiguous by cp.async (every row 16-byte aligned, no flip), k contiguous
// by realigned loads, rows contiguous by loads transposed in registers.
enum Stage { KMAJOR16 = 0, KMAJOR = 1, ROWS = 2 };
enum Path { TILES = 0, SMALL = 1 };
constexpr int RPAD = 16;       // bytes of padding a row of the staged output tile
constexpr int S_NT = 128;      // path S: threads a block
constexpr int S_MAX_M = 16;    // path S takes M <= S_MAX_M (matmul_int8.py SMALL_M)

// One operand: element (r, k) of product z = z0 nb1 + z1 at p + z0 sb0 +
// z1 sb1 + r sr + k sk (A: r < M; B: r = n < N).
struct Opnd {
  const int8_t* p;
  long long sb0, sb1, sr, sk;
  int rows, mode;
};

struct Args {
  Opnd a, b;
  void* out;  // (nb, M, N): int8 (RQ) or int32 (raw)
  const int32_t* bias;
  const int32_t* mult;
  const int32_t* shift;
  epi::RqConst rq;
  int32_t rq_izp;
  int M, K, N, nb, nb1;  // nb products, nb1 of them along the inner batch axis
  int za, zb;  // the zero points left once a -128 is flipped into its operand (0 there)
  int raw;
  int kc, kc_log, nchunks;  // path T: K chunk bytes (64 << kc_log), chunks
  int n_tiles;              // path T: N tiles
  int off_cols, off_zs;     // shared memory offsets
};

// ---------------------------------------------------------------------------
// pieces
// ---------------------------------------------------------------------------

// d = c + the dot product of the four bytes of a and b, each read signed
// (s8) or, flipped, unsigned (u8).
template <bool UA, bool UB>
__device__ __forceinline__ int32_t dot4(uint32_t a, uint32_t b, int32_t c) {
  int32_t d;
  if constexpr (!UA && !UB)
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else if constexpr (UA && !UB)
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else if constexpr (!UA && UB)
    asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else
    asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The sum of the 16 bytes of v (signed, or U: unsigned), added to c.
template <bool U>
__device__ __forceinline__ int32_t sum16(uint4 v, int32_t c) {
  c = dot4<U, false>(v.x, 0x01010101u, c);
  c = dot4<U, false>(v.y, 0x01010101u, c);
  c = dot4<U, false>(v.z, 0x01010101u, c);
  return dot4<U, false>(v.w, 0x01010101u, c);
}

__device__ __forceinline__ uint32_t byte_mask(int n) {  // the low n bytes (n clamped to 0..4)
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// The 16 bytes at p (any alignment): the first `valid` (1..16) read, the
// rest zero; FLIP flips the sign bit of each byte read.  Only the aligned
// 16-byte words that hold one of the read bytes are loaded (each lies in the
// tensor's allocation), then realigned in registers: whole words by
// selects, the rest by a funnel shift.
template <bool FLIP>
__device__ __forceinline__ uint4 load16(const int8_t* p, int valid) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const int sh = (int)(addr & 15);
  const uint4* const q = reinterpret_cast<const uint4*>(addr - sh);
  uint32_t w[4];
  if (sh == 0) {
    const uint4 v = __ldg(q);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint4 lo = __ldg(q);
    const uint4 hi = sh + valid > 16 ? __ldg(q + 1) : make_uint4(0, 0, 0, 0);
    uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (sh & 8) {
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = x[i + 2];
    }
    if (sh & 4) {
#pragma unroll
      for (int i = 0; i < 7; ++i) x[i] = x[i + 1];
    }
    const int bits = 8 * (sh & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], bits);
  }
  const uint32_t f = FLIP ? 0x80808080u : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = (w[i] ^ f) & byte_mask(valid - 4 * i);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes from global to shared memory, the first n (0..16) copied, the
// rest zero-filled (cp.async's source size); cached in L1 as well (.ca: the
// ring's calls ran 0.837 ms a forward at sp 2 against 1.032 with .cg,
// tools/bmm_probe.py, the others unchanged).
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// 4x4 byte transpose: v[q] holds k + q of four rows; t[i] gets row i's k .. k + 3.
__device__ __forceinline__ void transpose4(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                                           uint32_t* t) {
  const uint32_t a = __byte_perm(v0, v1, 0x5140), b = __byte_perm(v2, v3, 0x5140);
  const uint32_t c = __byte_perm(v0, v1, 0x7362), d = __byte_perm(v2, v3, 0x7362);
  t[0] = __byte_perm(a, b, 0x5410);
  t[1] = __byte_perm(a, b, 0x7632);
  t[2] = __byte_perm(c, d, 0x5410);
  t[3] = __byte_perm(c, d, 0x7632);
}

// The 16 rows x 4 k block of v (v[q]: rows 0..15 at k + q) as 16 words,
// word i = row i's k .. k + 3.
__device__ __forceinline__ void transpose16x4(const uint4 (&v)[4], uint32_t (&t)[16]) {
  transpose4(v[0].x, v[1].x, v[2].x, v[3].x, t);
  transpose4(v[0].y, v[1].y, v[2].y, v[3].y, t + 4);
  transpose4(v[0].z, v[1].z, v[2].z, v[3].z, t + 8);
  transpose4(v[0].w, v[1].w, v[2].w, v[3].w, t + 12);
}

// Byte offset of (row r, 16-byte K segment seg) in a K-major tile of kc
// bytes a row, in wgmma's no-swizzle core-matrix layout: 8 rows x 16 bytes
// a core matrix, LBO 128 bytes to the next segment, SBO 8 kc to the next 8
// rows.
__device__ __forceinline__ int cm(int r, int seg, int kc) {
  return (r >> 3) * (kc << 3) + seg * 128 + (r & 7) * 16;
}

// Chunk q of the byte run [g, g + len) in global memory, copied from shared
// memory s (s == g mod 16): the aligned 16 bytes at (g & ~15) + 16 q, one
// 16-byte store where they lie in the run, else a byte at a time.
__device__ __forceinline__ void store_chunk(int8_t* g, const int8_t* s, int len, int q) {
  const long long lo =
      (long long)((reinterpret_cast<uintptr_t>(g) & ~(uintptr_t)15) + 16 * (uintptr_t)q) -
      (long long)reinterpret_cast<uintptr_t>(g);
  if (lo >= len) return;
  if (lo >= 0 && lo + 16 <= len) {
    *reinterpret_cast<uint4*>(g + lo) = *reinterpret_cast<const uint4*>(s + lo);
    return;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const long long o = lo + t;
    if (o >= 0 && o < len) g[o] = s[o];
  }
}

// The staged output tile (rows x cols elements of E bytes, row r of the
// tile at global element offset o0 + r N) stored by every thread of the
// block: as one run where the rows are contiguous (cols == N), else a run a
// row.  `roff(r)` is row r's byte offset in the staged tile `ot`.
template <int E, class Roff>
__device__ __forceinline__ void store_tile(void* out, long long o0, int N, int rows, int cols,
                                           const int8_t* ot, Roff roff, int nt) {
#if QB_EPILOGUE
  int8_t* const g0 = static_cast<int8_t*>(out) + o0 * E;
  if (cols == N) {
    const int len = rows * cols * E;
    const int n = (len + 31) >> 4;
    for (int q = threadIdx.x; q < n; q += nt) store_chunk(g0, ot + roff(0), len, q);
    return;
  }
  const int per = (cols * E + 31) >> 4;  // chunks a row touches, at most
  for (int i = threadIdx.x; i < rows * per; i += nt) {
    const int r = i / per;
    store_chunk(g0 + (long long)r * N * E, ot + roff(r), cols * E, i - r * per);
  }
#endif
}

// Row r's byte offset in a staged tile whose rows keep their global
// addresses' alignment mod 16: row pitch rs, or with `whole` (the rows
// contiguous in global memory) packed at N E bytes.
struct RowOff {
  uintptr_t g0;  // global address of row 0
  long long gs;  // global bytes between rows
  int rs;
  bool whole;
  __device__ __forceinline__ int operator()(int r) const {
    const int a0 = (int)(g0 & 15);
    if (whole) return a0 + r * (int)gs;
    return r * rs + (int)((g0 + (uintptr_t)(r * gs)) & 15);
  }
};

// The requantize of one sum with its column's constants (epilogue_hopper.cuh
// requant_wide: requantize.cuh's exact q_multiply_shift).
__device__ __forceinline__ int32_t rq(int32_t acc, int4 c, const epi::RqConst& e) {
#if QB_REQUANT
  return epi::requant_wide(acc, c, e);
#else
  return wrap_add(acc, c.x);
#endif
}

// ---------------------------------------------------------------------------
// path T: wgmma tiles
// ---------------------------------------------------------------------------

#define TK_WGMMA64(TA, TB)                                                                     \
  asm volatile(                                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." TA "." TB " "                              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"                                     \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"                             \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),   \
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),             \
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),          \
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),          \
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),          \
        "+r"(d[31])                                                                            \
      : "l"(da), "l"(db), "r"(1))

// d (64 x 64, int32) += A (64 x 32 bytes) . B (64 x 32 bytes)^T, both
// K-major in shared memory by descriptor; UA / UB: the operand's bytes read
// unsigned (its zero point -128 flipped in).
template <bool UA, bool UB>
__device__ __forceinline__ void wgmma64(int32_t (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (!UA && !UB)
    TK_WGMMA64("s8", "s8");
  else if constexpr (UA && !UB)
    TK_WGMMA64("u8", "s8");
  else if constexpr (!UA && UB)
    TK_WGMMA64("s8", "u8");
  else
    TK_WGMMA64("u8", "u8");
}
#undef TK_WGMMA64

// A chunk's staging is a list of items per operand: an item of a
// k-contiguous operand is one 16-byte segment of a row (cm layout), a warp
// taking 8 rows by 4 segments (64 contiguous bytes of each row; its 512
// bytes of 16-byte shared stores in 4 wavefronts); an item of an operand
// with its rows contiguous is 16 rows by 4 k.  Rows past the operand's and
// k past K read as zeros.  A thread takes items tid, tid + NT, ... in
// rounds of KM k-contiguous items or KM / 4 rows items of each operand; a
// round issues all its loads of both operands before its first store.

// The number of items of an R-row operand tile of kc bytes of K.
template <int R>
__device__ __forceinline__ int items(const Opnd& op, int kc) {
  return op.mode == ROWS ? (R / 16) * (kc >> 2) : R * (kc >> 4);
}

// (row, segment) of a k-contiguous item.
__device__ __forceinline__ int2 km_item(int i, int kc_log) {
  const int lo = i & 31, hi = i >> 5;
  return make_int2(((hi >> kc_log) << 3) + (lo >> 2), ((hi & ((1 << kc_log) - 1)) << 2) + (lo & 3));
}

// The bytes of k-contiguous item (row r, segment s) that lie in the operand
// (0 past its rows or K).
__device__ __forceinline__ int km_valid(const Opnd& op, int r0, int k0, int2 rs, const Args& g) {
  return r0 + rs.x < op.rows ? min(16, g.K - (k0 + 16 * rs.y)) : 0;
}

// A round's loads: a KMAJOR16 item a cp.async copy straight into dst (no
// registers), a KMAJOR item one 16-byte load (realigned where the row is
// not aligned), a ROWS item four (rows r .. r + 15 at k .. k + 3).
template <int R, int NT, int KM, bool FLIP>
__device__ __forceinline__ void load_round(const Opnd& op, const int8_t* base, int r0, int k0,
                                           int round, int8_t* dst, const Args& g,
                                           uint4 (&v)[KM]) {
  const int n = items<R>(op, g.kc);
  if (op.mode == ROWS) {
    constexpr int G = R / 16;  // 16-row groups
#pragma unroll
    for (int j = 0; j < KM / 4; ++j) {
      const int i = threadIdx.x + (round * (KM / 4) + j) * NT;
      const int r = r0 + 16 * (i % G), k = k0 + 4 * (i / G);
      const int valid = i < n ? min(16, op.rows - r) : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[4 * j + q] = valid > 0 && k + q < g.K
                           ? load16<FLIP>(base + (long long)(k + q) * op.sk + r, valid)
                           : make_uint4(0, 0, 0, 0);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    const int i = threadIdx.x + (round * KM + j) * NT;
    if (i >= n) break;
    const int2 rs = km_item(i, g.kc_log);
    const int valid = km_valid(op, r0, k0, rs, g);
    const int8_t* const src = base + (long long)(r0 + rs.x) * op.sr + k0 + 16 * rs.y;
    if (op.mode == KMAJOR16)
      cp_async16_n(dst + cm(rs.x, rs.y, g.kc), valid > 0 ? src : base, max(valid, 0));
    else
      v[j] = valid > 0 ? load16<FLIP>(src, valid) : make_uint4(0, 0, 0, 0);
  }
}

// A round's shared stores: a KMAJOR item with one 16-byte store; a ROWS
// item's 16 x 4 bytes transposed in registers into 16 words (a row's 4 k
// each), stored with 4-byte shared stores, the rows in an order rotated by
// the lane so that a warp's stores spread over the banks.
template <int R, int NT, int KM>
__device__ __forceinline__ void store_round(const Opnd& op, int round, int8_t* dst,
                                            const Args& g, uint4 (&v)[KM]) {
  const int n = items<R>(op, g.kc);
  if (op.mode == KMAJOR) {
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      const int i = threadIdx.x + (round * KM + j) * NT;
      if (i >= n) break;
      const int2 rs = km_item(i, g.kc_log);
      *reinterpret_cast<uint4*>(dst + cm(rs.x, rs.y, g.kc)) = v[j];
    }
    return;
  }
  if (op.mode != ROWS) return;
  constexpr int G = R / 16;
  const int rot = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < KM / 4; ++j) {
    const int i = threadIdx.x + (round * (KM / 4) + j) * NT;
    if (i >= n) break;
    const int rl = 16 * (i % G), kl = 4 * (i / G);
    uint32_t t[16];
    const uint4 w[4] = {v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]};
    transpose16x4(w, t);
    // t[e] <- t[e ^ rot] by a butterfly of selects (the index stays static)
#pragma unroll
    for (int b = 1; b < 8; b <<= 1) {
      const bool sw = rot & b;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (!(e & b)) {
          const uint32_t x = t[e], y = t[e | b];
          t[e] = sw ? y : x;
          t[e | b] = sw ? x : y;
        }
    }
    int8_t* const d = dst + (kl & 15) + (kl >> 4) * 128;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = rl + (e ^ rot);
      *reinterpret_cast<uint32_t*>(d + (r >> 3) * (g.kc << 3) + (r & 7) * 16) = t[e];
    }
  }
}

template <int R, int NT, int KM>
__device__ __forceinline__ int rounds(const Opnd& op, const Args& g) {
  const int per = (op.mode == ROWS ? KM / 4 : KM) * NT;
  return (items<R>(op, g.kc) + per - 1) / per;
}

// Chunk k0 .. k0 + kc of the tile's A (rows m0 ..) and B (rows n0 ..) into
// buf (A's BM rows, then B's BN).  The caller commits the copies and waits.
template <int BM, int BN, int NT, bool FA, bool FB, int KM>
__device__ __forceinline__ void stage_chunk(int8_t* buf, const Args& g, const int8_t* abase,
                                            const int8_t* bbase, int m0, int n0, int k0) {
#if QB_LOADS
  int8_t* const bdst = buf + BM * g.kc;
  const int ra = rounds<BM, NT, KM>(g.a, g), rb = rounds<BN, NT, KM>(g.b, g);
  for (int round = 0; round < max(ra, rb); ++round) {
    uint4 va[KM], vb[KM];
    if (round < ra) load_round<BM, NT, KM, FA>(g.a, abase, m0, k0, round, buf, g, va);
    if (round < rb) load_round<BN, NT, KM, FB>(g.b, bbase, n0, k0, round, bdst, g, vb);
    if (round < ra) store_round<BM, NT, KM>(g.a, round, buf, g, va);
    if (round < rb) store_round<BN, NT, KM>(g.b, round, bdst, g, vb);
  }
#endif
}

// The sign flip of a KMAJOR16 operand whose zero point is -128: once this
// thread's copies of the chunk have landed, it flips the bytes it copied
// that lie in the operand (the zero fill past its rows and K stays zero).
template <int R, int NT, bool FLIP>
__device__ __forceinline__ void flip_copies(const Opnd& op, int r0, int k0, int8_t* dst,
                                            const Args& g) {
#if QB_LOADS
  if (!FLIP || op.mode != KMAJOR16) return;
  const int n = items<R>(op, g.kc);
  for (int i = threadIdx.x; i < n; i += NT) {
    const int2 rs = km_item(i, g.kc_log);
    const int valid = km_valid(op, r0, k0, rs, g);
    if (valid <= 0) continue;
    uint4* const p = reinterpret_cast<uint4*>(dst + cm(rs.x, rs.y, g.kc));
    uint4 w = *p;
    w.x ^= 0x80808080u & byte_mask(valid);
    w.y ^= 0x80808080u & byte_mask(valid - 4);
    w.z ^= 0x80808080u & byte_mask(valid - 8);
    w.w ^= 0x80808080u & byte_mask(valid - 12);
    *p = w;
  }
#endif
}

// The zero points' sums of a staged chunk (the remaining za needs B's
// column sums, zb A's row sums), added into zs (BM rows, then BN columns).
template <int BM, int BN, int NT, bool FA, bool FB>
__device__ __forceinline__ void zp_sums(const int8_t* buf, int32_t* zs, const Args& g) {
  const int segs = g.kc >> 4;
  if (g.zb != 0)
    for (int i = threadIdx.x; i < BM * segs; i += NT) {
      const int r = i / segs, s = i - r * segs;
      atomicAdd(zs + r, sum16<FA>(*reinterpret_cast<const uint4*>(buf + cm(r, s, g.kc)), 0));
    }
  if (g.za != 0)
    for (int i = threadIdx.x; i < BN * segs; i += NT) {
      const int r = i / segs, s = i - r * segs;
      atomicAdd(zs + BM + r,
                sum16<FB>(*reinterpret_cast<const uint4*>(buf + BM * g.kc + cm(r, s, g.kc)), 0));
    }
}

// Path T.  Block (x: N tile + n_tiles * M tile, y: product) computes the
// BM x BN tile (BM = 64 WG, BN = 64 NJ) of one product: stages K in
// g.nchunks chunks of g.kc bytes (one: K whole), runs WG x NJ m64n64k32
// wgmmas a 32 bytes of K, and stores the tile through shared memory.
template <int WG, int NJ, bool FA, bool FB>
__global__ void __launch_bounds__(128 * WG, NJ == 1 ? 4 / WG : 1) qbmm_tiles(Args g) {
  constexpr int NT = 128 * WG, BM = 64 * WG, BN = 64 * NJ;
  extern __shared__ __align__(128) int8_t smem[];
#if !QB_BODY
  if (g.M >= 0) return;
#endif
  const int tid = threadIdx.x;
  const int z = blockIdx.y, z0 = z / g.nb1, z1 = z - z0 * g.nb1;
  const int mt = blockIdx.x / g.n_tiles, nt = blockIdx.x - mt * g.n_tiles;
  const int m0 = mt * BM, n0 = nt * BN;
  const int8_t* const abase = g.a.p + z0 * g.a.sb0 + z1 * g.a.sb1;
  const int8_t* const bbase = g.b.p + z0 * g.b.sb0 + z1 * g.b.sb1;
  const int kc = g.kc, stage_bytes = (BM + BN) * kc;
  int4* const colc = reinterpret_cast<int4*>(smem + g.off_cols);
  int32_t* const zs = reinterpret_cast<int32_t*>(smem + g.off_zs);
  const bool zp = g.za != 0 || g.zb != 0;

  // the columns' bias, multiplier and shift read first, into registers, so
  // that no wait for the operands holds their loads back
  constexpr int CPT = (BN + NT - 1) / NT;  // columns a thread
  int32_t cbias[CPT], cmult[CPT], cshift[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int n = n0 + tid + i * NT;
    const bool ok = tid + i * NT < BN && n < g.N;
    cbias[i] = ok ? g.bias[n] : 0;
    cmult[i] = ok && !g.raw ? g.mult[n] : 0;
    cshift[i] = ok && !g.raw ? g.shift[n] : 0;
  }
  const int wg = tid >> 7;
  int32_t acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0;
  const int sbo = kc << 3;
  // iteration c stages chunk c (its loads issued while chunk c - 1's
  // wgmmas run) and multiplies chunk c - 1: the staging code is emitted once
  for (int c = 0; c <= g.nchunks; ++c) {
    const int8_t* const as = smem + ((c - 1) & 1) * stage_bytes;  // chunk c - 1
    const int8_t* const bs = as + BM * kc;
#if QB_MMA
    if (c > 0) {
      wgmma_fence();
      for (int kk = 0; kk < (kc >> 5); ++kk) {
        const uint64_t da = gmma_desc(as + wg * 64 * kc + kk * 256, 128, sbo);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          wgmma64<FA, FB>(acc[j], da, gmma_desc(bs + j * 64 * kc + kk * 256, 128, sbo));
      }
      wgmma_commit();
    }
#endif
    int8_t* const buf = smem + (c & 1) * stage_bytes;  // chunk c
    if (c < g.nchunks) {
      stage_chunk<BM, BN, NT, FA, FB, 4>(buf, g, abase, bbase, m0, n0, c * kc);
      hop::cp_async_commit();
    }
    if (c == 0) {  // while the first loads fly: the zero-point sums zeroed, the columns'
                   // constants (epilogue_hopper.cuh load_cols) or bias
      if (zp)
        for (int i = tid; i < BM + BN; i += NT) zs[i] = 0;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int cl = tid + i * NT;
        if (cl >= BN) break;
        if (g.raw) {
          reinterpret_cast<int32_t*>(colc)[cl] = cbias[i];
        } else {
          const int sh = cshift[i];
          colc[cl] = n0 + cl < g.N ? make_int4(wrap_sub(cbias[i], g.rq_izp), cmult[i],
                                               sh > 0 ? sh : 0, 31 + (sh < 0 ? -sh : 0))
                                   : make_int4(0, 0, 0, 31);
        }
      }
    } else {
      if (zp) zp_sums<BM, BN, NT, FA, FB>(as, zs, g);
#if QB_MMA
      wgmma_wait0();
#endif
    }
    if (c < g.nchunks) {
      hop::cp_async_wait0();
      flip_copies<BM, NT, FA>(g.a, m0, c * kc, buf, g);
      flip_copies<BN, NT, FB>(g.b, n0, c * kc, buf + BM * kc, g);
    }
    fence_proxy_async();
    __syncthreads();
  }

  // the epilogue: fragment acc[j][4 jb + 2 h + e] is row rl0 + 8 h of the
  // tile, column 64 j + 8 jb + 2 (lane % 4) + e; the staged tile `ot`
  // overlaps the (now idle) stages
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int rl0 = wg * 64 + 16 * warp + (lane >> 2);
  const int rows = min(BM, g.M - m0);
  if (zp) {
    const int32_t kzz = (int32_t)((uint32_t)g.K * (uint32_t)g.za * (uint32_t)g.zb);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = rl0 + 8 * h, c = 64 * j + 8 * jb + 2 * (lane & 3) + e;
            const int32_t cz = (int32_t)((uint32_t)g.za * (uint32_t)zs[BM + c]);
            const int32_t rz = (int32_t)((uint32_t)g.zb * (uint32_t)zs[r]);
            const int32_t f = wrap_sub(wrap_sub(kzz, cz), rz);
            acc[j][4 * jb + 2 * h + e] = wrap_add(acc[j][4 * jb + 2 * h + e], f);
          }
  }
  const long long o0 = ((long long)z * g.M + m0) * g.N + n0;  // element offset of the tile
  if (!g.raw) {  // the whole tile at once, int8, requantized from the fragments
    constexpr int RS = BN + RPAD;
    int8_t* const ot = smem;
    int8_t* const o8 = static_cast<int8_t*>(g.out);
    const int cols = min(BN, g.N - n0);
    if ((g.N & 15) == 0 && (reinterpret_cast<uintptr_t>(o8) & 15) == 0) {
      // every row 16-byte aligned: each pair of columns one 16-bit shared
      // store, the rows leaving in 16-byte stores (epilogue_hopper.cuh)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int c = 64 * j + 8 * jb + 2 * (lane & 3);
          const int4 c0 = colc[c], c1 = colc[c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int32_t q0 = rq(acc[j][4 * jb + 2 * h], c0, g.rq);
            const int32_t q1 = rq(acc[j][4 * jb + 2 * h + 1], c1, g.rq);
            *reinterpret_cast<uint16_t*>(ot + (rl0 + 8 * h) * RS + c) =
                (uint16_t)((q0 & 255) | (q1 & 255) << 8);
          }
        }
      __syncthreads();
#if QB_EPILOGUE
      epi::store_tile16(o8, ot, RS, rows, cols,
                        [&](int r) -> long long { return o0 + (long long)r * g.N; });
#endif
    } else if (!QB_PARTIAL_STAGED && cols != g.N) {
      // rows at any alignment, the tile a part of each: a byte a store
      // straight from the fragments (a staged row leaves through two ragged
      // ends a row; QB_PARTIAL_STAGED, PERF.md)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int c = 64 * j + 8 * jb + 2 * (lane & 3);
          if (c >= cols) continue;
          const int4 c0 = colc[c], c1 = colc[c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rl0 + 8 * h;
            if (r >= rows) continue;
            int8_t* const o = o8 + o0 + (long long)r * g.N + c;
            const int32_t q0 = rq(acc[j][4 * jb + 2 * h], c0, g.rq);
            const int32_t q1 = rq(acc[j][4 * jb + 2 * h + 1], c1, g.rq);
#if QB_EPILOGUE
            o[0] = (int8_t)q0;
            if (c + 1 < cols) o[1] = (int8_t)q1;
#endif
          }
        }
    } else {  // whole rows at any alignment: one run, staged keeping its alignment mod 16
      const RowOff roff{reinterpret_cast<uintptr_t>(o8 + o0), g.N, RS, cols == g.N};
      int ro[2];  // the thread's two rows in the staged tile (-1: past M)
#pragma unroll
      for (int h = 0; h < 2; ++h) ro[h] = rl0 + 8 * h < rows ? roff(rl0 + 8 * h) : -1;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int c = 64 * j + 8 * jb + 2 * (lane & 3);
          if (c >= cols) continue;
          const int4 c0 = colc[c], c1 = colc[c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (ro[h] < 0) continue;
            int8_t* const o = ot + ro[h] + c;
            o[0] = (int8_t)rq(acc[j][4 * jb + 2 * h], c0, g.rq);
            if (c + 1 < cols) o[1] = (int8_t)rq(acc[j][4 * jb + 2 * h + 1], c1, g.rq);
          }
        }
      __syncthreads();
      store_tile<1>(g.out, o0, g.N, rows, cols, ot, roff, NT);
    }
  } else {
    // int32, the bias added, straight from the fragments: one int2 store a
    // pair of columns where N is even (a warp's store is 8 rows of 32
    // contiguous bytes: whole sectors), else two (QB_RAW_STAGED: the tile
    // staged in shared memory and leaving in 16-byte stores, PERF.md)
    const int32_t* const bias = reinterpret_cast<const int32_t*>(colc);
    int32_t* const o32 = static_cast<int32_t*>(g.out) + o0;
    const bool pairs = (g.N & 1) == 0 && (reinterpret_cast<uintptr_t>(g.out) & 7) == 0;
#if QB_RAW_STAGED
    const int cols = min(BN, g.N - n0);
    const RowOff roff{reinterpret_cast<uintptr_t>(o32), 4ll * g.N, 4 * BN + RPAD, cols == g.N};
    int8_t* const ot = smem;
#endif
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int c = 64 * j + 8 * jb + 2 * (lane & 3);
        if (n0 + c >= g.N) continue;
        const int32_t b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl0 + 8 * h;
          if (r >= rows) continue;
          const int32_t v0 = wrap_add(acc[j][4 * jb + 2 * h], b0);
          const int32_t v1 = wrap_add(acc[j][4 * jb + 2 * h + 1], b1);
#if QB_RAW_STAGED
          int32_t* const o = reinterpret_cast<int32_t*>(ot + roff(r)) + c;
          o[0] = v0;
          if (n0 + c + 1 < g.N) o[1] = v1;
#elif QB_EPILOGUE
          int32_t* const o = o32 + (long long)r * g.N + c;
          if (pairs) {
            *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
          } else {
            o[0] = v0;
            if (n0 + c + 1 < g.N) o[1] = v1;
          }
#endif
        }
      }
#if QB_RAW_STAGED
    __syncthreads();
    store_tile<4>(g.out, o0, g.N, rows, cols, ot, roff, NT);
#endif
  }
}

// ---------------------------------------------------------------------------
// path S: M <= 16 rows
// ---------------------------------------------------------------------------

// Path S, M <= 16 (the decode step at M = 1): a warp computes one row of one
// product at a group of columns with no shared memory and no barrier, the
// row of A read straight from global memory (its bytes shared by the warp's
// lanes through L1), the column constants loaded with the operands, every
// load of a round issued before the first product; warp w takes row w /
// groups of the nb M rows (product z = row / M), column group w % groups:
//   * B K-major (the scores against the K cache): 8 columns, four lanes a
//     column (lane = 4 column + q), lane q taking the 16-byte segments q, q
//     + 4, ... of K, dp4a, the four lanes' sums added by shuffles;
//   * B with its rows contiguous (the context against the V cache): 16
//     columns, lane l taking k = 4 l, 4 l + 128, ...: four 16-byte loads (k
//     .. k + 3, the 16 columns) transposed in registers into the columns'
//     dp4a operands, the 32 lanes' sums added by shuffles, lane c storing
//     column c (the warp's 16 outputs one transaction).
// The column's requantize constants, as epilogue_hopper.cuh load_cols makes
// them, or its bias (raw).
__device__ __forceinline__ int4 column(const Args& g, int n) {
  if (n >= g.N) return make_int4(0, 0, 0, 31);
  if (g.raw) return make_int4(g.bias[n], 0, 0, 0);
  const int s = g.shift[n];
  return make_int4(wrap_sub(g.bias[n], g.rq_izp), g.mult[n], s > 0 ? s : 0, 31 + (s < 0 ? -s : 0));
}

// One output from its sum, its column's constants and the zero points' fold.
__device__ __forceinline__ int32_t finish_row(int32_t acc, int4 c, int32_t fold, const Args& g) {
  acc = wrap_add(acc, fold);
  return g.raw ? wrap_add(acc, c.x) : rq(acc, c, g.rq);
}

template <bool FA, bool FB>
__global__ void __launch_bounds__(S_NT) qbmm_row(Args g) {
#if !QB_BODY
  if (g.M >= 0) return;
#endif
  const int lane = threadIdx.x & 31;
  const bool rows_b = g.b.mode == ROWS;
  const int cw = rows_b ? 16 : 8, groups = (g.N + cw - 1) / cw;
  const long long w = (long long)blockIdx.x * (S_NT / 32) + (threadIdx.x >> 5);
  if (w >= (long long)g.nb * g.M * groups) return;
  const int row = (int)(w / groups), n0 = (int)(w - (long long)row * groups) * cw;
  const int z = row / g.M, m = row - z * g.M;
  const int z0 = z / g.nb1, z1 = z - z0 * g.nb1;
  const int8_t* const arow =
      g.a.p + z0 * g.a.sb0 + z1 * g.a.sb1 + m * g.a.sr;  // A's row m, k contiguous
  const int8_t* const bbase = g.b.p + z0 * g.b.sb0 + z1 * g.b.sb1;
  const int32_t kzz = (int32_t)((uint32_t)g.K * (uint32_t)g.za * (uint32_t)g.zb);
  const long long o0 = (long long)row * g.N;  // the output row's element offset
  auto fold = [&](int32_t cs, int32_t ra) {
    return wrap_sub(wrap_sub(kzz, (int32_t)((uint32_t)g.za * (uint32_t)cs)),
                    (int32_t)((uint32_t)g.zb * (uint32_t)ra));
  };
  if (!rows_b) {
    const int cl = lane >> 2, q = lane & 3, n = n0 + cl;
    const int segs = (g.K + 15) >> 4;
    const int8_t* const bcol = bbase + (long long)n * g.b.sr;
    const int4 cc = column(g, n);
    int32_t acc = 0, cs = 0, ra = 0;
    for (int s0 = q; s0 < segs; s0 += 16) {
      uint4 va[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + 4 * j;
        const int valid = s < segs ? min(16, g.K - 16 * s) : 0;
#if QB_LOADS
        va[j] = valid > 0 ? load16<FA>(arow + 16 * s, valid) : make_uint4(0, 0, 0, 0);
        vb[j] = valid > 0 && n < g.N ? load16<FB>(bcol + 16 * s, valid) : make_uint4(0, 0, 0, 0);
#else
        va[j] = vb[j] = make_uint4(0, 0, 0, 0);
#endif
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#if QB_MMA
        acc = dot4<FA, FB>(va[j].x, vb[j].x, acc);
        acc = dot4<FA, FB>(va[j].y, vb[j].y, acc);
        acc = dot4<FA, FB>(va[j].z, vb[j].z, acc);
        acc = dot4<FA, FB>(va[j].w, vb[j].w, acc);
#endif
        if (g.za != 0) cs = sum16<FB>(vb[j], cs);
        if (g.zb != 0) ra = sum16<FA>(va[j], ra);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      acc = wrap_add(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      cs = wrap_add(cs, __shfl_xor_sync(0xffffffffu, cs, o));
      ra = wrap_add(ra, __shfl_xor_sync(0xffffffffu, ra, o));
    }
#if QB_EPILOGUE
    if (q == 0 && n < g.N) {
      const int32_t v = finish_row(acc, cc, fold(cs, ra), g);
      if (g.raw)
        static_cast<int32_t*>(g.out)[o0 + n] = v;
      else
        static_cast<int8_t*>(g.out)[o0 + n] = (int8_t)v;
    }
#endif
    return;
  }
  // rows contiguous: 16 columns a warp, lane l taking k = 4 l, 4 l + 128, ...
  const int valid = min(16, g.N - n0);
  const int4 cc = column(g, n0 + (lane & 15));  // the column this lane finishes
  int32_t acc[16], cs[16], ra = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c) acc[c] = cs[c] = 0;
  for (int k0 = 4 * lane; k0 < g.K; k0 += 4 * 32 * 2) {  // a round: two steps of 128 k
    uint4 vb[2][4];
    uint32_t va[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + 128 * i;
#if QB_LOADS
      va[i] = k < g.K ? load16<FA>(arow + k, min(4, g.K - k)).x : 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        vb[i][q] = k + q < g.K ? load16<FB>(bbase + (long long)(k + q) * g.b.sk + n0, valid)
                               : make_uint4(0, 0, 0, 0);
#else
      va[i] = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) vb[i][q] = make_uint4(0, 0, 0, 0);
#endif
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t t[16];
      transpose16x4(vb[i], t);
#if QB_MMA
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = dot4<FA, FB>(va[i], t[c], acc[c]);
#endif
      if (g.za != 0)
#pragma unroll
        for (int c = 0; c < 16; ++c) cs[c] = dot4<FB, false>(t[c], 0x01010101u, cs[c]);
      if (g.zb != 0) ra = dot4<FA, false>(va[i], 0x01010101u, ra);
    }
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // the 32 k-splits
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = wrap_add(acc[c], __shfl_xor_sync(0xffffffffu, acc[c], o));
    if (g.za != 0)
#pragma unroll
      for (int c = 0; c < 16; ++c) cs[c] = wrap_add(cs[c], __shfl_xor_sync(0xffffffffu, cs[c], o));
    ra = wrap_add(ra, __shfl_xor_sync(0xffffffffu, ra, o));
  }
  // lane c < 16 finishes column n0 + c: the warp's 16 outputs in one store
  int32_t sum = acc[0], csum = cs[0];
#pragma unroll
  for (int c = 1; c < 16; ++c)
    if ((lane & 15) == c) sum = acc[c], csum = cs[c];
#if QB_EPILOGUE
  if (lane < valid) {
    const int32_t v = finish_row(sum, cc, fold(csum, ra), g);
    if (g.raw)
      static_cast<int32_t*>(g.out)[o0 + n0 + lane] = v;
    else
      static_cast<int8_t*>(g.out)[o0 + n0 + lane] = (int8_t)v;
  }
#endif
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Raises the kernel's dynamic shared memory ceiling to the card's, once.
template <class Kern>
int raise_once(Kern kern, bool& done) {
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hop::SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <int WG, int NJ, bool FA, bool FB>
int launch_tiles(const Args& g, int nb, cudaStream_t s) {
  constexpr int BM = 64 * WG, BN = 64 * NJ;
  auto kern = qbmm_tiles<WG, NJ, FA, FB>;
  static bool raised = false;  // once per instantiation, before any graph capture
  if (const int rc = raise_once(kern, raised)) return rc;
  Args a = g;
  const int m_tiles = (g.M + BM - 1) / BM;
  a.n_tiles = (g.N + BN - 1) / BN;
  const int stages = (BM + BN) * g.kc * (g.nchunks > 1 ? 2 : 1);
  const int tile = g.raw ? (QB_RAW_STAGED ? BM * (4 * BN + RPAD) : 0) : BM * (BN + RPAD);
  a.off_cols = (std::max(stages, tile) + 127) & ~127;
  a.off_zs = a.off_cols + BN * 16;
  const int smem = a.off_zs + (BM + BN) * 4;
  if (smem > (int)hop::SMEM_LIMIT || (long long)m_tiles * a.n_tiles > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  qbmm_tiles<WG, NJ, FA, FB><<<dim3(m_tiles * a.n_tiles, nb), 128 * WG, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool FA, bool FB>
int launch_row(const Args& g, int nb, cudaStream_t s) {
  const int cw = g.b.mode == ROWS ? 16 : 8;  // columns a warp
  const long long warps = (long long)nb * g.M * ((g.N + cw - 1) / cw);
  const long long blocks = (warps + S_NT / 32 - 1) / (S_NT / 32);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  qbmm_row<FA, FB><<<(unsigned)blocks, S_NT, 0, s>>>(g);
  return (int)cudaGetLastError();
}

template <bool FA, bool FB>
int launch_flips(const Args& g, int path, int bm, int bn, int nb, cudaStream_t s) {
  if (path == SMALL) return launch_row<FA, FB>(g, nb, s);
#define TK_TILE(WG, NJ) \
  if (bm == 64 * WG && bn == 64 * NJ) return launch_tiles<WG, NJ, FA, FB>(g, nb, s);
  TK_TILE(1, 1)
  TK_TILE(1, 4)
  TK_TILE(2, 1)
  TK_TILE(2, 4)
#if QB_BN128
  TK_TILE(1, 2)
  TK_TILE(2, 2)
#endif
#undef TK_TILE
  return (int)cudaErrorInvalidValue;
}

// The call's arguments from the parameter array; false for what the kernel
// does not take.
inline bool make_args(const int32_t* p, const int8_t* a, const int8_t* b, void* out,
                      const int32_t* bias, const int32_t* mult, const int32_t* shift, bool raw,
                      Args& g, int& nb) {
  g.M = p[P_N];
  g.K = p[P_CIN];
  g.N = p[P_COUT];
  g.nb1 = p[P_BMM_NB1];
  nb = p[P_BMM_NB];
  g.nb = nb;
  g.a = Opnd{a, p[P_A_SB0], p[P_A_SB1], p[P_A_SM], p[P_A_SK], g.M, p[P_A_MODE]};
  g.b = Opnd{b, p[P_B_SB0], p[P_B_SB1], p[P_B_SN], p[P_B_SK], g.N, p[P_B_MODE]};
  g.out = out;
  g.bias = bias;
  g.mult = mult;
  g.shift = shift;
  g.rq = epi::RqConst{p[P_OUT_ZP], p[P_QMIN], p[P_QMAX], p[P_TONEAREST] != 0};
  g.rq_izp = p[P_RQ_IZP];
  g.raw = raw;
  g.za = QB_FLIP && p[P_BMM_ZA] == -128 ? 0 : p[P_BMM_ZA];
  g.zb = QB_FLIP && p[P_BMM_ZB] == -128 ? 0 : p[P_BMM_ZB];
  // path T: K whole in one chunk where it is at most 256 bytes (the least of
  // 64, 128 and 256 that holds it: D 64, S 128 and 197), else in chunks of
  // 256 bytes, two buffers (matmul_int8.py bmm_kc)
  g.kc = QB_KC ? QB_KC : g.K <= 64 ? 64 : g.K <= 128 ? 128 : 256;
  g.kc_log = g.kc == 64 ? 0 : g.kc == 128 ? 1 : 2;
  g.nchunks = (g.K + g.kc - 1) / g.kc;
  if (g.M < 0 || g.K < 0 || g.N < 0 || nb < 0 || nb > 65535 || g.nb1 < 1) return false;
  auto takes = [](const Opnd& o) {
    return o.mode == ROWS ? o.sr == 1 : (o.mode == KMAJOR16 || o.mode == KMAJOR) && o.sk == 1;
  };
  if (!takes(g.a) || !takes(g.b)) return false;
  if (p[P_BMM_PATH] == SMALL) return g.M <= S_MAX_M && g.a.mode != ROWS;
  return p[P_BMM_PATH] == TILES;
}

inline int launch(const int32_t* p, const int8_t* a, const int8_t* b, void* out,
                  const int32_t* bias, const int32_t* mult, const int32_t* shift, bool raw,
                  cudaStream_t s) {
  Args g;
  int nb = 0;
  if (!make_args(p, a, b, out, bias, mult, shift, raw, g, nb)) return (int)cudaErrorInvalidValue;
  if (g.M == 0 || g.N == 0 || nb == 0) return (int)cudaGetLastError();
  const bool fa = QB_FLIP && p[P_BMM_ZA] == -128, fb = QB_FLIP && p[P_BMM_ZB] == -128;
  const int path = p[P_BMM_PATH], bm = p[P_BM], bn = p[P_BN];
  if (fa && fb) return launch_flips<true, true>(g, path, bm, bn, nb, s);
  if (fa) return launch_flips<true, false>(g, path, bm, bn, nb, s);
  if (fb) return launch_flips<false, true>(g, path, bm, bn, nb, s);
  return launch_flips<false, false>(g, path, bm, bn, nb, s);
}

}  // namespace bmm
}  // namespace tk

// K1's batched mode, requantizing: P_BMM_NB products (M, K) x (K, N) of int8
// a and b read through their strides and staging modes (P_A_*, P_B_*; Opnd),
// each (a - P_BMM_ZA)(b - P_BMM_ZB) plus the bias (N,), requantized with the
// per-column mult and shift (N,) into out (nb, M, N) int8; P_BMM_PATH 0 runs
// path T at the tile (P_BM, P_BN), 1 path S (M <= 16).
// Returns cudaGetLastError() (cudaErrorInvalidValue for what the kernel does
// not take).
extern "C" int tk_qbmm_rq(const int8_t* a, const int8_t* b, int8_t* out, const int32_t* bias,
                          const int32_t* mult, const int32_t* shift, const int32_t* p,
                          void* stream) {
  return tk::bmm::launch(p, a, b, out, bias, mult, shift, false, (cudaStream_t)stream);
}

// The same products plus the bias (N,) into out (nb, M, N) int32, in
// wraparound (qnn.batch_matmul).
extern "C" int tk_qbmm_raw(const int8_t* a, const int8_t* b, int32_t* out, const int32_t* bias,
                           const int32_t* p, void* stream) {
  return tk::bmm::launch(p, a, b, out, bias, nullptr, nullptr, true, (cudaStream_t)stream);
}
