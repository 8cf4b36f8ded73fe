// K2 qconv_rq, K3 qconv_rq_res and K4's conv mode qconv_raw: the NHWC int8
// conv as an implicit GEMM on Hopper's wgmma, persistent blocks, a cp.async
// ring; one body (igemm_hopper.cuh), three epilogues (Mode).  K1's tiled
// path (qgemm_rq.cu) launches the same body in K2's mode on a GEMM as a 1x1
// conv of 1 x 1 images, with 8-byte copies of A where CIN % 16 == 8.
//
//   K2 qconv_rq replaces tachikoma_tpu/ops/pallas/conv_flat.py
//      _flat_conv_kernel (:68, pl.pallas_call at :370; entry qconv2d_flat,
//      fuse=True): any stride, padding and CIN; requantize, int8 out.  On
//      the int8 ResNet-50 path it runs the 7x7 s2 stem, the three strided
//      3x3 convs and the 3x3 stages of the chains and block stacks; on
//      VGG-16 every conv.
//   K3 qconv_rq_res replaces conv_flat.py _flat_conv_kernel_f (:1285,
//      pl.pallas_call at :1432; entries qconv2d_flat_chain and
//      qconv2d_flat_block_stack): the last stage of a residual block, a
//      stride-1 conv (any KH, KW, padding) whose epilogue requantizes and
//      then applies the fused residual qnn.add, int8 out.
//   K4 qconv_raw replaces the fuse=False branch of _flat_conv_kernel: any
//      stride, padding and CIN; the int32 accumulator plus bias in
//      wraparound, int32 out.  The trace path's stem and 3x3 convs run on it.
//
// The GEMM.  Row m = (image, oy, ox) of the output, column n = output
// channel, k = (ky, kx, ci) over KH*KW*CIN, padded with zeros to Kp, a
// multiple of 64.  The weights are packed once per weight tensor, K-major
// step by step, as (Kp / 64, COUT, 64) (ops/kernels/conv.py
// kmajor_weights), so the B tile of a step is BN * 64 contiguous bytes and
// the padding needs no mask: a warp's copies read 512 contiguous bytes.  A is gathered from the
// caller's NHWC image: a thread stages the same two rows and the same 16-byte
// segment at every step of a tile, so it works out its rows' (image, oy, ox)
// once a tile (multiply-high constants) and walks its segment's (ky, kx, ci)
// by additions.  With CIN % 16 == 0 a segment lies in one tap and is one
// 16-byte cp.async (for a 1x1 conv, a row-major (M, CIN) matrix); a tap
// outside the image is the input zero point, written by a 16-byte shared
// store (cp.async's zero fill is zero, not izp; the wrapper folds
// -izp * colsum(w) into the bias).  A narrow CIN (the CIN-3 stems) gathers
// its 16 bytes one by one.
//
// Dilation and groups (K2 and K4's conv mode).  A dilated tap (ky, kx) reads
// input row oy*sh - pt + ky*dh and column ox*sw - pl + kx*dw: the segment walk
// is the same and only the tap's offset is scaled.  A grouped conv (CIN / G
// input and COUT / G output channels a group) runs as one dense conv a
// super-group of S consecutive groups: an N tile lies inside one super-group
// (S * COUT / G is a multiple of BN, or S = G), reads the contiguous run of
// S * CIN / G channels of x that the super-group's groups read, and K is
// KH * KW * S * CIN / G.  The wrapper expands the weights block-diagonally to
// (KH, KW, S * CIN / G, COUT), zero where a column's group does not read the
// channel, and packs that K-major once per weight tensor
// (ops/kernels/conv.py grouped_weights).  So the body is unchanged but for
// the A base (offset by the super-group's first channel) and the channel
// count of the segment walk; the zero weights waste S times the useful
// products, which on ResNeXt-50's grouped 3x3 calls (S = 16, 8, 4, 2 at
// BN 64) cost little against the copies that bound them.
//
// The main loop.  Both tiles sit in shared memory in wgmma's no-swizzle
// core-matrix layout (8 rows x 16 bytes a core matrix; LBO 128, SBO 512), and
// a 64-deep step is two wgmma.mma_async m64nBNk32 .s32.s8.s8 per warpgroup,
// one warpgroup per 64 rows.  No .satfinite: int32 sums wrap, as the
// reference's do.
//
// Persistent blocks.  K3's calls are many short items (a 64 x 64 tile after
// 1-8 steps of 64 at ResNet-50 b8's default tile), and a block that stages,
// waits, multiplies, runs its epilogue and stores one tile leaves the
// copies' latency exposed on every tile.  So the grid holds as many blocks
// as the card holds at once (the occupancy API), each block keeps one N tile
// and walks every gm-th M tile, and its copies run as one stream of stages
// over its items (a ring of three stages for K3, four for K2 and K4), K3's
// at most one item ahead: the next item's A, B and residual copies are in
// flight while this item is multiplied and its epilogue runs.  Where K has
// at most two steps, K3's block keeps its weights resident (its items all
// read the same N tile's K range) and the ring carries A alone.  One barrier
// a step, one or two more per item for the staged output tile.
//
// The epilogues (epilogue_hopper.cuh, shared with K11).  The per-column
// constants are read once per block into shared memory; the requantize's
// product is one mul.wide.s32 and then the left shift (requant_wide); the
// fragment is requantized into a staged tile, and the tile leaves in 16-byte
// rows where COUT % 16 == 0 (else element by element).  K3 adds:
//   * the residual add as two 256-entry int32 tables in shared memory: the
//     conv's side is the int8 value the plain version hands to the add, the
//     residual an int8, so out = clip(TL[v] + TR[r], lo, hi) exactly, with
//     TR holding the output zero point's subtraction (a skipped side's
//     table is the identity).  The block builds both in its prologue, two
//     to four entries a thread, from the plan of ops/kernels/requantize.py
//     plan_res_add;
//   * the residual tile comes into shared memory by cp.async with the
//     item's first stage, and each output pair replaces its residual pair
//     there (the staged tile).
// On the H100 the first port's epilogue (csrc/qgemm.cuh: three 64-bit
// q_multiply_shifts, three per-channel global loads, byte-wise residual and
// output traffic) was 30% of K3's time (tools/parent_k3_k4.py).
//
// Splits of K.  Where the tiles leave the SMs idle, the wrapper splits K
// over the z dimension of the grid (ops/kernels/conv.py raw_split for K4,
// rq_split for K2): block z walks steps [z*kper, min((z+1)*kper, steps)).
//   * K4 adds its int32 partial sums into an output the wrapper zeroed, with
//     red.global.add.s32; split 0 alone adds the bias, which each block
//     stages in shared memory while its first copies fly (read after the
//     main loop it cost K4's GEMM mode 1.1 us a call on the H100:
//     tools/gemm_probe.py --raw).
//   * K2's requantize needs the whole sum, so its splits add their partial
//     sums into an int32 workspace the wrapper zeroed (M x COUT, then one
//     arrival counter a tile), each block fences its adds and then counts
//     itself in on the tile's counter, and the block that arrives last reads
//     the complete sums back (from L2) and alone runs the epilogue.  This
//     form was chosen over a cluster adding through distributed shared
//     memory because it needs no co-scheduling: the split is any size (a 7^2
//     call of ResNet-50 b8 takes 5), the persistent grid keeps the occupancy
//     API's size, and a block that is not last goes straight on to its next
//     item instead of waiting at a cluster barrier.
// Integer sums wrap the same in any order, so both give the same integers
// on every run.  Unsplit (ks 1), the sums go straight to the epilogue.
//
// What bounds them on the H100: K3's calls and K4's b1 calls are bound by
// their bytes (0.027 ms for ResNet-50 b8's K3, 0.0066 ms for K4), K2's 3x3
// calls by the int8 tensor-core peak (0.0177 ms per ResNet-50 b8 forward,
// 0.1318 for VGG-16 b8's 122.8 GMAC); none comes near.  What holds them
// above that, measured with tools/igemm_probe.py and tools/conv_probe.py
// --cuts: a fixed cost of a few microseconds a call, for K3 the epilogue's
// integer work, and for K2 the copies (cutting the wgmmas or the epilogue
// saved under 5%, the A and B copies 80%).  K2's copies are cached in L1
// as well as L2 (cp.async.ca): a 3x3 call's A rows at neighbouring taps
// overlap and an SM's blocks share the weights, and in L2 alone (.cg) its
// copies ran at 1.6-3 TB/s and took K2 2.6x its time at ResNet-50 b8's
// 56^2 call.  The 64 x 64 tile stages 8 KB per 262 K products; where a
// call has the tiles to fill the card the wrapper takes 128-row tiles
// (conv.py rq_tile), which stage half as much per product.
#include "igemm_hopper.cuh"

// K2.  wk is the weight packed (Kp / 64, COUT, 64) (kmajor_weights, or
// grouped_weights' block-diagonal expansion with P_CSPAN its super-group's
// channels); the tile is (P_BM, P_BN) from {64, 128}^2; any stride and
// dilation (P_DH, P_DW).  K is split P_KS ways, P_KPER
// steps of 64 each (every split non-empty); with P_KS > 1, ws is an int32
// workspace of M * COUT sums and one counter per (BM, BN) tile, zeroed by
// the caller.  x is uint8 where P_A_U8 is set (read as wgmma's .u8
// operand, izp 0..255); kzp, where not null, is the weights' zero point a
// column (the bias carries -izp colsum(w) + K izp kzp: igemm_hopper.cuh);
// a uint8 output is the same bytes at qmin 0, qmax 255.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a tile not built or a
// split that does not cover the steps).
extern "C" int tk_qconv_rq(const int8_t* x, const int8_t* wk, int8_t* out, const int32_t* bias,
                           const int32_t* mult, const int32_t* shift, int32_t* ws,
                           const int32_t* kzp, const int32_t* p, void* stream) {
  using namespace tk;
  igemm::Geo g;
  if (!igemm::make_geo(p, g)) return (int)cudaErrorInvalidValue;
  const int ks = p[P_KS];
  if (!igemm::split_ok(ks, g) || (ks > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  g.o_vec = g.cout % 16 == 0 && (uintptr_t)out % 16 == 0;
  return igemm::launch_tiled<igemm::RQ>(x, wk, out, nullptr, bias, mult, shift, ws, kzp,
                                        igemm::make_epi(p), g, ks, p, (cudaStream_t)stream);
}

// K3.  wk as K2's; the tile is (P_BM, P_BN) from {64, 128}^2; stride 1.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a stride other than
// 1 or a tile not built).
extern "C" int tk_qconv_rq_res(const int8_t* x, const int8_t* wk, int8_t* out,
                               const int32_t* bias, const int32_t* mult, const int32_t* shift,
                               const int8_t* residual, const int32_t* p, void* stream) {
  using namespace tk;
  igemm::Geo g;
  if (!igemm::make_geo(p, g) || g.sh != 1 || g.sw != 1 || g.a_u8)
    return (int)cudaErrorInvalidValue;
  g.kper = g.steps;
  g.o_vec = g.cout % 16 == 0 && ((uintptr_t)residual | (uintptr_t)out) % 16 == 0;
  igemm::Epi e = igemm::make_epi(p);
  e.l_skip = p[P_L_SKIP] != 0;
  e.r_skip = p[P_R_SKIP] != 0;
  e.add_tonearest = p[P_ADD_TONEAREST] != 0;
  e.lm = p[P_LM];
  e.ls = p[P_LS];
  e.lzp = p[P_LZP];
  e.rm = p[P_RM];
  e.rs = p[P_RS];
  e.rzp = p[P_RZP];
  e.zo = p[P_ZO];
  e.lo = p[P_LO];
  e.hi = p[P_HI];
  return igemm::launch_tiled<igemm::RES>(x, wk, out, residual, bias, mult, shift, nullptr,
                                         nullptr, e, g, 1, p, (cudaStream_t)stream);
}

// K4's conv mode.  wk, dilation, P_CSPAN, P_A_U8 and kzp as K2's; the tile is 64 x 64; K is
// split P_KS ways, P_KPER steps of 64 each (every split non-empty), into an output the caller
// zeroed when P_KS > 1.  Returns cudaGetLastError() (cudaErrorInvalidValue
// for a split that does not cover the steps).
extern "C" int tk_qconv_raw(const int8_t* x, const int8_t* wk, int32_t* out, const int32_t* bias,
                            const int32_t* kzp, const int32_t* p, void* stream) {
  using namespace tk;
  igemm::Geo g;
  if (!igemm::make_geo(p, g)) return (int)cudaErrorInvalidValue;
  const int ks = p[P_KS];
  if (!igemm::split_ok(ks, g)) return (int)cudaErrorInvalidValue;
  if (g.M <= 0 || g.cout <= 0) return (int)cudaGetLastError();
  return igemm::launch_tile<igemm::RAW, 64, 64>(x, wk, out, nullptr, bias, nullptr, nullptr,
                                                nullptr, kzp, igemm::Epi{}, g, ks,
                                                (cudaStream_t)stream);
}
