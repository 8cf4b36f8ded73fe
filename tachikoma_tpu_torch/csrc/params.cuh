// The int32 parameter array that every C entry of the port's kernels takes
// in host memory: one layout for all (ops/kernels/_lib.py PARAMS mirrors it).
// K6's float32 scale travels as the int32 with its bits.
#pragma once

namespace tk {

enum Param {
  P_N, P_H, P_W, P_CIN, P_KH, P_KW, P_COUT, P_OH, P_OW, P_SH, P_SW, P_PT, P_PL,
  P_IZP, P_RQ_IZP, P_OUT_ZP, P_QMIN, P_QMAX, P_TONEAREST, P_A_VEC, P_B_VEC,
  P_L_SKIP, P_LM, P_LS, P_LZP, P_R_SKIP, P_RM, P_RS, P_RZP, P_ZO, P_LO, P_HI,
  P_ADD_TONEAREST,
  // K6 flash_attn: G = B*H, S, D, causal, and the bits of the float32 scale
  P_G, P_S, P_D, P_CAUSAL, P_SCALE_BITS,
  // the block tile of K1-K3 and K7-K10 (0 means 64)
  P_BM, P_BN,
  // K7-K10's most live taps per step (layouts_hopper.cuh)
  P_GROUP,
  // K11's input channels per staged chunk; K12's output tile (qconv_direct.cu)
  P_CC, P_TH, P_TW,
  // K2 and K4's conv mode: K split P_KS ways, P_KPER steps of 64 each (qconv_igemm_hopper.cu)
  P_KS, P_KPER,
  // K11's Hopper path: the N tile's weights resident in shared memory, the
  // steps its copies run ahead (qconv_direct.cu)
  P_WRES, P_AHEAD,
  // K6 flash_attn: heads; the element strides (batch, head, row) of q, k
  // and v; the plan of ops/kernels/flash_attention.py fa_plan (warps a
  // block, depth of Q.K^T, output columns a block, column blocks, Q and K read
  // from global memory, 16-byte copies)
  P_HEADS, P_Q_SB, P_Q_SH, P_Q_SS, P_K_SB, P_K_SH, P_K_SS, P_V_SB, P_V_SH, P_V_SS,
  P_FA_W, P_FA_DQ, P_FA_DV, P_FA_CS, P_FA_KG, P_FA_VEC,
  // K5's window row pitch in 4-byte words (its tile travels in P_CC, P_TH,
  // P_TW; qdwconv.cu)
  P_DW_RP,
  // K6's K and V tiles in flight (1 or 2), keys a tile
  P_FA_STAGES, P_FA_BK,
  // K1's path: 0 tiled (igemm_hopper.cuh), 1 skinny (qgemm_rq.cu)
  P_QG_PATH,
  // K1's batched mode (qbmm_hopper.cu Opnd) and qbmm_wide
  // (qbmm_wide_hopper.cu): the products, the inner batch dimension, each
  // operand's staging mode and element strides (batch 0, batch 1, row, k),
  // the zero points of A and B
  P_BMM_NB, P_BMM_NB1, P_A_MODE, P_B_MODE, P_A_SB0, P_A_SB1, P_A_SM, P_A_SK, P_B_SB0, P_B_SB1,
  P_B_SN, P_B_SK, P_BMM_ZA, P_BMM_ZB,
  // its path (0 tiles, 1 M <= 16)
  P_BMM_PATH,
  // K2 and K4's conv mode (igemm_hopper.cuh), qconv_wide
  // (qconv_wide_hopper.cu): the dilation (0 means 1), and the input channels
  // of a super-group of a grouped conv, whose N tiles read the contiguous run
  // of that many channels (0 means CIN: dense); K5's dilation too
  P_DH, P_DW, P_CSPAN,
  // K1, K2, K4 and K5: the data operand is uint8 (legacy uint8 models)
  P_A_U8,
  P_COUNT
};

}  // namespace tk
