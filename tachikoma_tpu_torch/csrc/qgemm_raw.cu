// K4 qgemm_raw / qconv_raw: the int8 GEMM or NHWC implicit-GEMM conv of
// qgemm.cuh with no requantize: out = acc + bias[n], int32 (M, N), in int32
// wraparound.  The input zero point works as in K2: taps outside the image
// read it, and the wrapper folds -izp * colsum(w) into the bias, so the
// result is the accumulator of sum (x_pad - izp) * w.
//
// Replaces tachikoma_tpu/ops/pallas/matmul_int8.py _mm_kernel_raw (entry
// qmatmul_int8 without a multiplier) and the fuse=False branch of
// conv_flat.py _flat_conv_kernel (entry qconv2d_flat without a multiplier).
// On the unfused int8 ResNet-50 graph, the graph the trace path runs, every
// qnn.conv2d and the qnn.dense go through it: 1x1 convs and the dense in
// GEMM mode (tk_qgemm_raw), the stem and the 3x3 convs in conv mode
// (tk_qconv_raw).
//
// Range: the deepest reduction of ResNet-50 is 3 * 3 * 512 = 4608 taps, and
// |x - izp| <= 255, |w| <= 128, so |acc| < 1.6e8 < 2^31: the accumulator
// cannot wrap on that path.
//
// What bounds it on an H100: the int32 output is four times the bytes of
// K1's int8 one, so every call of the path moves more than 1 byte per 590
// operations and is bound by bytes (the 1x1 convs at 4-30 operations per
// byte, the 3x3 convs at up to ~300).  The design is K1/K2's simple tiled
// body (64x64x64 tiles, register prefetch); the masked int32 store replaces
// the requantize.
#include "qgemm.cuh"

extern "C" int tk_qgemm_raw(const int8_t* x, const int8_t* w, int32_t* out, const int32_t* bias,
                            const int32_t* params, void* stream) {
  return tk::launch_qgemm_rq<false, false, true>(x, w, out, nullptr, bias, nullptr, nullptr,
                                                 params, stream);
}

extern "C" int tk_qconv_raw(const int8_t* x, const int8_t* w, int32_t* out, const int32_t* bias,
                            const int32_t* params, void* stream) {
  return tk::launch_qgemm_rq<true, false, true>(x, w, out, nullptr, bias, nullptr, nullptr,
                                                params, stream);
}
