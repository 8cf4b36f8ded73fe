// K4 qgemm_raw, the GEMM mode of K4: the int8 GEMM of qgemm.cuh with no
// requantize: out = acc + bias[n], int32 (M, N), in int32 wraparound.  K4's
// conv mode (tk_qconv_raw) is qconv_igemm_hopper.cu; there, as in K2, taps
// outside the image read the input zero point, and the wrapper folds
// -izp * colsum(w) into the bias, so the result is the accumulator of
// sum (x_pad - izp) * w.
//
// Replaces tachikoma_tpu/ops/pallas/matmul_int8.py _mm_kernel_raw (entry
// qmatmul_int8 without a multiplier).
// On the unfused int8 ResNet-50 graph, the graph the trace path runs, every
// qnn.conv2d and the qnn.dense go through K4: 1x1 convs and the dense in
// GEMM mode (tk_qgemm_raw, here), the stem and the 3x3 convs in conv mode.
//
// What bounds it on an H100: the int32 output is four times the bytes of
// K1's int8 one, so every call of the path moves more than 1 byte per 590
// operations and is bound by bytes (the 1x1 convs at 4-30 operations per
// byte).  The design is K1's simple tiled
// body (64x64x64 tiles, register prefetch); the masked int32 store replaces
// the requantize.
#include "qgemm.cuh"

extern "C" int tk_qgemm_raw(const int8_t* x, const int8_t* w, int32_t* out, const int32_t* bias,
                            const int32_t* params, void* stream) {
  return tk::launch_qgemm_rq<true>(x, w, out, bias, nullptr, nullptr, params, stream);
}

