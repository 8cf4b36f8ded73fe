// K2 qconv_rq: NHWC int8 convolution as an implicit GEMM (M = N * OH * OW,
// N = COUT, K = KH * KW * CIN), any stride and padding, taps outside the
// image read the input zero point, exact requantize epilogue, int8 out.
//
// K2 replaces tachikoma_tpu/ops/pallas/conv_flat.py _flat_conv_kernel (built
// by _build_flat_conv, called by _conv_mxu, entry qconv2d_flat).  On the int8
// ResNet-50 path it runs the 7x7 s2 stem (CIN = 3, gathered byte by byte)
// and the three strided 3x3 convs, and the 3x3 stages of the chain and the
// block stacks.  The TPU kernel reads a padded, flattened, phase-stacked
// image; this one gathers each im2col row straight from the NHWC image, so
// no padded or phase-stacked copy is ever written.
//
// What bounds it on an H100: the 3x3 convs of the path do 440-580
// operations per byte moved, just under the ~590 int8 operations per byte at
// which the tensor cores (1979 TOP/s) overtake memory (3.35 TB/s), so they
// are bound by bytes, barely.  See qgemm.cuh for the tiling.  K3
// (qconv_rq_res), the residual stage, is qconv_igemm_hopper.cu.
#include "qgemm.cuh"

extern "C" int tk_qconv_rq(const int8_t* x, const int8_t* w, int8_t* out, const int32_t* bias,
                           const int32_t* mult, const int32_t* shift, const int32_t* params,
                           void* stream) {
  return tk::launch_qgemm_rq<true>(x, w, out, bias, mult, shift, params, stream);
}

