// K1 qgemm_rq: int8 x (M, K) times int8 w (K, N), int32 accumulator, exact
// requantize epilogue, int8 out (M, N).
//
// Replaces tachikoma_tpu/ops/pallas/matmul_int8.py _mm_kernel (built by
// _build_qmatmul, entry qmatmul_int8).  On the int8 ResNet-50 path it runs
// the 1x1 convs (M = batch * H * W, K = CIN, N = COUT) and the classifier
// dense (M = batch, K = 2048, N = 1000).
//
// What bounds it on an H100: a 1x1 conv does 2 * CIN * COUT / (CIN + COUT)
// operations per activation byte moved, at most 512 on this path, under the
// ~590 int8 operations per byte at which the tensor cores (1979 TOP/s)
// overtake memory (3.35 TB/s), so it is bound by bytes; the dense at M = 8
// reads 2 MB of weights for 33 MOP and is bound by bytes too.  The design
// (qgemm.cuh) is the simple tiled one: each block reads its A and B tiles
// into shared memory, and the int32 accumulator never leaves registers
// before the int8 store.
#include "qgemm.cuh"

extern "C" int tk_qgemm_rq(const int8_t* x, const int8_t* w, int8_t* out, const int32_t* bias,
                           const int32_t* mult, const int32_t* shift, const int32_t* params,
                           void* stream) {
  return tk::launch_qgemm_rq(x, w, out, bias, mult, shift, params, stream);
}
