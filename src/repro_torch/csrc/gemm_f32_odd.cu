// The f32 ring's ODD instantiations (gemm_f32.cuh's gemm_f32_kernel with
// ODD true): C written one element at a time, for N % 4 != 0 or a C off 16
// bytes, where gemm_f32.cu's instantiations write 16-byte stores.  Their own
// source, so they compile beside gemm_f32.cu's and leave those unchanged.
// Reached through gemm_f32_launch and gemm_f32_batched_launch (kernels/gemm.py
// routes f32 TMA cannot address in place to "ffma_sm90" with `Plan.stage`:
// A, B and B2 copied into rows padded to 4 floats first where they are not,
// C written here where its rows are not whole 16-byte groups).
#include "gemm_f32.cuh"

int f32_ring_odd(const float* a, const float* b, const float* b2, const float* bias,
                 const float* res, float* c, int M, int K, int N, int lda, int ldb, int act,
                 int bm, int bn, cudaStream_t s, int batch, int b_batched) {
  const int tile = bm * 1000 + bn;
  if (batch) {
#define ODD_RUN(BM, BN, TM, TN, GATE)                                                 \
  if (tile == BM * 1000 + BN)                                                         \
    return run<Cfg<BM, BN, TM, TN, GATE>, true, true>(a, b, b2, bias, res, c, M, K, N, \
                                                      lda, ldb, act, s, batch, b_batched);
    if (b2) {
      ODD_RUN(128, 64, 8, 4, true)
      ODD_RUN(64, 64, 4, 4, true)
      ODD_RUN(32, 64, 4, 4, true)
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ODD_RUN(128, 128, 8, 8, false)
    ODD_RUN(128, 64, 8, 4, false)
    ODD_RUN(64, 64, 4, 4, false)
    ODD_RUN(32, 64, 4, 4, false)
#undef ODD_RUN
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define ODD_RUN(BM, BN, TM, TN, GATE)                                                  \
  if (tile == BM * 1000 + BN)                                                          \
    return run<Cfg<BM, BN, TM, TN, GATE>, false, true>(a, b, b2, bias, res, c, M, K, N, \
                                                       lda, ldb, act, s);
  if (b2) {
    ODD_RUN(128, 64, 8, 4, true)
    ODD_RUN(64, 64, 4, 4, true)
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ODD_RUN(128, 128, 8, 8, false)
  ODD_RUN(128, 64, 8, 4, false)
  ODD_RUN(64, 64, 4, 4, false)
#undef ODD_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}
