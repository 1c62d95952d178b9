// gemm_batched.cu's batched CUDA-core launch for bf16 A: its 16 tile
// instantiations (output dtype x gate x packed B), compiled in parallel
// with the other sources'.
#include "gemm_tile.cuh"

template <>
int rt::run_batched<__nv_bfloat16, false>(const rt::Batched& g) {
  return rt::batched_by_out<__nv_bfloat16, false>(g);
}

template <>
int rt::run_batched<__nv_bfloat16, true>(const rt::Batched& g) {
  return rt::batched_by_out<__nv_bfloat16, true>(g);
}
