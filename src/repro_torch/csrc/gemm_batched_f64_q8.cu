// gemm_batched.cu's batched CUDA-core launch for f64 A with a packed B: its 8
// tile instantiations (output dtype x gate), compiled in parallel with the
// other sources' (f64's take the longest to compile).  f64 out runs
// csrc/gemm_f64_q8.cu; this tile takes the other out dtypes and stays the
// first design's yardstick (chip_smoke.py's `first_tile_ms`).
#include "gemm_tile.cuh"

template <>
int rt::run_batched<double, true>(const rt::Batched& g) {
  return rt::batched_by_out<double, true>(g);
}
