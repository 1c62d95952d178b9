// Batched GEMM with a fused epilogue on the CUDA cores (sm_90a): the
// batched-B forms the Hopper kernels do not take, and any output dtype.
//
// Replaces `repro/kernels/bgemm.py` (`_bgemm_kernel`, pallas_call at :217) in
// its batched-B form (`bgemm.py:180-182`) and its `out_dtype`, wherever
// `kernels/gemm.py::plan_batched` routes to "ffma": C[z] = epi(A[z] @ B[z]
// [, A[z] @ B2[z]]) for z < batch in one launch, with A (batch, M, K), B and
// B2 (batch, K, N) (or one (K, N) shared by every member), bias (N,),
// residual and C (batch, M, N).  Since the batched forms moved to the
// kernels of their 2-D counterparts (bf16 to gemm_sm90.cu, f64 to
// gemm_f64.cu and gemm_f64_q8.cu, dense or packed, f32 with f32 out to the
// f32 ring of gemm_f32*.cu, dense or packed), that is: packed bf16
// "nk" stacks and bf16 "kn" ones whose scale blocks end inside a 64-row
// k-step, packed f32
// whose int8 rows (or A's) TMA cannot address, every output dtype other
// than bf16 and f32 from bf16 (f16, f64), f32 from f64 and f64 or bf16 or
// f16 from f32, bf16 with N % 8 != 0, and K = 0 (the epilogue alone).  No
// served model reaches it.  The sums and the epilogue run in max(f32, A's
// dtype), rounded once to C's dtype (f32, bf16, f64 or f16: a template
// parameter, so no output type costs the others a branch).
//
// Bound: bytes at the MoE shapes (M = 32 or 64 rows a member against a whole
// (K, N) expert matrix), operations at the BLAS ones.  This is gemm.cu's
// tile kernel (gemm_tile.cuh) with a batch coordinate: grid.z picks the
// member, whose A, C and residual start M*K and M*N elements on and whose
// B (and scales) start `sb` (`ss`) elements on, 0 for a shared B.  It keeps
// gemm.cu's 128 x 128 tile (128 x 64 with the gate), which wastes 3/4 of
// its rows at M = 32: a simple design that is right for the forms no served
// model reaches.  The f32 instantiations are here; bf16's and f64's are
// in gemm_batched_bf16.cu, gemm_batched_f64.cu (dense) and
// gemm_batched_f64_q8.cu (packed), compiled in parallel.
#include "gemm_tile.cuh"

using namespace rt;

template <>
int rt::run_batched<float, false>(const Batched& g) {
  return batched_by_out<float, false>(g);
}

template <>
int rt::run_batched<float, true>(const Batched& g) {
  return batched_by_out<float, true>(g);
}

namespace {

template <typename T>
int by_q(const Batched& g) {
  return g.q ? run_batched<T, true>(g) : run_batched<T, false>(g);
}

}  // namespace

// C[z] (M, N) = epi(A[z] (M, K) @ B[z] [, A[z] @ B2[z]]) for z < batch, one
// launch; A, bias and res in `dtype` (f32, bf16, f64), C in `out_dtype`
// (the same codes, and 3: f16).  B's member z starts z * sb elements on (sb
// = 0: one B for every member).  bs == NULL: B, B2 dense in `dtype`, (K, N)
// row-major.  Else B, B2 int8, stored (K, N) (nk = 0) or (N, K) (nk = 1),
// with f32 scales one per (qa, qb) block of the stored layout, member z's
// starting z * ss scales on.  b2/b2s, bias and res may be NULL.  Returns
// cudaErrorInvalidValue for a shape or dtype the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int gemm_batched_launch(int dtype, int out_dtype, const void* a, const void* b,
                                   const void* b2, const void* bs, const void* b2s, int qa,
                                   int qb, int nk, const void* bias, const void* res, void* c,
                                   int batch, long sb, long ss, int M, int K, int N, int act,
                                   void* stream) {
  const bool q = bs != nullptr;
  const int rows = nk ? N : K, cols = nk ? K : N;
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 0 || sb < 0 ||
      (q && (qa < 1 || qb < 1 || rows % qa || cols % qb || ss < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Batched g{out_dtype, q, a, b, b2, static_cast<const float*>(bs),
                  static_cast<const float*>(b2s), q ? qa : 1, q ? qb : 1, q && nk, bias, res, c,
                  batch, sb, ss, M, K, N, act, static_cast<cudaStream_t>(stream)};
  if (dtype == DT_F32) return by_q<float>(g);
  if (dtype == DT_BF16) return by_q<__nv_bfloat16>(g);
  if (dtype == DT_F64) return by_q<double>(g);
  return static_cast<int>(cudaErrorInvalidValue);
}
