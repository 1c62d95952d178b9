// GEMM with a fused epilogue on the CUDA cores (sm_90a): K = 0 (the
// epilogue alone) and the int8-B forms no Hopper kernel takes.
//
// Replaces, for the forms `kernels/gemm.py::plan` routes to "ffma", two
// Pallas kernels with one body and two entry points.  Every dense bf16 call
// runs the tensor cores instead (`csrc/gemm_sm90.cu`, on copies with padded
// rows where TMA cannot address the operands), every dense f64 call the f64
// tensor cores (`csrc/gemm_f64.cu`), every dense f32 call the f32 ring
// (`csrc/gemm_f32.cu`, on copies with padded rows where TMA cannot address
// the operands), f32 A against int8 rows TMA can address the f32 ring too
// (`csrc/gemm_f32_q8.cu`), f64 A against any packed B the f64 tensor cores
// (`csrc/gemm_f64_q8.cu`) and bf16 A against "kn" B with a scale block of
// whole 64-row k-steps the bf16 ones (`csrc/gemm_sm90.cu`).  What still
// runs here: K = 0, bf16 A against "kn" whose scale block ends inside a
// k-step or whose rows TMA cannot address, or "nk" with scales that vary
// along K, and f32 A whose int8 rows (or A's rows) TMA cannot address.  The
// dense bodies and the packed f64 one are reached otherwise only by
// chip_smoke.py's `ffma_launch` and `scripts/torch_gemm_study.py`, as the
// yardstick (the packed f64 instantiations leave as ROADMAP §2.2 item 1
// says):
//  - `gemm_launch`: `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at
//    :184) in its dense "kn" form, C = epi( A @ B  [, A @ B2] ), with A
//    (M, K), B and B2 (K, N) row-major, bias (N,), residual (M, N) and C
//    (M, N) in A's dtype; the sums and the epilogue run in max(f32, dtype).
//    `repro/kernels/bgemm.py` (`_bgemm_kernel`, pallas_call at :217) in its
//    broadcast-B form is the same GEMM over the batch * M rows of A, so the
//    f32 prefill projections take this entry point too;
//  - `gemm_q8_launch`: the packed bodies of both (`gemm.py:63-76`,
//    `bgemm.py:80-90`): B (and B2) block-scaled int8 with f32 scales
//    (core/quant.py), in the "kn" layout (stored (K, N), scale blocks
//    (qa, qb) over it) or the output-major "nk" layout (stored (N, K), blocks
//    (qa, qb) over that).  B is dequantized in the accumulator type, deq =
//    value * scale, as `dequant_tile(..., dtype=acc)` does: never rounded to
//    A's dtype.  Here: bf16 with "kn" the tensor cores cannot take or "nk"
//    whose scales vary along K, and f32 whose rows TMA cannot address.
//
// Bound: operations.  At 8192^3 the product does 1.1e12 flops on 1.6 GB (f64),
// ~700 flops per byte, far above the ridge of the card.  This kernel runs on
// the CUDA cores (FFMA, and DFMA for f64, whose 34 TFLOP/s peak is half the
// f64 tensor cores'), so f64 here sits far above its bound; see PERF.md.
//
// Design: the paper's processing element mapped onto an SM.  Its 4 x 4
// register block (the DOT4 PE) is each thread's unit of work: a thread owns
// 2 x NB such blocks of C, rows ty*4 + {0, 64} and columns tx*4 + {0, 64}
// (NB = 2, or 1 under the gate, whose second accumulator doubles the
// registers), so a block of 16 x 16 threads owns a 128 x 64*NB tile.  The
// block sweeps K in steps of BK = 8 through two shared-memory buffers: the
// next step's tiles are loaded into registers while this step's are
// multiplied, so one barrier a step suffices.  Every value read from shared
// memory feeds 4*NB (A) or 8 (B) multiply-adds.
//  - Ragged M, N and K are masked in the kernel (the reference pads in
//    ops._gemm_call instead): out-of-range elements of BOTH A and B load as
//    zero, because 0 x garbage is NaN; the stores skip the fringe.
//  - Tiles are visited in groups of 8 tile rows (grouped raster), so blocks
//    that run together share their A and B panels in L2.
//  - Element offsets are 64-bit, so an operand may pass 2^31 elements.
//  - int8 B is staged in registers as int8 (its storage type, as A and the
//    dense B are) beside its elements' scales, and dequantized on the way
//    into the float shared-memory tile.  "nk" is read along K (each thread
//    a few contiguous bytes of one stored row) and written transposed into
//    Bs[k][n], so the multiply loop is the dense one.  A scale index costs a
//    division only along an axis with more than one scale block.
// f32 stays on FFMA (TF32 would change the result).
// The tile body lives in gemm_tile.cuh, shared with gemm_batched.cu (the
// batched-B form of bgemm.py and any output dtype).
#include "gemm_tile.cuh"

using namespace rt;

namespace {

// The 2-D entry points: one member, C in A's type.
template <typename T, bool Q>
int run(const void* a, const void* b, const void* b2, const float* bs, const float* b2s,
        int qa, int qb, bool nk, const void* bias, const void* res, void* c, int M, int K,
        int N, int act, cudaStream_t s) {
  return run_tiles<T, T, Q>(a, b, b2, bs, b2s, qa, qb, nk, bias, res, c, 1, 0, 0, M, K, N, act,
                            s);
}

template <typename T>
int run(const void* a, const void* b, const void* b2, const void* bias, const void* res,
        void* c, int M, int K, int N, int act, cudaStream_t s) {
  return run<T, false>(a, b, b2, nullptr, nullptr, 1, 1, false, bias, res, c, M, K, N, act, s);
}

}  // namespace

// b2, bias and res may be NULL.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_launch(int dtype, const void* a, const void* b, const void* b2,
                           const void* bias, const void* res, void* c, int M, int K, int N,
                           int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return run<float>(a, b, b2, bias, res, c, M, K, N, act, s);
  if (dtype == DT_BF16) return run<__nv_bfloat16>(a, b, b2, bias, res, c, M, K, N, act, s);
  if (dtype == DT_F64) return run<double>(a, b, b2, bias, res, c, M, K, N, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C (M, N) = epi(A (M, K) @ deq(B) [, A @ deq(B2)]): B, B2 int8, stored (K, N)
// (nk = 0) or (N, K) (nk = 1), with f32 scales (stored rows / qa, stored
// cols / qb).  bgemm's broadcast-B form passes M = batch * M.  b2/b2s, bias
// and res may be NULL.  Returns cudaGetLastError() after the launch.
extern "C" int gemm_q8_launch(int dtype, const void* a, const void* b, const void* bs,
                              const void* b2, const void* b2s, int qa, int qb, int nk,
                              const void* bias, const void* res, void* c, int M, int K, int N,
                              int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = nk ? N : K, cols = nk ? K : N;
  if (qa < 1 || qb < 1 || rows % qa || cols % qb) return static_cast<int>(cudaErrorInvalidValue);
  const float* bsf = static_cast<const float*>(bs);
  const float* b2sf = static_cast<const float*>(b2s);
  if (dtype == DT_F32)
    return run<float, true>(a, b, b2, bsf, b2sf, qa, qb, nk, bias, res, c, M, K, N, act, s);
  if (dtype == DT_BF16)
    return run<__nv_bfloat16, true>(a, b, b2, bsf, b2sf, qa, qb, nk, bias, res, c, M, K, N,
                                     act, s);
  if (dtype == DT_F64)
    return run<double, true>(a, b, b2, bsf, b2sf, qa, qb, nk, bias, res, c, M, K, N, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
