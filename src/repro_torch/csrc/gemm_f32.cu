// Dense f32 GEMM with a fused epilogue on the H100's CUDA cores (FFMA), fed
// by TMA, for Hopper (sm_90a).
//
// Replaces, for the forms `kernels/gemm.py::plan` routes to "ffma_sm90",
// the Pallas kernel `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at
// :184) in its dense "kn" form in f32, and `repro/kernels/bgemm.py`
// (`_bgemm_kernel`, pallas_call at :217) in its f32 broadcast-B form (the
// same GEMM over the batch * M rows of A):
//
//     C = epi( A @ B  [, A @ B2] )
//
// with A (M, K), B and B2 (K, N) row-major, bias (N,), residual (M, N) and C
// (M, N), all f32; the products are FFMA in f32 (TF32 would round
// differently from the plain version) and the epilogue (common.cuh: bias ->
// activation -> gate -> residual) runs in f32 from the registers.  TMA
// needs 16-byte row strides and bases: where K or N is not a multiple of 4
// or an operand starts off 16 bytes, `kernels/gemm.py` first copies A, B
// and B2 (each only if TMA cannot address it) into rows padded to 4 floats
// (`Plan.stage`, `gemm.tma_rows`; TMA loads the padding past K or N as
// zeros), and C, whose rows are then not whole 16-byte groups, takes the
// ODD instantiations' element stores (csrc/gemm_f32_odd.cu).  int8 B under
// f32 A takes the same ring with the int8 dequantized in its staging
// (csrc/gemm_f32_q8.cu).  The kernel and its launch are in gemm_f32.cuh.
//
// It also replaces `_bgemm_kernel` in its batched-B form (`bgemm.py:180-182`)
// in f32 with f32 out (`gemm_f32_batched_launch`): C[z] = epi(A[z] @ B[z]
// [, A[z] @ B2[z]]) for z < batch in one launch, grid.z the member, A and B
// read through rank-3 TMA maps with the batch outermost, so that a tile past
// member z's last row or column loads zeros rather than member z + 1's
// elements, and a B shared by every member is a stack of one read at z = 0
// (the BATCHED instantiations, so the 2-D ones keep their code).
//
// Bound: operations.  At 8192^3 the product does 1.1e12 flops on 0.8 GB,
// ~1400 flops per byte; the CUDA cores' f32 FMA peak is 67 TFLOP/s
// (16.4 ms).  The first design (csrc/gemm.cu) stages its loads through
// registers one 4-byte element at a time, transposes A into shared memory
// and keeps two buffers: 56% of that bound.
//
// Design against it:
//  - operand tiles of BK = 32 k come by TMA into a ring of STAGES stages in
//    dynamic shared memory, each guarded by a full and an empty mbarrier; one
//    producer warp keeps the ring full, every other warp computes.  TMA
//    zero-fills rows and columns outside the matrix, so ragged M, N and K
//    need no masks in the main loop (A and B are both zero there);
//  - A keeps its stored layout (BM rows of 32 k, 128-byte rows in TMA's
//    128-byte swizzle): a thread reads A[m][k..k+3] as one 16-byte load, 4
//    k-steps of one row, and the 4 rows a warp reads at once sit in 4
//    distinct bank groups.  B (32 k-rows of BN columns) is read 16 bytes
//    along n, 8 lanes over 128 contiguous bytes;
//  - a thread owns TM x TN outputs: rows wm + ty + 4i (i < TM), columns wn +
//    4tx + 32j + e (a warp is 4 x 8 threads over (4 TM) x (8 TN) outputs);
//    each 16-byte A load feeds 4 TN FFMAs and each B load 4 TM; the next
//    group of 4 k-steps' A values and the next k-step's B values are loaded
//    while these multiply, and a stage's 32 k-steps are unrolled;
//  - tiles: 128 x 128 (8 x 8 a thread), 128 x 64 (8 x 4) and 64 x 64 (4 x
//    4) without the gate, 128 x 64 and 64 x 64 with it (both accumulators a
//    thread); `kernels/gemm.py::FFMA_SM90_TILES` picks by shape;
//  - tiles are visited in groups of 8 tile rows (grouped raster), so blocks
//    that run together share their A and B panels in L2;
//  - the epilogue writes each 4 columns as one 16-byte store where N % 4
//    == 0 and C starts on 16 bytes, else one element a store (the ODD
//    instantiations: with a branch on N the 128 x 128 tile spills); a plain
//    product (no bias, residual, activation or gate) takes a short path of
//    stores alone (the general path's code, fetched once a block, weighs on
//    short-K products such as the LoRA merge's K = 128).
// PERF.md lists the alternatives measured against this design and dropped
// (3 stages, cp.async copies, the k-steps as a loop, a persistent grid; for
// the rows TMA cannot address, 4- and 8-byte cp.async copies into the same
// stage layout, issued by a feed warpgroup or by the consumers: slower than
// the padded copies and TMA at the BLAS odd and the ragged bgemm shapes).
// No split-K: each output is summed over all of K in one order, so two
// launches give the same bits.
#include "gemm_f32.cuh"

namespace {

// what every launch checks: A's rows lda floats apart, B's and B2's ldb
// (multiples of 4, at least K and N), every operand on 16 bytes but C
bool ring_takes(const void* a, const void* b, const void* b2, int M, int K, int N, int lda,
                int ldb) {
  return M >= 1 && K >= 1 && N >= 1 && lda >= K && ldb >= N && lda % 4 == 0 && ldb % 4 == 0 &&
         aligned_to(a, 16) && aligned_to(b, 16) && aligned_to(b2, 16);
}

}  // namespace

// C (M, N) = epi(A (M, K) @ B [, A @ B2]) in f32 on the CUDA cores.  b2,
// bias and res may be NULL.  (bm, bn): 128 x 128, 128 x 64 or 64 x 64 (the
// gate: 128 x 64 or 64 x 64).  A's rows are lda floats apart, B's and B2's
// ldb: multiples of 4 (a staged operand's padded rows); a, b and b2 on 16
// bytes.  N % 4 != 0 or C off 16 bytes takes the ODD instantiations
// (gemm_f32_odd.cu).  Returns cudaErrorInvalidValue for what the kernel does
// not take, 1000 + a CUresult if a TMA descriptor is refused, else
// cudaGetLastError() after the launch.
extern "C" int gemm_f32_launch(const void* a, const void* b, const void* b2, const void* bias,
                               const void* res, void* c, int M, int K, int N, int lda, int ldb,
                               int act, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
  const float* b2t = static_cast<const float*>(b2);
  const float* biast = static_cast<const float*>(bias);
  const float* rest = static_cast<const float*>(res);
  float* ct = static_cast<float*>(c);
  if (!ring_takes(a, b, b2, M, K, N, lda, ldb)) return static_cast<int>(cudaErrorInvalidValue);
  if (N % 4 || !aligned_to(c, 16))
    return f32_ring_odd(at, bt, b2t, biast, rest, ct, M, K, N, lda, ldb, act, bm, bn, s, 0, 0);
  const int tile = bm * 1000 + bn;
#define F32_ARGS at, bt, b2t, biast, rest, ct, M, K, N, lda, ldb, act, s
  if (b2) {
    if (tile == 128064) return run<Cfg<128, 64, 8, 4, true>>(F32_ARGS);
    if (tile == 64064) return run<Cfg<64, 64, 4, 4, true>>(F32_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 128128) return run<Cfg<128, 128, 8, 8, false>>(F32_ARGS);
  if (tile == 128064) return run<Cfg<128, 64, 8, 4, false>>(F32_ARGS);
  if (tile == 64064) return run<Cfg<64, 64, 4, 4, false>>(F32_ARGS);
#undef F32_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// C[z] (M, N) = epi(A[z] (M, K) @ B[z] [, A[z] @ B2[z]]) in f32 for z < batch
// in one launch: A (batch, M, K) (rows lda apart), C and res (batch, M, N)
// contiguous; B and B2 (batch, K, N) (rows ldb apart) if b_batched, else one
// (K, N) shared by every member.  b2, bias and res may be NULL.  (bm, bn) as
// gemm_f32_launch's, or 32 x 64 (4 warps of 16 x 32: the MoE experts' 32
// rows a member, with or without the gate); the rows and alignments as
// gemm_f32_launch's.  Returns as gemm_f32_launch.
extern "C" int gemm_f32_batched_launch(const void* a, const void* b, const void* b2,
                                       const void* bias, const void* res, void* c, int batch,
                                       int b_batched, int M, int K, int N, int lda, int ldb,
                                       int act, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
  const float* b2t = static_cast<const float*>(b2);
  const float* biast = static_cast<const float*>(bias);
  const float* rest = static_cast<const float*>(res);
  float* ct = static_cast<float*>(c);
  if (batch < 1 || batch > 65535 || !ring_takes(a, b, b2, M, K, N, lda, ldb))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bb = b_batched ? 1 : 0;
  if (N % 4 || !aligned_to(c, 16))
    return f32_ring_odd(at, bt, b2t, biast, rest, ct, M, K, N, lda, ldb, act, bm, bn, s, batch,
                        bb);
  const int tile = bm * 1000 + bn;
#define F32_ARGS at, bt, b2t, biast, rest, ct, M, K, N, lda, ldb, act, s, batch, bb
  if (b2) {
    if (tile == 128064) return run<Cfg<128, 64, 8, 4, true>, true>(F32_ARGS);
    if (tile == 64064) return run<Cfg<64, 64, 4, 4, true>, true>(F32_ARGS);
    if (tile == 32064) return run<Cfg<32, 64, 4, 4, true>, true>(F32_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 128128) return run<Cfg<128, 128, 8, 8, false>, true>(F32_ARGS);
  if (tile == 128064) return run<Cfg<128, 64, 8, 4, false>, true>(F32_ARGS);
  if (tile == 64064) return run<Cfg<64, 64, 4, 4, false>, true>(F32_ARGS);
  if (tile == 32064) return run<Cfg<32, 64, 4, 4, false>, true>(F32_ARGS);
#undef F32_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
