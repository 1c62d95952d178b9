// Dense f64 GEMM with a fused epilogue on the H100's f64 tensor cores
// (DMMA, mma.sync .f64), for Hopper (sm_90a).
//
// Replaces, for the forms `kernels/gemm.py::plan` routes to "dmma", the
// Pallas kernel `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at
// :184) in its dense "kn" form in f64:
//
//     C = epi( A @ B  [, A @ B2] )
//
// with A (M, K), B and B2 (K, N) row-major, bias (N,), residual (M, N) and C
// (M, N), all f64; the products accumulate in f64 and the epilogue
// (common.cuh: bias -> activation -> gate -> residual) runs in f64 from the
// registers.  Every dense f64 call takes it: where K and N are even and
// every operand starts on a 16-byte boundary the ring copies 16 bytes (a
// row pair) at a time, otherwise 8 (one double: any K or N, any base, since
// an f64 operand is always 8-byte aligned).  A packed int8 B takes the
// same tiles, mma shape, k order and epilogue (gemm_f64.cuh) in
// csrc/gemm_f64_q8.cu, dequantized into the B tile this ring copies.
//
// It also replaces `repro/kernels/bgemm.py` (`_bgemm_kernel`, pallas_call at
// :217) in its batched-B form (`bgemm.py:180-182`) in f64 with f64 out
// (`gemm_f64_batched_launch`): C[z] = epi(A[z] @ B[z] [, A[z] @ B2[z]]) for
// z < batch in one launch, grid.z the member, whose A, C and residual start
// z * M * K and z * M * N elements on and whose B and B2 start z * K * N on
// (0 for a B shared by every member); the same tile, ring and copies (the
// BATCHED instantiations, so the 2-D ones keep their code).
//
// Bound: operations.  At 8192^3 the product does 1.1e12 flops on 1.6 GB,
// ~700 flops per byte, far above the card's ridge.  The H100's f64 peak is
// 67 TFLOP/s on the tensor cores and 34 on the CUDA cores (DFMA), so a
// kernel on DFMA (csrc/gemm.cu) cannot pass half the bound.
//
// Design against it:
//  - every product is an `mma.sync.aligned` f64 instruction (f64 in, f64
//    accumulate), one DMMA each.  The shape is a template parameter:
//    Hopper's m16n8k4 / m16n8k8 / m16n8k16 (PTX ISA 7.8, sm_90) and
//    Ampere's m8n8k4.  At 8192^3 on the H100 (scripts/torch_gemm_study.py
//    f64, PERF.md) m16n8k4 took 24.0 ms, m16n8k16 24.3, m16n8k8 24.5 and
//    m8n8k4 40.4 (half the rate), BK = 32 in 3 stages 25.8: the defaults
//    below are the fastest, and the launch takes the others at 128 x 128
//    for that sweep;
//  - a block of 8 warps (2 x 4) owns a BM x BN tile of C (128 x 128, 128 x
//    64 or 64 x 64; the gate's two accumulators take BN <= 64), each warp a
//    (BM/2) x (BN/4) sub-tile of mma tiles in registers;
//  - operand tiles of BK = 16 come through a STAGES-deep cp.async ring in
//    dynamic shared memory, in copies of VEC doubles (16 or 8 bytes, a
//    template parameter the plan picks): the copies of the next three
//    k-steps fly while this one is multiplied, one barrier a k-step;
//  - shared rows are padded by 4 doubles (32 bytes), so each half-warp's
//    8-byte fragment loads (A: row g, column t; B: row t, column g, with
//    g = lane / 4, t = lane % 4) fall on 16 distinct 8-byte bank pairs;
//  - the ragged M, N and K edges are zero-filled through cp.async's
//    src-size operand, in BOTH A and B (0 x garbage is NaN), and the stores
//    skip the fringe;
//  - tiles are visited in groups of 8 tile rows (gemm.cu's grouped raster),
//    so blocks that run together share their A and B panels in L2;
//  - element offsets are 64-bit.
// No split-K: the f64 calls are BLAS calls, large enough to fill the card,
// and each output is summed over all of K in one order (two launches give
// the same bits).
#include "gemm_f64.cuh"

namespace {

// gemm_f64_launch's `variant`: the plan's kernels, or one of the sweep's
enum { PLANNED = 0, M8N8K4 = 1, M16N8K4 = 2, M16N8K8 = 3, M16N8K16 = 4, BK32 = 5 };

template <int BM, int BN, int BK, int STAGES, bool GATE>
constexpr int smem_bytes() {
  return STAGES * (BM * (BK + PAD) + (GATE ? 2 : 1) * BK * (BN + PAD)) * 8;
}

// One C tile; BATCHED: of batch member blockIdx.z (B's member z if
// b_batched, else its only one).
template <int BM, int BN, int BK, int STAGES, int MI, int KI, bool GATE, int VEC,
          bool BATCHED = false>
__global__ void __launch_bounds__(THREADS)
gemm_f64_kernel(const double* __restrict__ a, const double* __restrict__ b,
                const double* __restrict__ b2, const double* __restrict__ bias,
                const double* __restrict__ res, double* __restrict__ c, int M, int K, int N,
                int act, int b_batched) {
  using T = Tile<BM, BN, BK, MI, KI, GATE>;
  constexpr int LDB = T::LDB, A_ELEMS = T::A_ELEMS, B_ELEMS = T::B_ELEMS;
  constexpr int STAGE = A_ELEMS + T::NB * B_ELEMS;
  constexpr int CH_B = BK * BN / VEC / THREADS;  // B copies a thread
  static_assert(CH_B * THREADS * VEC == BK * BN, "copy split");
  extern __shared__ __align__(16) double smem[];

  int m0, n0;
  tile_origin<T>(blockIdx.x, M, N, m0, n0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * T::WM, wn = (warp % WARPS_N) * T::WN;
  if constexpr (BATCHED) {  // member z's operands (64-bit offsets)
    const long long z = blockIdx.z, mk = (long long)M * K, mn = (long long)M * N;
    a += z * mk;
    c += z * mn;
    if (res) res += z * mn;
    if (b_batched) {
      b += z * K * N;
      if constexpr (GATE) b2 += z * K * N;
    }
  }

  // one k-step's tiles into ring slot s: chunks of VEC doubles (with VEC = 2
  // K and N are even, so a chunk is all in or all out of the matrix)
  auto stage = [&](int s, int k0) {
    double* As = smem + s * STAGE;
    double* Bs = As + A_ELEMS;
    copy_a_tile<T, VEC>(As, a, m0, k0, M, K, tid);
#pragma unroll
    for (int j = 0; j < CH_B; ++j) {
      const int e = tid + j * THREADS, r = e / (BN / VEC), ch = e % (BN / VEC);
      const int gk = k0 + r, gn = n0 + VEC * ch;
      const bool live = gk < K && gn < N;
      const long long off = live ? (long long)gk * N + gn : 0;
      cp_async<VEC>(Bs + r * LDB + VEC * ch, b + off, live);
      if constexpr (GATE) cp_async<VEC>(Bs + B_ELEMS + r * LDB + VEC * ch, b2 + off, live);
    }
  };

  typename T::Acc acc;
  typename T::Acc2 acc2;
  zero<T>(acc, acc2);

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this k-step's copies have landed ...
    __syncthreads();              // ... for every thread, and slot kt-1 is free
    const int next = kt + STAGES - 1;
    if (next < KT) stage(next % STAGES, next * BK);
    cp_async_commit();
    const double* As = smem + (kt % STAGES) * STAGE;
    multiply_stage<T>(As, As + A_ELEMS, acc, acc2, wm, wn, g, t);
  }
  cp_async_wait<0>();  // only empty groups remain; drained before exit
  store_tile<T, VEC>(acc, acc2, bias, res, c, m0 + wm + g, n0 + wn + 2 * t, M, N, act);
}

template <int BM, int BN, int BK, int STAGES, int MI, int KI, bool GATE, int VEC, bool BATCHED>
int launch(const double* a, const double* b, const double* b2, const double* bias,
           const double* res, double* c, int M, int K, int N, int act, cudaStream_t s, int batch,
           int b_batched) {
  constexpr int bytes = smem_bytes<BM, BN, BK, STAGES, GATE>();
  auto kernel = gemm_f64_kernel<BM, BN, BK, STAGES, MI, KI, GATE, VEC, BATCHED>;
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const dim3 grid((unsigned)tiles, 1, (unsigned)batch);
  kernel<<<grid, THREADS, bytes, s>>>(a, b, b2, bias, res, c, M, K, N, act, b_batched);
  return static_cast<int>(cudaGetLastError());
}

// the 2-D launch
template <int BM, int BN, bool GATE, int VEC = 2, int MI = DEFAULT_MI, int KI = DEFAULT_KI,
          int BK = DEFAULT_BK, int STAGES = DEFAULT_STAGES>
int run(const double* a, const double* b, const double* b2, const double* bias,
        const double* res, double* c, int M, int K, int N, int act, cudaStream_t s) {
  return launch<BM, BN, BK, STAGES, MI, KI, GATE, VEC, false>(a, b, b2, bias, res, c, M, K, N,
                                                              act, s, 1, 0);
}

// the batched launch (grid.z the member), with the plan's mma shape and ring
template <int BM, int BN, bool GATE, int VEC>
int run_batched(const double* a, const double* b, const double* b2, const double* bias,
                const double* res, double* c, int M, int K, int N, int act, cudaStream_t s,
                int batch, int b_batched) {
  return launch<BM, BN, DEFAULT_BK, DEFAULT_STAGES, DEFAULT_MI, DEFAULT_KI, GATE, VEC, true>(
      a, b, b2, bias, res, c, M, K, N, act, s, batch, b_batched);
}

}  // namespace

// C (M, N) = epi(A (M, K) @ B [, A @ B2]) in f64.  b2, bias and res may be
// NULL.  (bm, bn): 128 x 128 or 64 x 64 (the gate: 128 x 64 or 64 x 64).
// variant: 0 for the plan's kernels; for the sweep, at 128 x 128 without
// the gate, 1-4 the mma shapes m8n8k4, m16n8k4, m16n8k8, m16n8k16 (BK = 16,
// 4 stages) and 5 the default shape with BK = 32 and 3 stages.  copy: the
// bytes a cp.async moves, 16 (K and N even, a, b, b2 and c 16-byte aligned)
// or 8 (any K and N; the sweep's variants take 16 only).  Returns
// cudaErrorInvalidValue for what the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int gemm_f64_launch(const void* a, const void* b, const void* b2, const void* bias,
                               const void* res, void* c, int M, int K, int N, int act, int bm,
                               int bn, int variant, int copy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* at = static_cast<const double*>(a);
  const double* bt = static_cast<const double*>(b);
  const double* b2t = static_cast<const double*>(b2);
  const double* biast = static_cast<const double*>(bias);
  const double* rest = static_cast<const double*>(res);
  double* ct = static_cast<double*>(c);
  const bool aligned = aligned16(at) && aligned16(bt) && aligned16(b2t) && aligned16(ct);
  auto at8 = [](const double* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  const bool whole8 = at8(at) && at8(bt) && at8(b2t) && at8(biast) && at8(rest) && at8(ct);
  if (M < 1 || K < 1 || N < 1 || !whole8 || (copy != 16 && copy != 8) ||
      (copy == 16 && (K % 2 || N % 2 || !aligned)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = bm * 1000 + bn;
#define F64_ARGS at, bt, b2t, biast, rest, ct, M, K, N, act, s
  if (variant != PLANNED) {
    if (b2 || tile != 128128 || copy != 16) return static_cast<int>(cudaErrorInvalidValue);
    switch (variant) {
      case M8N8K4: return run<128, 128, false, 2, 8, 4, 16, 4>(F64_ARGS);
      case M16N8K4: return run<128, 128, false, 2, 16, 4, 16, 4>(F64_ARGS);
      case M16N8K8: return run<128, 128, false, 2, 16, 8, 16, 4>(F64_ARGS);
      case M16N8K16: return run<128, 128, false, 2, 16, 16, 16, 4>(F64_ARGS);
      case BK32: return run<128, 128, false, 2, DEFAULT_MI, DEFAULT_KI, 32, 3>(F64_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const bool wide = copy == 16;
  if (b2) {
    if (tile == 128064)
      return wide ? run<128, 64, true, 2>(F64_ARGS) : run<128, 64, true, 1>(F64_ARGS);
    if (tile == 64064)
      return wide ? run<64, 64, true, 2>(F64_ARGS) : run<64, 64, true, 1>(F64_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 128128)
    return wide ? run<128, 128, false, 2>(F64_ARGS) : run<128, 128, false, 1>(F64_ARGS);
  if (tile == 64064)
    return wide ? run<64, 64, false, 2>(F64_ARGS) : run<64, 64, false, 1>(F64_ARGS);
#undef F64_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// C[z] (M, N) = epi(A[z] (M, K) @ B[z] [, A[z] @ B2[z]]) in f64 for z < batch
// in one launch: A (batch, M, K), C and res (batch, M, N) contiguous; B and
// B2 (batch, K, N) if b_batched, else one (K, N) shared by every member.
// b2, bias and res may be NULL.  (bm, bn) and copy as gemm_f64_launch's
// plan (variant 0).  Returns cudaErrorInvalidValue for what the kernel does
// not take, else cudaGetLastError() after the launch.
extern "C" int gemm_f64_batched_launch(const void* a, const void* b, const void* b2,
                                       const void* bias, const void* res, void* c, int batch,
                                       int b_batched, int M, int K, int N, int act, int bm,
                                       int bn, int copy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* at = static_cast<const double*>(a);
  const double* bt = static_cast<const double*>(b);
  const double* b2t = static_cast<const double*>(b2);
  const double* biast = static_cast<const double*>(bias);
  const double* rest = static_cast<const double*>(res);
  double* ct = static_cast<double*>(c);
  const bool aligned = aligned16(at) && aligned16(bt) && aligned16(b2t) && aligned16(ct);
  auto at8 = [](const double* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  const bool whole8 = at8(at) && at8(bt) && at8(b2t) && at8(biast) && at8(rest) && at8(ct);
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || !whole8 ||
      (copy != 16 && copy != 8) || (copy == 16 && (K % 2 || N % 2 || !aligned)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = bm * 1000 + bn;
  const int bb = b_batched ? 1 : 0;
#define F64_ARGS at, bt, b2t, biast, rest, ct, M, K, N, act, s, batch, bb
  const bool wide = copy == 16;
  if (b2) {
    if (tile == 128064)
      return wide ? run_batched<128, 64, true, 2>(F64_ARGS)
                  : run_batched<128, 64, true, 1>(F64_ARGS);
    if (tile == 64064)
      return wide ? run_batched<64, 64, true, 2>(F64_ARGS) : run_batched<64, 64, true, 1>(F64_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 128128)
    return wide ? run_batched<128, 128, false, 2>(F64_ARGS)
                : run_batched<128, 128, false, 1>(F64_ARGS);
  if (tile == 64064)
    return wide ? run_batched<64, 64, false, 2>(F64_ARGS) : run_batched<64, 64, false, 1>(F64_ARGS);
#undef F64_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
