// Dense GEMM with a fused epilogue for Hopper (sm_90a), f32, bf16 and f64.
//
// Replaces two Pallas kernels with one body and two entry points:
//  - `gemm_launch`: `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at
//    :184) in its dense "kn" form, C = epi( A @ B  [, A @ B2] ), with A
//    (M, K), B and B2 (K, N) row-major, bias (N,), residual (M, N) and C
//    (M, N) in A's dtype; the sums and the epilogue run in max(f32, dtype).
//  - `bgemm_launch`: `repro/kernels/bgemm.py` (`_bgemm_kernel`, pallas_call
//    at :217) in the broadcast-B "kn" form the prefill path uses, C[b] =
//    epi( A[b] @ B  [, A[b] @ B2] ) with A (batch, M, K) contiguous: that is
//    the same GEMM over the batch * M rows of A, residual and C, so it runs
//    this kernel with M' = batch * M (f32 and bf16 only, as the serving path).
//
// Bound: operations.  At 8192^3 the product does 1.1e12 flops on 1.6 GB (f64),
// ~700 flops per byte, far above the ridge of the card.  This kernel runs on
// the CUDA cores (FFMA, and DFMA for f64), not the tensor cores, so bf16 and
// f64 sit far above their tensor-core bounds; see PERF.md.
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
// Later work (not here): wgmma for bf16 and f32 (TF32 changes the result,
// so f32 stays on FFMA), DMMA (mma.sync m8n8k4 f64) for f64, TMA loads.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int BM = 128, BK = 8, THREADS = 256, GROUP = 8, PAD = 4;

// four consecutive accumulator values from shared memory, 16-byte loads
__device__ __forceinline__ void lds4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void lds4(const double* p, double* f) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  f[0] = v0.x; f[1] = v0.y; f[2] = v1.x; f[3] = v1.y;
}

template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ b2,
            const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ c,
            int M, int K, int N, int act) {
  using A = typename Acc<T>::type;
  constexpr int NB = GATE ? 1 : 2;
  constexpr int BN = 64 * NB;
  constexpr int LA = BM * BK / THREADS;  // A elements a thread stages: 4
  constexpr int LB = BK * BN / THREADS;  // B elements: 4 (2 under the gate)
  __shared__ __align__(16) A As[2][BK][BM + PAD];
  __shared__ __align__(16) A Bs[2][BK][BN + PAD];
  __shared__ __align__(16) A Bs2[GATE ? 2 : 1][GATE ? BK : 1][BN + PAD];

  // grouped raster: GROUP tile rows sweep the tile columns together
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first = group * GROUP;
  const int rows_here = min(tiles_m - first, GROUP);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows_here) * BM;
  const int n0 = (in_group / rows_here) * BN;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // staging coordinates: A row ra, k columns ka..ka+LA-1; B row kb, columns nb..
  const int ra = tid * LA / BK, ka = tid * LA % BK;
  const int kb = tid * LB / BN, nb = tid * LB % BN;

  A acc[8][4 * NB], acc2[GATE ? 8 : 1][GATE ? 4 * NB : 1];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) {
      acc[i][j] = 0;
      if constexpr (GATE) acc2[i][j] = 0;
    }

  // Staged in the storage type and converted only in stash(): a conversion
  // next to its load would wait for the load there, before the multiply.
  const T zero = from_f<T>(A(0));
  T sa[LA], sb[LB], sb2[GATE ? LB : 1];
  auto load = [&](int k0) {  // global -> registers, zero outside the matrices
    const int gm = m0 + ra;
#pragma unroll
    for (int e = 0; e < LA; ++e) {
      const int gk = k0 + ka + e;
      sa[e] = (gm < M && gk < K) ? a[(long)gm * K + gk] : zero;
    }
    const int gk = k0 + kb;
#pragma unroll
    for (int e = 0; e < LB; ++e) {
      const int gn = n0 + nb + e;
      const bool ok = gk < K && gn < N;
      sb[e] = ok ? b[(long)gk * N + gn] : zero;
      if constexpr (GATE) sb2[e] = ok ? b2[(long)gk * N + gn] : zero;
    }
  };
  auto stash = [&](int buf) {  // registers -> shared memory (A transposed)
#pragma unroll
    for (int e = 0; e < LA; ++e) As[buf][ka + e][ra] = to_f(sa[e]);
#pragma unroll
    for (int e = 0; e < LB; ++e) {
      Bs[buf][kb][nb + e] = to_f(sb[e]);
      if constexpr (GATE) Bs2[buf][kb][nb + e] = to_f(sb2[e]);
    }
  };

  load(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);  // in flight while this step multiplies
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      A av[8], bv[4 * NB], bv2[GATE ? 4 : 1];
      lds4(&As[buf][kk][ty * 4], av);
      lds4(&As[buf][kk][64 + ty * 4], av + 4);
#pragma unroll
      for (int j = 0; j < NB; ++j) lds4(&Bs[buf][kk][64 * j + tx * 4], bv + 4 * j);
      if constexpr (GATE) lds4(&Bs2[buf][kk][tx * 4], bv2);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NB; ++j) {
          acc[i][j] += av[i] * bv[j];
          if constexpr (GATE) acc2[i][j] += av[i] * bv2[j];
        }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) {
      const int gn = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (gn >= N) continue;
      const long o = (long)gm * N + gn;
      A g = 0;
      if constexpr (GATE) g = acc2[i][j];
      c[o] = from_f<T>(epilogue<T>(acc[i][j], g, bias, res, gn, o, act, GATE));
    }
  }
}

template <typename T>
int run(const void* a, const void* b, const void* b2, const void* bias, const void* res,
        void* c, int M, int K, int N, int act, cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const T* b2t = static_cast<const T*>(b2);
  const T* biast = static_cast<const T*>(bias);
  const T* rest = static_cast<const T*>(res);
  T* ct = static_cast<T*>(c);
  const long tiles_m = (M + BM - 1) / BM;
  if (b2) {
    const long tiles = tiles_m * ((N + 63) / 64);
    gemm_kernel<T, true><<<(unsigned)tiles, THREADS, 0, s>>>(at, bt, b2t, biast, rest, ct,
                                                             M, K, N, act);
  } else {
    const long tiles = tiles_m * ((N + 127) / 128);
    gemm_kernel<T, false><<<(unsigned)tiles, THREADS, 0, s>>>(at, bt, b2t, biast, rest, ct,
                                                              M, K, N, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b2, bias and res may be NULL.  Each returns cudaGetLastError() after the launch.
extern "C" int gemm_launch(int dtype, const void* a, const void* b, const void* b2,
                           const void* bias, const void* res, void* c, int M, int K, int N,
                           int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return run<float>(a, b, b2, bias, res, c, M, K, N, act, s);
  if (dtype == DT_BF16) return run<__nv_bfloat16>(a, b, b2, bias, res, c, M, K, N, act, s);
  if (dtype == DT_F64) return run<double>(a, b, b2, bias, res, c, M, K, N, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bgemm_launch(int dtype, const void* a, const void* b, const void* b2,
                            const void* bias, const void* res, void* c, int batch, int M,
                            int K, int N, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return run<float>(a, b, b2, bias, res, c, batch * M, K, N, act, s);
  if (dtype == DT_BF16)
    return run<__nv_bfloat16>(a, b, b2, bias, res, c, batch * M, K, N, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
