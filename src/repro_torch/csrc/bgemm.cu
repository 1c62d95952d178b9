// Broadcast-weight batched GEMM with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/bgemm.py` (`_bgemm_kernel`, the
// broadcast-B "kn" form the prefill path uses):
//
//     C[b] = epi( A[b] @ B  [, A[b] @ B2] )
//
// with A (batch, M, K), B and B2 (K, N) row-major, bias (N,) and residual
// (batch, M, N).
//
// Bound: operations.  An admission prefill of 4 x 128 tokens does 2 x 512
// FLOPs per bf16 weight (512 per byte), above the ~295 FLOP/byte ridge of the card,
// so the bound is the tensor-core rate.  This first kernel does not reach
// it: it runs on the CUDA cores in f32 FMA (67 TFLOP/s peak), which puts a
// factor of ~15 between it and the bound.
//
// Design: the classic shared-memory tiled GEMM.  A block owns a 64 x 64
// output tile of one batch member and sweeps K in steps of 16; each of its
// 256 threads keeps a 4 x 4 micro-tile (and a second one for the gate) in
// registers, so every value staged in shared memory feeds 4 FMAs per load.
// The ragged K fringe is zeroed on BOTH operands (bgemm.py:69-76: one-sided
// masking would still contract 0 * garbage); the M/N fringes are masked on
// the load and skipped on the store.  The epilogue runs on the f32
// accumulators and the output is written once.
// Later work (not here): wgmma with TMA-fed shared-memory rings.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS)
bgemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const T* __restrict__ b2, const T* __restrict__ bias,
             const T* __restrict__ res, T* __restrict__ c, int M, int K, int N,
             int act) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float Bs2[GATE ? BK : 1][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long batch = blockIdx.z;
  const T* ab = a + batch * M * K;

  float acc[TM][TN], acc2[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = acc2[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK, kk = e % BK;
      const int gm = m0 + row, gk = k0 + kk;
      As[kk][row] = (gm < M && gk < K) ? to_f(ab[(long)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gn = n0 + cc;
      const bool ok = gk < K && gn < N;
      const long off = (long)gk * N + gn;
      Bs[kk][cc] = ok ? to_f(b[off]) : 0.f;
      if constexpr (GATE) Bs2[kk][cc] = ok ? to_f(b2[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN], bv2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bv[j] = Bs[kk][tx * TN + j];
        if constexpr (GATE) bv2[j] = Bs2[kk][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          if constexpr (GATE) acc2[i][j] = fmaf(av[i], bv2[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const long o = (batch * M + gm) * N + gn;
      c[o] = from_f<T>(epilogue<T>(acc[i][j], acc2[i][j], bias, res, gn, o, act, GATE));
    }
  }
}

template <typename T>
void run(const void* a, const void* b, const void* b2, const void* bias,
         const void* res, void* c, int batch, int M, int K, int N, int act,
         cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const T* b2t = static_cast<const T*>(b2);
  const T* biast = static_cast<const T*>(bias);
  const T* rest = static_cast<const T*>(res);
  T* ct = static_cast<T*>(c);
  if (b2)
    bgemm_kernel<T, true><<<grid, THREADS, 0, stream>>>(at, bt, b2t, biast, rest, ct, M, K, N, act);
  else
    bgemm_kernel<T, false><<<grid, THREADS, 0, stream>>>(at, bt, b2t, biast, rest, ct, M, K, N, act);
}

}  // namespace

// b2, bias and res may be NULL.  Returns cudaGetLastError() after the launch.
extern "C" int bgemm_launch(int dtype, const void* a, const void* b,
                            const void* b2, const void* bias, const void* res,
                            void* c, int batch, int M, int K, int N, int act,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) run<float>(a, b, b2, bias, res, c, batch, M, K, N, act, s);
  else if (dtype == DT_BF16) run<__nv_bfloat16>(a, b, b2, bias, res, c, batch, M, K, N, act, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
