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
//  - `gemm_q8_launch`: the packed bodies of both (`gemm.py:63-76`,
//    `bgemm.py:80-90`): B (and B2) block-scaled int8 with f32 scales
//    (core/quant.py), in the "kn" layout (stored (K, N), scale blocks
//    (qa, qb) over it) or the output-major "nk" layout (stored (N, K), blocks
//    (qa, qb) over that), the decode weights of `serve --quantize int8`.  B
//    is dequantized in the accumulator type, deq = value * scale, as
//    `dequant_tile(..., dtype=acc)` does: never rounded to A's dtype.
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
//  - int8 B is staged in registers as int8 (its storage type, as A and the
//    dense B are) beside its elements' scales, and dequantized on the way
//    into the float shared-memory tile.  "nk" is read along K (each thread
//    a few contiguous bytes of one stored row) and written transposed into
//    Bs[k][n], so the multiply loop is the dense one.  A scale index costs a
//    division only along an axis with more than one scale block.
// Later work (not here): wgmma for bf16 and f32 (TF32 changes the result,
// so f32 stays on FFMA), DMMA (mma.sync m8n8k4 f64) for f64, TMA loads.
#include <stdint.h>

#include <type_traits>

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

// Q: B and B2 are int8 with f32 block scales bs/b2s (blocks (qa, qb) over
// the stored layout, "nk" if nk); else B and B2 are T and bs, b2s unused.
template <typename T, bool GATE, bool Q>
__device__ __forceinline__ void gemm_tile(
    const T* __restrict__ a, const std::conditional_t<Q, int8_t, T>* __restrict__ b,
    const std::conditional_t<Q, int8_t, T>* __restrict__ b2, const float* __restrict__ bs,
    const float* __restrict__ b2s, int qa, int qb, bool nk, const T* __restrict__ bias,
    const T* __restrict__ res, T* __restrict__ c, int M, int K, int N, int act) {
  using A = typename Acc<T>::type;
  using TB = std::conditional_t<Q, int8_t, T>;
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
  // staging coordinates: A row ra, k columns ka..ka+LA-1; B element e at
  // (kb + e * dk, nb + e * dn): LB columns of row kb ("kn"), or LB k's of
  // stored row nb ("nk", read along K and written transposed)
  const int ra = tid * LA / BK, ka = tid * LA % BK;
  const bool along_k = Q && nk;
  const int kb = along_k ? tid % (BK / LB) * LB : tid * LB / BN;
  const int nb = along_k ? tid / (BK / LB) : tid * LB % BN;
  const int dk = along_k ? 1 : 0, dn = along_k ? 0 : 1;
  // scale grid: rows of blocks over the stored layout, and its width.  A
  // thread's n is fixed for the whole sweep: "nk" finds its scale row once,
  // "kn" its scale columns once; only the k side changes with the step.
  const int s_cols = Q ? (nk ? K / qb : N / qb) : 1;
  const int n_blk = Q && nk ? min(n0 + nb, N - 1) / qa : 0;  // "nk": stored row block
  int c_blk[Q ? LB : 1];                                      // "kn": column blocks
#pragma unroll
  for (int e = 0; e < (Q ? LB : 1); ++e)
    c_blk[e] = Q && !nk && s_cols > 1 ? min(n0 + nb + e, N - 1) / qb : 0;
  // one scale block across the stored row (the serving spec): "nk" has one
  // scale for the thread's whole sweep, "kn" one a step for all LB elements
  const bool one_col = s_cols == 1;
  float s_nk = 0.f, s2_nk = 0.f;
  if constexpr (Q) {
    if (nk && one_col) {
      s_nk = bs[n_blk];
      if constexpr (GATE) s2_nk = b2s[n_blk];
    }
  }

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
  T sa[LA];
  TB sb[LB], sb2[GATE ? LB : 1];
  float ss[Q ? LB : 1], ss2[Q && GATE ? LB : 1];  // the staged B elements' scales
  auto load = [&](int k0) {  // global -> registers, zero outside the matrices
    const int gm = m0 + ra;
#pragma unroll
    for (int e = 0; e < LA; ++e) {
      const int gk = k0 + ka + e;
      sa[e] = (gm < M && gk < K) ? a[(long)gm * K + gk] : zero;
    }
    // "kn": the LB elements share row k0 + kb, so one division a step
    const int k_blk = Q && !nk ? min(k0 + kb, K - 1) / qa : 0;
    float s_one = s_nk, s2_one = s2_nk;
    if constexpr (Q) {
      if (!nk && one_col) {
        s_one = bs[k_blk];
        if constexpr (GATE) s2_one = b2s[k_blk];
      }
    }
#pragma unroll
    for (int e = 0; e < LB; ++e) {
      const int gk = k0 + kb + e * dk, gn = n0 + nb + e * dn;
      const bool ok = gk < K && gn < N;
      if constexpr (Q) {
        // stored (row, col): (gk, gn) for "kn", (gn, gk) for "nk"
        const long o = nk ? (long)gn * K + gk : (long)gk * N + gn;
        const long si = nk ? (long)n_blk * s_cols + gk / qb : (long)k_blk * s_cols + c_blk[e];
        sb[e] = ok ? b[o] : int8_t(0);
        ss[e] = !ok ? 0.f : one_col ? s_one : bs[si];
        if constexpr (GATE) {
          sb2[e] = ok ? b2[o] : int8_t(0);
          ss2[e] = !ok ? 0.f : one_col ? s2_one : b2s[si];
        }
      } else {
        sb[e] = ok ? b[(long)gk * N + gn] : zero;
        if constexpr (GATE) sb2[e] = ok ? b2[(long)gk * N + gn] : zero;
      }
    }
  };
  auto stash = [&](int buf) {  // registers -> shared memory (A transposed)
#pragma unroll
    for (int e = 0; e < LA; ++e) As[buf][ka + e][ra] = to_f(sa[e]);
#pragma unroll
    for (int e = 0; e < LB; ++e) {
      const int kk = kb + e * dk, nn = nb + e * dn;
      if constexpr (Q) {
        Bs[buf][kk][nn] = static_cast<A>(sb[e]) * static_cast<A>(ss[e]);
        if constexpr (GATE) Bs2[buf][kk][nn] = static_cast<A>(sb2[e]) * static_cast<A>(ss2[e]);
      } else {
        Bs[buf][kk][nn] = to_f(sb[e]);
        if constexpr (GATE) Bs2[buf][kk][nn] = to_f(sb2[e]);
      }
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

template <typename T, bool GATE, bool Q>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const std::conditional_t<Q, int8_t, T>* __restrict__ b,
            const std::conditional_t<Q, int8_t, T>* __restrict__ b2,
            const float* __restrict__ bs, const float* __restrict__ b2s, int qa, int qb,
            bool nk, const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ c,
            int M, int K, int N, int act) {
  gemm_tile<T, GATE, Q>(a, b, b2, bs, b2s, qa, qb, nk, bias, res, c, M, K, N, act);
}

// The int8-B variant of f32/bf16 is held to two blocks an SM (128 registers,
// as the dense one compiles to; unbounded it takes more and runs one).  The
// bound stays off the dense kernel: stating even one block an SM there made
// it 30-40% slower at the prefill shapes (PERF.md).
template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS, 2)
gemm_q8_kernel(const T* __restrict__ a, const int8_t* __restrict__ b,
               const int8_t* __restrict__ b2, const float* __restrict__ bs,
               const float* __restrict__ b2s, int qa, int qb, bool nk,
               const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ c,
               int M, int K, int N, int act) {
  gemm_tile<T, GATE, true>(a, b, b2, bs, b2s, qa, qb, nk, bias, res, c, M, K, N, act);
}

template <typename T, bool Q>
int run(const void* a, const void* b, const void* b2, const float* bs, const float* b2s,
        int qa, int qb, bool nk, const void* bias, const void* res, void* c, int M, int K,
        int N, int act, cudaStream_t s) {
  using TB = std::conditional_t<Q, int8_t, T>;
  const T* at = static_cast<const T*>(a);
  const TB* bt = static_cast<const TB*>(b);
  const TB* b2t = static_cast<const TB*>(b2);
  const T* biast = static_cast<const T*>(bias);
  const T* rest = static_cast<const T*>(res);
  T* ct = static_cast<T*>(c);
  const long tiles_m = (M + BM - 1) / BM;
  constexpr bool bounded = Q && sizeof(T) < 8;
  if (b2) {
    const unsigned tiles = (unsigned)(tiles_m * ((N + 63) / 64));
    if constexpr (bounded)
      gemm_q8_kernel<T, true><<<tiles, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk, biast,
                                                        rest, ct, M, K, N, act);
    else
      gemm_kernel<T, true, Q><<<tiles, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk, biast,
                                                        rest, ct, M, K, N, act);
  } else {
    const unsigned tiles = (unsigned)(tiles_m * ((N + 127) / 128));
    if constexpr (bounded)
      gemm_q8_kernel<T, false><<<tiles, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk, biast,
                                                         rest, ct, M, K, N, act);
    else
      gemm_kernel<T, false, Q><<<tiles, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk, biast,
                                                         rest, ct, M, K, N, act);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* a, const void* b, const void* b2, const void* bias, const void* res,
        void* c, int M, int K, int N, int act, cudaStream_t s) {
  return run<T, false>(a, b, b2, nullptr, nullptr, 1, 1, false, bias, res, c, M, K, N, act, s);
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
