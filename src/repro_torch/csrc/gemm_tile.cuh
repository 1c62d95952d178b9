// The CUDA-core GEMM tile (the paper's DOT4 processing element on an SM),
// shared by the 2-D entry points of gemm.cu and the batched one of
// gemm_batched.cu: see gemm.cu for the design.  `run_tiles` launches it over
// a batch of members (grid.z), each with its own A, C and residual and its
// own B (or one B shared by all), writing C in any output type TO.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace rt {

// One batched launch's arguments (gemm_batched.cu's entry point).
struct Batched {
  int out;  // C's dtype code (DT_*)
  bool q;   // B, B2 int8 with f32 scales
  const void *a, *b, *b2;
  const float *bs, *b2s;
  int qa, qb;
  bool nk;
  const void *bias, *res;
  void* c;
  int batch;
  long sb, ss;
  int M, K, N, act;
  cudaStream_t stream;
};

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
// C is TO: the accumulator's epilogue value rounded once to it.
template <typename T, typename TO, bool GATE, bool Q>
__device__ __forceinline__ void gemm_tile(
    const T* __restrict__ a, const std::conditional_t<Q, int8_t, T>* __restrict__ b,
    const std::conditional_t<Q, int8_t, T>* __restrict__ b2, const float* __restrict__ bs,
    const float* __restrict__ b2s, int qa, int qb, bool nk, const T* __restrict__ bias,
    const T* __restrict__ res, TO* __restrict__ c, int M, int K, int N, int act) {
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
      c[o] = from_f<TO>(epilogue<T>(acc[i][j], g, bias, res, gn, o, act, GATE));
    }
  }
}

// Batch member blockIdx.z: A's and C's (and the residual's) z-th (M, K) and
// (M, N) matrices, B's, B2's and their scales' `sb` and `ss` elements on
// (0: one B shared by every member).
template <typename T, typename TO, bool GATE, bool Q, typename TB>
__device__ __forceinline__ void member_tile(
    const T* a, const TB* b, const TB* b2, const float* bs, const float* b2s, int qa, int qb,
    bool nk, const T* bias, const T* res, TO* c, int M, int K, int N, int act, long sb,
    long ss) {
  const long z = blockIdx.z, plane = static_cast<long>(M) * N;
  a += z * M * K;
  b += z * sb;
  if (b2) b2 += z * sb;
  if (bs) bs += z * ss;
  if (b2s) b2s += z * ss;
  if (res) res += z * plane;
  gemm_tile<T, TO, GATE, Q>(a, b, b2, bs, b2s, qa, qb, nk, bias, res, c + z * plane, M, K, N,
                            act);
}

template <typename T, typename TO, bool GATE, bool Q>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const std::conditional_t<Q, int8_t, T>* __restrict__ b,
            const std::conditional_t<Q, int8_t, T>* __restrict__ b2,
            const float* __restrict__ bs, const float* __restrict__ b2s, int qa, int qb,
            bool nk, const T* __restrict__ bias, const T* __restrict__ res, TO* __restrict__ c,
            int M, int K, int N, int act, long sb, long ss) {
  member_tile<T, TO, GATE, Q>(a, b, b2, bs, b2s, qa, qb, nk, bias, res, c, M, K, N, act, sb, ss);
}

// The int8-B variant of f32/bf16 is held to two blocks an SM (128 registers,
// as the dense one compiles to; unbounded it takes more and runs one).  The
// bound stays off the dense kernel: stating even one block an SM there made
// it 30-40% slower at the prefill shapes (PERF.md).
template <typename T, typename TO, bool GATE>
__global__ void __launch_bounds__(THREADS, 2)
gemm_q8_kernel(const T* __restrict__ a, const int8_t* __restrict__ b,
               const int8_t* __restrict__ b2, const float* __restrict__ bs,
               const float* __restrict__ b2s, int qa, int qb, bool nk,
               const T* __restrict__ bias, const T* __restrict__ res, TO* __restrict__ c,
               int M, int K, int N, int act, long sb, long ss) {
  member_tile<T, TO, GATE, true>(a, b, b2, bs, b2s, qa, qb, nk, bias, res, c, M, K, N, act, sb,
                                 ss);
}

// One launch of the tile kernels over `batch` members (grid.z): the dense
// body (Q false) or the int8-B one.  Returns cudaGetLastError().
template <typename T, typename TO, bool Q>
int run_tiles(const void* a, const void* b, const void* b2, const float* bs, const float* b2s,
              int qa, int qb, bool nk, const void* bias, const void* res, void* c, int batch,
              long sb, long ss, int M, int K, int N, int act, cudaStream_t s) {
  using TB = std::conditional_t<Q, int8_t, T>;
  const T* at = static_cast<const T*>(a);
  const TB* bt = static_cast<const TB*>(b);
  const TB* b2t = static_cast<const TB*>(b2);
  const T* biast = static_cast<const T*>(bias);
  const T* rest = static_cast<const T*>(res);
  TO* ct = static_cast<TO*>(c);
  const long tiles_m = (M + BM - 1) / BM;
  constexpr bool bounded = Q && sizeof(T) < 8;
  if (b2) {
    const dim3 grid((unsigned)(tiles_m * ((N + 63) / 64)), 1, (unsigned)batch);
    if constexpr (bounded)
      gemm_q8_kernel<T, TO, true><<<grid, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk,
                                                           biast, rest, ct, M, K, N, act, sb, ss);
    else
      gemm_kernel<T, TO, true, Q><<<grid, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk,
                                                           biast, rest, ct, M, K, N, act, sb, ss);
  } else {
    const dim3 grid((unsigned)(tiles_m * ((N + 127) / 128)), 1, (unsigned)batch);
    if constexpr (bounded)
      gemm_q8_kernel<T, TO, false><<<grid, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk,
                                                            biast, rest, ct, M, K, N, act, sb, ss);
    else
      gemm_kernel<T, TO, false, Q><<<grid, THREADS, 0, s>>>(at, bt, b2t, bs, b2s, qa, qb, nk,
                                                            biast, rest, ct, M, K, N, act, sb, ss);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batched launch for A of type T, C of the type g.out names.
template <typename T, bool Q>
int batched_by_out(const Batched& g) {
  const float *bs = Q ? g.bs : nullptr, *b2s = Q ? g.b2s : nullptr;
  const long ss = Q ? g.ss : 0;
  switch (g.out) {
    case DT_F32:
      return run_tiles<T, float, Q>(g.a, g.b, g.b2, bs, b2s, g.qa, g.qb, g.nk, g.bias, g.res,
                                    g.c, g.batch, g.sb, ss, g.M, g.K, g.N, g.act, g.stream);
    case DT_BF16:
      return run_tiles<T, __nv_bfloat16, Q>(g.a, g.b, g.b2, bs, b2s, g.qa, g.qb, g.nk, g.bias,
                                            g.res, g.c, g.batch, g.sb, ss, g.M, g.K, g.N, g.act,
                                            g.stream);
    case DT_F64:
      return run_tiles<T, double, Q>(g.a, g.b, g.b2, bs, b2s, g.qa, g.qb, g.nk, g.bias, g.res,
                                     g.c, g.batch, g.sb, ss, g.M, g.K, g.N, g.act, g.stream);
    case DT_F16:
      return run_tiles<T, __half, Q>(g.a, g.b, g.b2, bs, b2s, g.qa, g.qb, g.nk, g.bias, g.res,
                                     g.c, g.batch, g.sb, ss, g.M, g.K, g.N, g.act, g.stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The batched launch for A of type T, dense (Q false) or packed B: each
// defined in a source of its own (gemm_batched.cu f32, gemm_batched_bf16.cu,
// gemm_batched_f64.cu and gemm_batched_f64_q8.cu), so that their tile
// instantiations compile in parallel (f64's are the slowest to compile).
template <typename T, bool Q>
int run_batched(const Batched& g);
template <> int run_batched<float, false>(const Batched& g);
template <> int run_batched<float, true>(const Batched& g);
template <> int run_batched<__nv_bfloat16, false>(const Batched& g);
template <> int run_batched<__nv_bfloat16, true>(const Batched& g);
template <> int run_batched<double, false>(const Batched& g);
template <> int run_batched<double, true>(const Batched& g);

}  // namespace rt
