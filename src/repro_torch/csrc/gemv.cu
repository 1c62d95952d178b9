// Dense GEMV for Hopper (sm_90a), f32, bf16 and f64: y = A x.
//
// Replaces the Pallas kernel `repro/kernels/gemv.py` (`_gemv_kernel`,
// pallas_call at :146) in its dense form: A (M, N) row-major, x (N,),
// y (M,) in A's dtype, accumulated in max(f32, dtype).
//
// Bound: bytes.  Every element of A is used once (2 flops per element), so
// the time is A over HBM: 16384^2 doubles are 2.15 GB, 0.64 ms at 3.35 TB/s.
//
// Design against that bound: the reduction runs along the contiguous N.
//  - `wpr` warps own a row (1 when M alone fills the card, up to 8 for few
//    long rows, whose partials meet in shared memory in a fixed order); the
//    lanes of a warp read 16 contiguous bytes each, 512 bytes per warp, and
//    issue UNROLL such loads before any arithmetic;
//  - x is re-read by every row from L1/L2 (N elements, far below the cache);
//  - rows whose start is not 16-byte aligned (N * size % 16 != 0) take
//    element loads, still coalesced across the warp;
//  - row offsets are 64-bit: A passes 2^31 bytes at 16384^2 in f64.
// No atomics: each y element is summed in one fixed order.
// Later work (not here): TMA bulk loads; the transposed form (trans=True is
// a materialised transpose in core/blas.py, as in the reference).
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y, int M,
            int N, int wpr, bool vec_ok) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<T>::N;
  __shared__ A red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (WARPS / wpr) + warp / wpr;
  const int part = warp % wpr;
  const int step = wpr * 32;  // lanes sweeping one row
  A s = 0;
  if (row < M) {
    const T* ar = a + (long)row * N;
    int done = 0;
    if (vec_ok) {
      const int nv = N / V;
      int j = part * 32 + lane;
      for (; j + (UNROLL - 1) * step < nv; j += UNROLL * step) {
        A av[UNROLL][V], xv[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {  // all loads first: UNROLL in flight
          load16(ar + (long)(j + u * step) * V, av[u]);
          load16(x + (long)(j + u * step) * V, xv[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) s += av[u][e] * xv[u][e];
      }
      for (; j < nv; j += step) {
        A av[V], xv[V];
        load16(ar + (long)j * V, av);
        load16(x + (long)j * V, xv);
#pragma unroll
        for (int e = 0; e < V; ++e) s += av[e] * xv[e];
      }
      done = nv * V;
    }
    for (int c = done + part * 32 + lane; c < N; c += step) s += to_f(ar[c]) * to_f(x[c]);
  }
  s = warp_sum(s);
  if (wpr == 1) {
    if (lane == 0 && row < M) y[row] = from_f<T>(s);
    return;
  }
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (part == 0 && lane == 0 && row < M) {
    A t = 0;
    for (int p = 0; p < wpr; ++p) t += red[warp + p];
    y[row] = from_f<T>(t);
  }
}

template <typename T>
int run(const void* a, const void* x, void* y, int M, int N, int wpr, cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(x);
  const bool vec_ok = ((long)N * sizeof(T)) % 16 == 0 && aligned16(at) && aligned16(xt);
  const int rows = WARPS / wpr;
  gemv_kernel<T><<<(M + rows - 1) / rows, THREADS, 0, s>>>(at, xt, static_cast<T*>(y), M, N,
                                                            wpr, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M,) = A (M, N) @ x (N,); wpr in {1, 2, 4, 8} warps per row.
// Returns cudaGetLastError() after the launch.
extern "C" int gemv_launch(int dtype, const void* a, const void* x, void* y, int M, int N,
                           int wpr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wpr < 1 || wpr > WARPS || WARPS % wpr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) return run<float>(a, x, y, M, N, wpr, s);
  if (dtype == DT_BF16) return run<__nv_bfloat16>(a, x, y, M, N, wpr, s);
  if (dtype == DT_F64) return run<double>(a, x, y, M, N, wpr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
