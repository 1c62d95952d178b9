// Level-1 BLAS for Hopper (sm_90a): dot, nrm2 and axpy in f32, bf16 and f64.
//
// Replaces the Pallas kernels of `repro/kernels/blas1.py`: `_reduce` (the
// `dot` / `nrm2` reduction, pallas_call at :55) and `axpy` (:92).
//
//     dot  = sum_i x[i] * y[i]          nrm2 = sqrt(sum_i x[i]^2)
//     axpy = alpha * x + y
//
// Bound: bytes.  Each element is used once (2 flops per 2 loads), so the time
// is the vectors over HBM: 2^26 doubles are 0.16 ms a vector at 3.35 TB/s.
//
// Design against that bound:
//  - the reduction: 16-byte loads (4 f32, 8 bf16, 2 f64 a lane), UNROLL of
//    them issued before any arithmetic, over a grid-stride loop of ~8 blocks
//    per SM, so enough bytes are in flight to cover HBM latency; a ragged
//    tail (or unaligned operands) takes element loads;
//  - axpy on 16-byte operands: one block a contiguous chunk of the vectors,
//    one 16-byte vector a thread, as many blocks as chunks (a warp's loads
//    are 512 contiguous bytes of x and of y, and the grid streams the
//    vectors front to back); the grid-stride design above, whose warps kept
//    12 streams a whole grid apart, ran 4-5% slower than `add` (PERF.md
//    lists the other designs measured and dropped).  Unaligned operands
//    take element loads over the grid-stride grid;
//  - the sum runs in the accumulator type (f32 for f32/bf16, f64 for f64):
//    each thread, then the warp (shuffles), then the block (shared memory),
//    into one partial per block; a second one-block pass sums the partials
//    in a fixed order, takes the sqrt for nrm2 and rounds once to x's dtype.
//    No atomics: the result is the same bits on every run of one grid;
//  - nrm2 is the plain sqrt of the sum of squares (the reference's
//    arithmetic, no LAPACK-style scaling) and reads x once;
//  - axpy rounds alpha * x and then the sum, each once in the accumulator
//    type, as the reference's separate multiply and add do.
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;

// Sum of v over the block, in a fixed order; the total lands in thread 0.
template <typename A>
__device__ __forceinline__ A block_sum(A v) {
  __shared__ A red[WARPS];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  A s = 0;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// Pass 1: grid-stride partial sums of x*y (SQUARE: x*x, y unread).
template <typename T, bool SQUARE>
__global__ void __launch_bounds__(THREADS)
reduce_partial(const T* __restrict__ x, const T* __restrict__ y,
               typename Acc<T>::type* __restrict__ partial, long n, bool vec_ok) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<T>::N;
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * THREADS;
  A s = 0;
  long done = 0;
  if (vec_ok) {
    const long nv = n / V;
    long i = tid;
    for (; i + (UNROLL - 1) * stride < nv; i += UNROLL * stride) {
      A xv[UNROLL][V], yv[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // all loads first: UNROLL in flight
        load16(x + (i + u * stride) * V, xv[u]);
        if constexpr (!SQUARE) load16(y + (i + u * stride) * V, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) s += xv[u][e] * (SQUARE ? xv[u][e] : yv[u][e]);
    }
    for (; i < nv; i += stride) {
      A xv[V], yv[V];
      load16(x + i * V, xv);
      if constexpr (!SQUARE) load16(y + i * V, yv);
#pragma unroll
      for (int e = 0; e < V; ++e) s += xv[e] * (SQUARE ? xv[e] : yv[e]);
    }
    done = nv * V;
  }
  for (long i = done + tid; i < n; i += stride) {
    const A xv = to_f(x[i]);
    s += xv * (SQUARE ? xv : to_f(y[i]));
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }  // correctly rounded
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// Pass 2: one block sums the partials in order, sqrt for nrm2, one rounding.
template <typename T, bool SQRT>
__global__ void __launch_bounds__(THREADS)
reduce_finish(const typename Acc<T>::type* __restrict__ partial, int parts,
              T* __restrict__ out) {
  using A = typename Acc<T>::type;
  A s = 0;
  for (int i = threadIdx.x; i < parts; i += THREADS) s += partial[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = from_f<T>(SQRT ? sqrt_(s) : s);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// axpy: out[i] = alpha * x[i] + y[i].  vec_ok (x, y and out on 16-byte
// boundaries): thread t of block b takes 16-byte vector b * THREADS + t of
// each (the host gives one block a chunk of THREADS vectors), then the
// elements after the last whole vector; else one element a thread over a
// grid-stride loop.
template <typename T>
__global__ void __launch_bounds__(THREADS)
axpy_kernel(typename Acc<T>::type alpha, const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ out, long n, bool vec_ok) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<T>::N;
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * THREADS;
  long done = 0;
  if (vec_ok) {
    const long nv = n / V;
    for (long i = tid; i < nv; i += stride) {
      A xv[V], yv[V];
      load16(x + i * V, xv);
      load16(y + i * V, yv);
#pragma unroll
      for (int e = 0; e < V; ++e) xv[e] = add_rn(mul_rn(alpha, xv[e]), yv[e]);
      Vec<T>::store(out + i * V, xv);
    }
    done = nv * V;
  }
  for (long i = done + tid; i < n; i += stride)
    out[i] = from_f<T>(add_rn(mul_rn(alpha, to_f(x[i])), to_f(y[i])));
}

template <typename T>
int reduce(const void* x, const void* y, void* partial, void* out, long n, int blocks,
           bool nrm2, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  A* pt = static_cast<A*>(partial);
  T* ot = static_cast<T*>(out);
  const bool vec_ok = aligned16(xt) && (nrm2 || aligned16(yt));
  if (nrm2) {
    reduce_partial<T, true><<<blocks, THREADS, 0, s>>>(xt, xt, pt, n, vec_ok);
    reduce_finish<T, true><<<1, THREADS, 0, s>>>(pt, blocks, ot);
  } else {
    reduce_partial<T, false><<<blocks, THREADS, 0, s>>>(xt, yt, pt, n, vec_ok);
    reduce_finish<T, false><<<1, THREADS, 0, s>>>(pt, blocks, ot);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int axpy(double alpha, const void* x, const void* y, void* out, long n, int blocks,
         cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  const bool vec_ok = aligned16(xt) && aligned16(yt) && aligned16(ot);
  axpy_kernel<T><<<blocks, THREADS, 0, s>>>(static_cast<typename Acc<T>::type>(alpha), xt,
                                            yt, ot, n, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dot (nrm2 = 0) or nrm2 (nrm2 = 1, y unread) of n elements into out[0] (x's
// dtype); partial holds `blocks` accumulators (f32, or f64 for f64).
// Returns cudaGetLastError() after the two launches.
extern "C" int blas1_reduce_launch(int dtype, const void* x, const void* y, void* partial,
                                   void* out, long long n, int blocks, int nrm2,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) return reduce<float>(x, y, partial, out, n, blocks, nrm2, s);
  if (dtype == DT_BF16) return reduce<__nv_bfloat16>(x, y, partial, out, n, blocks, nrm2, s);
  if (dtype == DT_F64) return reduce<double>(x, y, partial, out, n, blocks, nrm2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out = alpha * x + y over n elements, alpha rounded to the accumulator type,
// over `blocks` blocks (kernels/blas1.py::axpy_blocks).
extern "C" int blas1_axpy_launch(int dtype, double alpha, const void* x, const void* y,
                                 void* out, long long n, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) return axpy<float>(alpha, x, y, out, n, blocks, s);
  if (dtype == DT_BF16) return axpy<__nv_bfloat16>(alpha, x, y, out, n, blocks, s);
  if (dtype == DT_F64) return axpy<double>(alpha, x, y, out, n, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
