// Broadcast-weight batched GEMV with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/bgemv.py` (`_bgemv_kernel`, the
// `transpose_a=True` form the decode path uses):
//
//     y[b, j] = epi( sum_i x[b, i] * W[i, j]  [, sum_i x[b, i] * W2[i, j]] )
//
// with W (K, N) row-major in its stored layout (the model's (d_in, d_out)
// weight; W^T is never materialised), x (B, K), bias (N,), residual (B, N).
//
// Bound: bytes.  At decode batch 4 every weight element is used for 4 FMAs,
// far below the ~295 FLOP/byte the card needs to be compute bound, so the
// time is the weight stream over HBM (3.35 TB/s).
//
// Design against that bound:
//  - threads walk output columns, each lane loading 16 contiguous bytes of a
//    W row (8 bf16 or 4 f32 columns), so a warp reads 512 contiguous bytes;
//  - each W element is read ONCE for the whole batch: every lane keeps
//    4 x VEC accumulators (the broadcast amortisation of bgemv.py:12-20);
//    batches above 4 run in chunks of 4 (grid.z), re-reading W per chunk;
//  - the K sweep is split twice, so enough loads are in flight to cover
//    HBM latency even at N = 2048 (only 8 column tiles): across the 8 warps
//    of a block (partials meet in shared memory) and across `splits` blocks
//    (about two blocks per SM in all).  Block partials land in an f32
//    workspace; a second pass sums them in a fixed order (deterministic),
//    applies the epilogue in f32 and writes each output once.  The
//    workspace costs splits * B * N * 4 bytes each way, ~25% of the weight
//    bytes at N = K = 2048 and less at the wider projections.
// Later work (not here): TMA bulk loads, fusing the second pass into the
// last block of each column tile.
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BMAX = 4;
constexpr int UNROLL = 4;

// Rows [r, r1) step WARPS of this lane's VEC columns, 16-byte loads.
template <typename T, bool GATE>
__device__ __forceinline__ void sweep_vec(const T* __restrict__ w, const T* __restrict__ w2,
                                          const T* __restrict__ x, int K, int N, int nb,
                                          int c0, int r, int r1,
                                          float (&acc)[BMAX][Vec<T>::N],
                                          float (&acc2)[BMAX][Vec<T>::N]) {
  constexpr int VEC = Vec<T>::N;
  for (; r + (UNROLL - 1) * WARPS < r1; r += UNROLL * WARPS) {
    uint4 raw[UNROLL], raw2[UNROLL];
    float xv[UNROLL][BMAX];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // all loads first: UNROLL rows in flight
      const long off = (long)(r + u * WARPS) * N + c0;
      raw[u] = __ldg(reinterpret_cast<const uint4*>(w + off));
      if constexpr (GATE) raw2[u] = __ldg(reinterpret_cast<const uint4*>(w2 + off));
#pragma unroll
      for (int b = 0; b < BMAX; ++b)
        xv[u][b] = b < nb ? to_f(x[(long)b * K + r + u * WARPS]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float f[VEC], f2[VEC];
      Vec<T>::unpack(raw[u], f);
      if constexpr (GATE) Vec<T>::unpack(raw2[u], f2);
#pragma unroll
      for (int b = 0; b < BMAX; ++b)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[b][i] = fmaf(f[i], xv[u][b], acc[b][i]);
          if constexpr (GATE) acc2[b][i] = fmaf(f2[i], xv[u][b], acc2[b][i]);
        }
    }
  }
  for (; r < r1; r += WARPS) {
    const long off = (long)r * N + c0;
    float f[VEC], f2[VEC];
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(w + off)), f);
    if constexpr (GATE) Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(w2 + off)), f2);
#pragma unroll
    for (int b = 0; b < BMAX; ++b) {
      const float xb = b < nb ? to_f(x[(long)b * K + r]) : 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[b][i] = fmaf(f[i], xb, acc[b][i]);
        if constexpr (GATE) acc2[b][i] = fmaf(f2[i], xb, acc2[b][i]);
      }
    }
  }
}

// Same sweep with element loads, for a ragged last tile or unaligned rows.
template <typename T, bool GATE>
__device__ __forceinline__ void sweep_scalar(const T* __restrict__ w, const T* __restrict__ w2,
                                             const T* __restrict__ x, int K, int N, int nb,
                                             int c0, int r, int r1,
                                             float (&acc)[BMAX][Vec<T>::N],
                                             float (&acc2)[BMAX][Vec<T>::N]) {
  constexpr int VEC = Vec<T>::N;
  for (; r < r1; r += WARPS) {
    const long off = (long)r * N + c0;
#pragma unroll
    for (int b = 0; b < BMAX; ++b) {
      const float xb = b < nb ? to_f(x[(long)b * K + r]) : 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (c0 + i < N) {
          acc[b][i] = fmaf(to_f(w[off + i]), xb, acc[b][i]);
          if constexpr (GATE) acc2[b][i] = fmaf(to_f(w2[off + i]), xb, acc2[b][i]);
        }
      }
    }
  }
}

// Sum the 8 warps' accumulators of this block and store them to out (B, N).
template <typename T>
__device__ __forceinline__ void reduce_store(float (&red)[WARPS][BMAX][32 * Vec<T>::N],
                                             const float (&acc)[BMAX][Vec<T>::N],
                                             float* __restrict__ out, int N, int nb) {
  constexpr int VEC = Vec<T>::N, TILE = 32 * VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < BMAX; ++b)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[warp][b][lane * VEC + i] = acc[b][i];
  __syncthreads();
  for (int e = threadIdx.x; e < nb * TILE; e += THREADS) {
    const int b = e / TILE, c = e % TILE, col = blockIdx.x * TILE + c;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][b][c];
    out[(long)b * N + col] = s;
  }
}

// Pass 1: grid (column tiles, splits, batch chunks); ws is
// [(GATE ? 2 : 1) * splits][B][N] f32, the gate's partials after W's.
template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS)
bgemv_partial(const T* __restrict__ w, const T* __restrict__ w2, const T* __restrict__ x,
              float* __restrict__ ws, int B, int K, int N, int splits, bool vec_ok) {
  constexpr int VEC = Vec<T>::N, TILE = 32 * VEC;
  __shared__ float red[WARPS][BMAX][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TILE + lane * VEC;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * BMAX, nb = min(BMAX, B - b0);
  const int rows = (K + splits - 1) / splits;
  const int r0 = split * rows, r1 = min(K, r0 + rows);
  const T* xb = x + (long)b0 * K;

  float acc[BMAX][VEC], acc2[BMAX][VEC];
#pragma unroll
  for (int b = 0; b < BMAX; ++b)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[b][i] = acc2[b][i] = 0.f;
  if (vec_ok && c0 + VEC <= N)
    sweep_vec<T, GATE>(w, w2, xb, K, N, nb, c0, r0 + warp, r1, acc, acc2);
  else if (c0 < N)
    sweep_scalar<T, GATE>(w, w2, xb, K, N, nb, c0, r0 + warp, r1, acc, acc2);

  const long plane = (long)B * N;
  reduce_store<T>(red, acc, ws + split * plane + (long)b0 * N, N, nb);
  if constexpr (GATE) {
    __syncthreads();  // red is reused for the gate's partials
    reduce_store<T>(red, acc2, ws + (splits + split) * plane + (long)b0 * N, N, nb);
  }
}

// Pass 2: one thread per output; the splits are summed in a fixed order.
template <typename T, bool GATE>
__global__ void __launch_bounds__(256)
bgemv_finish(const float* __restrict__ ws, const T* __restrict__ bias,
             const T* __restrict__ res, T* __restrict__ y, int B, int N, int splits,
             int act) {
  const long plane = (long)B * N;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  float s = 0.f, s2 = 0.f;
  for (int k = 0; k < splits; ++k) {
    s += ws[k * plane + idx];
    if constexpr (GATE) s2 += ws[(splits + k) * plane + idx];
  }
  y[idx] = from_f<T>(epilogue<T>(s, s2, bias, res, (int)(idx % N), idx, act, GATE));
}

template <typename T, bool GATE>
void run(const void* w, const void* w2, const void* x, const void* bias, const void* res,
         void* y, float* ws, int B, int K, int N, int splits, int act, cudaStream_t s) {
  constexpr int TILE = 32 * Vec<T>::N;
  const bool vec_ok = (N * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  const dim3 grid((N + TILE - 1) / TILE, splits, (B + BMAX - 1) / BMAX);
  bgemv_partial<T, GATE><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(w), static_cast<const T*>(w2), static_cast<const T*>(x), ws, B, K,
      N, splits, vec_ok);
  const long outs = (long)B * N;
  bgemv_finish<T, GATE><<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      ws, static_cast<const T*>(bias), static_cast<const T*>(res), static_cast<T*>(y), B, N,
      splits, act);
}

template <typename T>
void dispatch(const void* w, const void* w2, const void* x, const void* bias, const void* res,
              void* y, float* ws, int B, int K, int N, int splits, int act, cudaStream_t s) {
  if (w2) run<T, true>(w, w2, x, bias, res, y, ws, B, K, N, splits, act, s);
  else run<T, false>(w, w2, x, bias, res, y, ws, B, K, N, splits, act, s);
}

}  // namespace

// w2, bias and res may be NULL.  ws holds (w2 ? 2 : 1) * splits * B * N
// floats.  Returns cudaGetLastError() after the two launches.
extern "C" int bgemv_launch(int dtype, const void* w, const void* w2, const void* x,
                            const void* bias, const void* res, void* y, void* ws, int B,
                            int K, int N, int splits, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) dispatch<float>(w, w2, x, bias, res, y, wsf, B, K, N, splits, act, s);
  else if (dtype == DT_BF16) dispatch<__nv_bfloat16>(w, w2, x, bias, res, y, wsf, B, K, N, splits, act, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
