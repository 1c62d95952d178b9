// Batched GEMV in its op = A form with a fused epilogue, one launch a call,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/bgemv.py` (`_bgemv_kernel`,
// pallas_call at :230) in its `transpose_a=False` forms (the reference's
// default, and `core.blas.batched_gemv`'s):
//
//     y[b, i] = epi( sum_j A[i, j] * x[b, j]  [, sum_j A2[i, j] * x[b, j]] )
//
// with A (M, N) row-major broadcast across the batch, or one A (and A2) a
// member, (B, M, N) (BATCHED); x (B, N), bias (M,), residual (B, M); f32,
// bf16 and f64, summed in max(f32, dtype).  The op = A^T form is
// csrc/bgemv.cu.
//
// Bound: bytes.  Every A element is used for at most 4 FMAs (2 a member
// when BATCHED), so the time is A over HBM: (32, 2048, 2048) in f64 is
// 1.07 GB, 0.32 ms at 3.35 TB/s.
//
// Design against it: gemv.cu's row-dot body, one output a row.
//  - the reduction runs along the contiguous N: `wpr` warps own a row (1
//    when the rows alone fill the card, up to 8 for few long rows), the
//    lanes of a warp read 16 contiguous bytes each and issue UNROLL such
//    loads before any arithmetic; rows not on 16 bytes (N * size % 16 != 0)
//    take element loads, still coalesced across the warp;
//  - broadcast A: a block holds up to BMAX = 4 batch rows of x and reads
//    each A row once for all of them (the amortisation of bgemv.py:10-20);
//    batches above 4 run in chunks of 4, re-reading A per chunk;
//  - where one warp takes a row, it takes ROW_BLOCK = 4 rows when A is
//    broadcast, so each x load from L1/L2 serves 4 rows as each A load
//    serves 4 batch rows, and when rows are shorter than one sweep of the
//    warp's loads, so a block has work enough (kernels/bgemv.py::plan says
//    what was measured; one row a warp, (8192, 8192) x 4 rows of bf16 ran
//    at 64% of the byte bound, 4 rows at 75%);
//  - BATCHED: a block takes one member, its A at a 64-bit offset;
//  - the block index is (batch chunk, row group) folded into grid.x, so
//    any batch fits the grid;
//  - each output is summed in one fixed order (lanes by a shuffle tree, the
//    wpr warps of a row in shared memory in warp order), the epilogue
//    applied in the accumulator type before the one write; no atomics, so
//    two launches on the same inputs give the same bits.
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // ROW_WARPS in kernels/bgemv.py
constexpr int UNROLL = 4;            // ROW_UNROLL in kernels/bgemv.py
constexpr int BMAX = 4;              // batch rows of x a block (BATCH_CHUNK)
constexpr int ROW_BLOCK = 4;         // rows a warp when one warp takes a row (ROW_BLOCK),
                                     // half as many under the gate (its second sums)

// R: rows of A a warp takes (R > 1 only with wpr = 1): each x load then
// serves R rows, as each A load serves the block's NB batch rows.
template <typename T, bool GATE, bool BATCHED, int R>
__global__ void __launch_bounds__(THREADS)
bgemv_rows_kernel(const T* __restrict__ a, const T* __restrict__ a2, const T* __restrict__ x,
                  const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
                  int B, int M, int N, int wpr, int groups, int act, bool vec_ok) {
  using A = typename Acc<T>::type;
  constexpr int V = Vec<T>::N;
  constexpr int NACC = GATE ? 2 : 1;
  constexpr int NB = BATCHED ? 1 : BMAX;  // batch rows a block
  constexpr int U = R == 1 ? UNROLL : 1;  // 16-byte A loads a row a lane issues together
  __shared__ A red[NACC][NB][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x / groups, group = blockIdx.x % groups;
  const int row0 = (group * (WARPS / wpr) + warp / wpr) * R;  // this warp's first row
  const int part = warp % wpr;
  const int step = wpr * 32;  // lanes sweeping one row
  const int b0 = chunk * NB, nb = min(NB, B - b0);
  // rows past M and batch rows past B re-read the last ones: never written
  const T* ap[NACC][R];
  const T* xr[NB];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long ro = ((BATCHED ? (long)b0 * M : 0) + min(row0 + i, M - 1)) * N;
    ap[0][i] = a + ro;
    if constexpr (GATE) ap[1][i] = a2 + ro;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) xr[b] = x + (long)(b0 + min(b, nb - 1)) * N;

  A s[NACC][R][NB];
#pragma unroll
  for (int k = 0; k < NACC; ++k)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < NB; ++b) s[k][i][b] = A(0);
  auto fma_x = [&](const A (&av)[NACC][R][V], long off) {  // x at column off
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      A xv[V];
      load16(xr[b] + off, xv);
#pragma unroll
      for (int k = 0; k < NACC; ++k)
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) s[k][i][b] += av[k][i][e] * xv[e];
    }
  };
  if (row0 < M) {
    int done = 0;
    if (vec_ok) {
      const int nv = N / V;
      int j = part * 32 + lane;
      for (; j + (U - 1) * step < nv; j += U * step) {
        A av[U][NACC][R][V];
#pragma unroll
        for (int u = 0; u < U; ++u)  // all A loads first: U x R x NACC in flight
#pragma unroll
          for (int k = 0; k < NACC; ++k)
#pragma unroll
            for (int i = 0; i < R; ++i) load16(ap[k][i] + (long)(j + u * step) * V, av[u][k][i]);
#pragma unroll
        for (int u = 0; u < U; ++u) fma_x(av[u], (long)(j + u * step) * V);
      }
      for (; j < nv; j += step) {
        A av[NACC][R][V];
#pragma unroll
        for (int k = 0; k < NACC; ++k)
#pragma unroll
          for (int i = 0; i < R; ++i) load16(ap[k][i] + (long)j * V, av[k][i]);
        fma_x(av, (long)j * V);
      }
      done = nv * V;
    }
    for (int c = done + part * 32 + lane; c < N; c += step) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const A xv = to_f(xr[b][c]);
#pragma unroll
        for (int k = 0; k < NACC; ++k)
#pragma unroll
          for (int i = 0; i < R; ++i) s[k][i][b] += to_f(ap[k][i][c]) * xv;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NACC; ++k)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int b = 0; b < NB; ++b) s[k][i][b] = warp_sum(s[k][i][b]);
  if constexpr (R == 1) {
    if (wpr > 1) {  // the row's warps meet in shared memory, in warp order
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NACC; ++k)
#pragma unroll
          for (int b = 0; b < NB; ++b) red[k][b][warp] = s[k][0][b];
      }
      __syncthreads();
      if (part != 0) return;
#pragma unroll
      for (int k = 0; k < NACC; ++k)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          A t = A(0);
          for (int p = 0; p < wpr; ++p) t += red[k][b][warp + p];
          s[k][0][b] = t;
        }
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b >= nb || row >= M) continue;
      const long o = (long)(b0 + b) * M + row;
      y[o] = from_f<T>(epilogue<T>(s[0][i][b], GATE ? s[NACC - 1][i][b] : A(0), bias, res, row,
                                   o, act, GATE));
    }
  }
}

template <typename T, bool GATE, bool BATCHED, int R>
int run(const void* a, const void* a2, const void* x, const void* bias, const void* res,
        void* y, int B, int M, int N, int wpr, int act, cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  const T* a2t = static_cast<const T*>(a2);
  const T* xt = static_cast<const T*>(x);
  const bool vec_ok = ((long)N * sizeof(T)) % 16 == 0 && aligned16(at) && aligned16(a2t) &&
                      aligned16(xt);
  const long rows = WARPS / wpr * R;  // rows a block
  const long groups = (M + rows - 1) / rows;
  const long chunks = BATCHED ? B : (B + BMAX - 1) / BMAX;
  if (groups * chunks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  bgemv_rows_kernel<T, GATE, BATCHED, R><<<groups * chunks, THREADS, 0, s>>>(
      at, a2t, xt, static_cast<const T*>(bias), static_cast<const T*>(res), static_cast<T*>(y),
      B, M, N, wpr, static_cast<int>(groups), act, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, const void* a2, const void* x, const void* bias, const void* res,
             void* y, int B, int M, int N, bool batched, int wpr, int rpw, int act,
             cudaStream_t s) {
#define GO(GATE, BATCHED, R) \
  run<T, GATE, BATCHED, R>(a, a2, x, bias, res, y, B, M, N, wpr, act, s)
#define BY_ROWS(GATE, BATCHED) \
  (rpw == 1 ? GO(GATE, BATCHED, 1) : GO(GATE, BATCHED, GATE ? ROW_BLOCK / 2 : ROW_BLOCK))
  if (batched) return a2 ? BY_ROWS(true, true) : BY_ROWS(false, true);
  return a2 ? BY_ROWS(true, false) : BY_ROWS(false, false);
#undef BY_ROWS
#undef GO
}

}  // namespace

// y (B, M) = epi(A x [, A2 x]) with A (M, N), broadcast, or (B, M, N) when
// batched; a2, bias and res may be NULL; wpr in {1, 2, 4, 8} warps a row,
// rpw 1 or ROW_BLOCK rows a warp (ROW_BLOCK / 2 with a2; either only with
// wpr 1: the gate's second sums take the registers of the other rows, f64
// spilled at 4 rows and the gate).  Returns
// cudaErrorInvalidValue for what the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int bgemv_rows_launch(int dtype, const void* a, const void* a2, const void* x,
                                 const void* bias, const void* res, void* y, int B, int M,
                                 int N, int batched, int wpr, int rpw, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = a2 ? ROW_BLOCK / 2 : ROW_BLOCK;
  if (wpr < 1 || wpr > WARPS || WARPS % wpr || (rpw != 1 && (rpw != block || wpr != 1)) ||
      B < 1 || M < 1 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define GO(T) dispatch<T>(a, a2, x, bias, res, y, B, M, N, batched, wpr, rpw, act, s)
  if (dtype == DT_F32) return GO(float);
  if (dtype == DT_BF16) return GO(__nv_bfloat16);
  if (dtype == DT_F64) return GO(double);
#undef GO
  return static_cast<int>(cudaErrorInvalidValue);
}
