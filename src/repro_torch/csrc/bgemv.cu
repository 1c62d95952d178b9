// Broadcast-weight batched GEMV with a fused epilogue, one launch a call,
// for Hopper (sm_90a).
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
// time is the weight stream over HBM (3.35 TB/s), and at the served shapes
// (2-17 MB of weights) the latency of getting that stream started.
//
// Design against it (`kernels/bgemv.py::plan` picks the K split):
//  - a block owns a column tile of 128 bytes of every row (64 bf16 or 32
//    f32 columns: N = 2048 gives 32-64 tiles, the first design's 512-byte
//    tiles gave 8-16); each warp reads 4 rows x 128 contiguous bytes at a
//    time, one 16-byte load a lane, and the block's 8 warps take 32
//    consecutive rows a step;
//  - each W element is read ONCE for the whole batch: every lane keeps
//    4 x VEC accumulators (the broadcast amortisation of bgemv.py:12-20);
//    batches above 4 run in chunks of 4 (grid.z), re-reading W per chunk;
//  - K is cut into `splits` slices of `rows` rows (a multiple of 32), the
//    plan keeping the grid within about 2 blocks an SM; a lane keeps two
//    batches of UNROLL loads in flight and refills each as soon as it is
//    used, the first two issued before it stages x, so x's latency hides
//    under W's;
//  - the block's slice of x (4 batch rows x `rows`) is staged once in shared
//    memory as f32, one 16-byte broadcast read per weight row (the first
//    design read x with scalar global loads beside every weight row);
//  - the 4 row lanes of a column meet by a fixed shuffle tree, the 8 warps
//    in shared memory in warp order, and the splits in the same launch: each
//    block writes its f32 partial tile to a workspace, and the last block of
//    a column tile to finish (an int ticket taken after __threadfence, as in
//    attention_splitkv.cu) sums the splits' partials in split order, applies
//    the epilogue in f32, writes y once and resets the ticket.  No floating-
//    point atomics: a row's bits depend on the plan (the shape) alone, and
//    two launches on the same inputs give the same bits.  With one split
//    there is no workspace and no ticket.  (Combining the splits of a tile
//    in a thread-block cluster through distributed shared memory instead
//    measured slower at 8 splits, PERF.md.)
// The partials cost splits * B * N * 4 bytes each way, 3-12% of the weight
// bytes at the served shapes, and they stay in L2.
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BMAX = 4;
constexpr int ROW_STEP = WARPS * 4;  // rows a block takes a step (kernels/bgemv.py)
constexpr int MAX_ROWS = 1024;       // rows a block at most: x's slice in shared memory

template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS, 2)
bgemv_kernel(const T* __restrict__ w, const T* __restrict__ w2, const T* __restrict__ x,
             const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
             float* __restrict__ ws, int* __restrict__ tickets, int B, int K, int N, int rows,
             int act, bool vec_ok) {
  constexpr int VEC = Vec<T>::N, TN = 8 * VEC;  // columns a tile: 8 lanes x 16 bytes
  constexpr int NACC = GATE ? 2 : 1;
  constexpr int UNROLL = GATE ? 2 : 4;          // steps a batch; two batches in flight
  __shared__ float4 xs[MAX_ROWS];               // x[b0 + 0..3][r0 + i]
  __shared__ float red[NACC][WARPS][BMAX][TN];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int c0 = tile * TN + (lane & 7) * VEC;  // this lane's first column
  const int lr0 = warp * 4 + (lane >> 3);       // this lane's row within a step
  const int b0 = blockIdx.z * BMAX, nb = min(BMAX, B - b0);
  const int r0 = split * rows, r1 = min(K, r0 + rows);
  const int steps = (r1 - r0 + ROW_STEP - 1) / ROW_STEP;
  const bool vec = vec_ok && c0 + VEC <= N;

  const T* wp[NACC] = {w};
  if constexpr (GATE) wp[1] = w2;
  using Batch = uint4[NACC][UNROLL];
  // the 16-byte loads of steps [s0, s0 + UNROLL); rows past r1 load zeros
  auto load = [&](int s0, Batch& raw) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + (s0 + u) * ROW_STEP + lr0;
      const bool live = s0 + u < steps && r < r1;
      const long off = (long)r * N + c0;
#pragma unroll
      for (int a = 0; a < NACC; ++a)
        raw[a][u] = live ? __ldg(reinterpret_cast<const uint4*>(wp[a] + off))
                         : make_uint4(0, 0, 0, 0);
    }
  };
  Batch ra, rb;
  if (vec) {  // two batches in flight while x is staged
    load(0, ra);
    load(UNROLL, rb);
  }

  for (int i = tid; i < rows; i += THREADS) {
    const int r = r0 + i;
    float v[BMAX];
#pragma unroll
    for (int b = 0; b < BMAX; ++b) v[b] = b < nb && r < r1 ? to_f(x[(long)(b0 + b) * K + r]) : 0.f;
    xs[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  float acc[NACC][BMAX][VEC];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int b = 0; b < BMAX; ++b)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[a][b][i] = 0.f;
  auto fma_row = [&](int a, const float (&f)[VEC], const float4& xv) {
    const float xb[BMAX] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int b = 0; b < BMAX; ++b)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[a][b][i] = fmaf(f[i], xb[b], acc[a][b][i]);
  };
  auto consume = [&](int s0, const Batch& raw) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u < steps) {  // xs past `rows` is never written
        const float4 xv = xs[(s0 + u) * ROW_STEP + lr0];
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          float f[VEC];
          Vec<T>::unpack(raw[a][u], f);
          fma_row(a, f, xv);
        }
      }
    }
  };
  if (vec) {  // each batch refilled as soon as it is used: two stay in flight
    for (int s0 = 0; s0 < steps; s0 += 2 * UNROLL) {
      consume(s0, ra);
      if (s0 + 2 * UNROLL < steps) load(s0 + 2 * UNROLL, ra);
      consume(s0 + UNROLL, rb);
      if (s0 + 3 * UNROLL < steps) load(s0 + 3 * UNROLL, rb);
    }
  } else if (c0 < N) {  // a ragged last tile or unaligned rows: element loads
    for (int s = 0; s < steps; ++s) {
      const int r = r0 + s * ROW_STEP + lr0;
      if (r >= r1) continue;
      const float4 xv = xs[s * ROW_STEP + lr0];
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        float f[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = c0 + i < N ? to_f(wp[a][(long)r * N + c0 + i]) : 0.f;
        fma_row(a, f, xv);
      }
    }
  }

  // the 4 row lanes of each column (lanes xor 8, 16), then the 8 warps
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int b = 0; b < BMAX; ++b)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float v = acc[a][b][i];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) red[a][warp][b][lane * VEC + i] = v;
      }
  __syncthreads();
  const int ob = tid / TN, oc = tid % TN, col = tile * TN + oc;
  const bool mine = ob < nb && col < N;  // this thread's output (b0 + ob, col)
  const long o = (long)(b0 + ob) * N + col;
  float s[2] = {0.f, 0.f};
  if (mine) {
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s[a] += red[a][wi][ob][oc];
  }
  if (splits == 1) {
    if (mine) y[o] = from_f<T>(epilogue<T>(s[0], s[1], bias, res, col, o, act, GATE));
    return;
  }

  // ws is [NACC][splits][B][N]: this split's partials, then the ticket
  const long plane = (long)B * N;
  if (mine) {
#pragma unroll
    for (int a = 0; a < NACC; ++a) ws[(long)(a * splits + split) * plane + o] = s[a];
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.x + tile;
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *ticket = 0;
  if (!mine) return;
  float t[2] = {0.f, 0.f};  // the splits' partials, summed in split order
#pragma unroll 8
  for (int k = 0; k < splits; ++k)
#pragma unroll
    for (int a = 0; a < NACC; ++a) t[a] += __ldcg(ws + (long)(a * splits + k) * plane + o);
  y[o] = from_f<T>(epilogue<T>(t[0], t[1], bias, res, col, o, act, GATE));
}

template <typename T, bool GATE>
int run(const void* w, const void* w2, const void* x, const void* bias, const void* res,
        void* y, float* ws, int* tickets, int B, int K, int N, int splits, int rows, int act,
        cudaStream_t s) {
  constexpr int TN = 8 * Vec<T>::N;
  if (splits < 1 || rows < 1 || rows % ROW_STEP || rows > MAX_ROWS ||
      (long)splits * rows < K || (splits > 1 && (long)(splits - 1) * rows >= K) ||
      (splits > 1 && (!ws || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = (N * sizeof(T)) % 16 == 0 && aligned16(static_cast<const T*>(w)) &&
                      aligned16(static_cast<const T*>(w2));
  const dim3 grid((N + TN - 1) / TN, splits, (B + BMAX - 1) / BMAX);
  bgemv_kernel<T, GATE><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(w), static_cast<const T*>(w2), static_cast<const T*>(x),
      static_cast<const T*>(bias), static_cast<const T*>(res), static_cast<T*>(y), ws, tickets,
      B, K, N, rows, act, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* w, const void* w2, const void* x, const void* bias, const void* res,
             void* y, float* ws, int* tickets, int B, int K, int N, int splits, int rows, int act,
             cudaStream_t s) {
  if (w2) return run<T, true>(w, w2, x, bias, res, y, ws, tickets, B, K, N, splits, rows, act, s);
  return run<T, false>(w, w2, x, bias, res, y, ws, tickets, B, K, N, splits, rows, act, s);
}

}  // namespace

// One launch.  w2, bias and res may be NULL.  K is cut into `splits` slices
// of `rows` rows (a multiple of 32, at most 1024; the last slice may be
// short).  With splits > 1, ws holds (w2 ? 2 : 1) * splits * B * N floats
// and tickets ceil(N / tile) * ceil(B / 4) ints, all zero (the kernel
// leaves them zero).  Returns cudaErrorInvalidValue for a plan the kernel
// does not take, else cudaGetLastError() after the launch.
extern "C" int bgemv_launch(int dtype, const void* w, const void* w2, const void* x,
                            const void* bias, const void* res, void* y, void* ws,
                            void* tickets, int B, int K, int N, int splits, int rows, int act,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  if (dtype == DT_F32)
    return dispatch<float>(w, w2, x, bias, res, y, wsf, tk, B, K, N, splits, rows, act, s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(w, w2, x, bias, res, y, wsf, tk, B, K, N, splits, rows, act,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
