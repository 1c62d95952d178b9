// Batched GEMV's first op = A^T design (csrc/bgemv.cu before its per-member
// body was redesigned): a per-member A ran the broadcast body with one
// member a block, 128-byte column tiles, 4 rows a warp step and the
// member's x staged as the broadcast form's 4-wide slice.  Kept only so
// that chip_smoke.py can time it beside the short-member body
// (csrc/bgemv_members.cu) and the redesigned long-member body on the same
// inputs (`replaced_ms` of its batched-GEMV rows, `replaced_bgemv`); no
// path of the port calls it.  chip_smoke.py builds it with
// -I src/repro_torch/csrc into build/replaced/.
//
// Batched GEMV in its op = A^T form with a fused epilogue, one launch a
// call, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/bgemv.py` (`_bgemv_kernel`,
// pallas_call at :230) in its `transpose_a=True` forms, the one the decode
// path uses and the BLAS library's batched one:
//
//     y[b, j] = epi( sum_i x[b, i] * W[i, j]  [, sum_i x[b, i] * W2[i, j]] )
//
// with W (K, N) row-major in its stored layout (the model's (d_in, d_out)
// weight; W^T is never materialised) broadcast across the batch, or one W
// (and W2) a member, (B, K, N) (BATCHED); x (B, K), bias (N,), residual
// (B, N); f32, bf16 and f64, summed in max(f32, dtype).  The op = A form is
// csrc/bgemv_rows.cu.
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
//
// One W a member (BATCHED, the BLAS library's batched GEMV): no member
// shares a W element, so there is nothing to amortise, and the bound is
// every W byte once.  A block takes one member (BMAX 1: the x slice and the
// accumulators of one batch row) at a 64-bit offset into W, the member
// folded into grid.x beside the column tile so any batch fits the grid; the
// K split and its combine are the broadcast form's, one ticket a (member,
// tile).  f64 (both forms) keeps the design at 16 columns a tile, with
// double accumulators, x slice and partials.  BATCHED and the accumulator
// type are template parameters, so the f32 and bf16 broadcast
// instantiations (every decode projection) carry no term of the other forms
// (ptxas: the same registers, shared memory and spills;
// scripts/torch_ptxas_compare.py).
#include <type_traits>

#include "vec.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BMAX = 4;
constexpr int ROW_STEP = WARPS * 4;  // rows a block takes a step (kernels/bgemv.py)
constexpr int MAX_ROWS = 1024;       // rows a block at most: x's slice in shared memory

// 4 batch rows of x in the accumulator type: one shared-memory entry a row
struct alignas(32) double4x { double x, y, z, w; };
template <typename A>
using X4 = std::conditional_t<std::is_same_v<A, float>, float4, double4x>;
__device__ __forceinline__ float4 make_x4(const float (&v)[BMAX]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double4x make_x4(const double (&v)[BMAX]) {
  return {v[0], v[1], v[2], v[3]};
}
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

template <typename T, bool GATE, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 2)
bgemv_kernel(const T* __restrict__ w, const T* __restrict__ w2, const T* __restrict__ x,
             const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
             typename Acc<T>::type* __restrict__ ws, int* __restrict__ tickets, int B, int K,
             int N, int rows, int act, bool vec_ok) {
  using A = typename Acc<T>::type;
  constexpr int VEC = Vec<T>::N, TN = 8 * VEC;  // columns a tile: 8 lanes x 16 bytes
  constexpr int NACC = GATE ? 2 : 1;
  constexpr int UNROLL = GATE ? 2 : 4;          // steps a batch; two batches in flight
  constexpr int NB = BATCHED ? 1 : BMAX;        // batch rows a block
  __shared__ X4<A> xs[MAX_ROWS];                // x[b0 + 0..3][r0 + i]
  __shared__ A red[NACC][WARPS][BMAX][TN];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (N + TN - 1) / TN;          // BATCHED: grid.x is (member, tile)
  const int tile = BATCHED ? blockIdx.x % tiles : blockIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const int c0 = tile * TN + (lane & 7) * VEC;  // this lane's first column
  const int lr0 = warp * 4 + (lane >> 3);       // this lane's row within a step
  const int b0 = BATCHED ? blockIdx.x / tiles : blockIdx.z * BMAX;
  const int nb = BATCHED ? 1 : min(BMAX, B - b0);
  const int r0 = split * rows, r1 = min(K, r0 + rows);
  const int steps = (r1 - r0 + ROW_STEP - 1) / ROW_STEP;
  const bool vec = vec_ok && c0 + VEC <= N;

  const long wo = BATCHED ? (long)b0 * K * N : 0;  // this member's W
  const T* wp[NACC] = {w + wo};
  if constexpr (GATE) wp[1] = w2 + wo;
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
    A v[BMAX];
#pragma unroll
    for (int b = 0; b < BMAX; ++b) v[b] = b < nb && r < r1 ? to_f(x[(long)(b0 + b) * K + r]) : A(0);
    xs[i] = make_x4(v);
  }
  __syncthreads();

  A acc[NACC][NB][VEC];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[a][b][i] = A(0);
  auto fma_row = [&](int a, const A (&f)[VEC], const X4<A>& xv) {
    const A xb[BMAX] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[a][b][i] = fma_(f[i], xb[b], acc[a][b][i]);
  };
  auto consume = [&](int s0, const Batch& raw) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u < steps) {  // xs past `rows` is never written
        const X4<A> xv = xs[(s0 + u) * ROW_STEP + lr0];
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          A f[VEC];
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
      const X4<A> xv = xs[s * ROW_STEP + lr0];
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        A f[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = c0 + i < N ? to_f(wp[a][(long)r * N + c0 + i]) : A(0);
        fma_row(a, f, xv);
      }
    }
  }

  // the 4 row lanes of each column (lanes xor 8, 16), then the 8 warps
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        A v = acc[a][b][i];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) red[a][warp][b][lane * VEC + i] = v;
      }
  __syncthreads();
  const int ob = tid / TN, oc = tid % TN, col = tile * TN + oc;
  const bool mine = ob < nb && col < N;  // this thread's output (b0 + ob, col)
  const long o = (long)(b0 + ob) * N + col;
  A s[2] = {A(0), A(0)};
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
  int* ticket = tickets + (BATCHED ? blockIdx.x : blockIdx.z * gridDim.x + tile);
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *ticket = 0;
  if (!mine) return;
  A t[2] = {A(0), A(0)};  // the splits' partials, summed in split order
#pragma unroll 8
  for (int k = 0; k < splits; ++k)
#pragma unroll
    for (int a = 0; a < NACC; ++a) t[a] += __ldcg(ws + (long)(a * splits + k) * plane + o);
  y[o] = from_f<T>(epilogue<T>(t[0], t[1], bias, res, col, o, act, GATE));
}

template <typename T, bool GATE, bool BATCHED>
int run(const void* w, const void* w2, const void* x, const void* bias, const void* res,
        void* y, void* ws, int* tickets, int B, int K, int N, int splits, int rows, int act,
        cudaStream_t s) {
  constexpr int TN = 8 * Vec<T>::N;
  if (splits < 1 || rows < 1 || rows % ROW_STEP || rows > MAX_ROWS ||
      (long)splits * rows < K || (splits > 1 && (long)(splits - 1) * rows >= K) ||
      (splits > 1 && (!ws || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_ok = (N * sizeof(T)) % 16 == 0 && aligned16(static_cast<const T*>(w)) &&
                      aligned16(static_cast<const T*>(w2));
  const long tiles = (N + TN - 1) / TN;
  if (BATCHED && tiles * B > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = BATCHED ? dim3(tiles * B, splits, 1)
                            : dim3(tiles, splits, (B + BMAX - 1) / BMAX);
  bgemv_kernel<T, GATE, BATCHED><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(w), static_cast<const T*>(w2), static_cast<const T*>(x),
      static_cast<const T*>(bias), static_cast<const T*>(res), static_cast<T*>(y),
      static_cast<typename Acc<T>::type*>(ws), tickets, B, K, N, rows, act, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* w, const void* w2, const void* x, const void* bias, const void* res,
             void* y, void* ws, int* tickets, int B, int K, int N, int splits, int rows, int act,
             bool batched, cudaStream_t s) {
#define GO(GATE, BATCHED) \
  run<T, GATE, BATCHED>(w, w2, x, bias, res, y, ws, tickets, B, K, N, splits, rows, act, s)
  if (batched) return w2 ? GO(true, true) : GO(false, true);
  return w2 ? GO(true, false) : GO(false, false);
#undef GO
}

}  // namespace

// One launch.  w2, bias and res may be NULL.  batched: w (and w2) is (B, K,
// N), one a member; else (K, N), broadcast.  K is cut into `splits` slices
// of `rows` rows (a multiple of 32, at most 1024; the last slice may be
// short).  With splits > 1, ws holds (w2 ? 2 : 1) * splits * B * N
// accumulators (float; double for f64) and tickets ceil(N / tile) * (batched
// ? B : ceil(B / 4)) ints, all zero (the kernel leaves them zero).  Returns
// cudaErrorInvalidValue for a plan the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int bgemv_first_launch(int dtype, const void* w, const void* w2, const void* x,
                                  const void* bias, const void* res, void* y, void* ws,
                                  void* tickets, int B, int K, int N, int splits, int rows,
                                  int act, int batched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* tk = static_cast<int*>(tickets);
  if (dtype == DT_F32)
    return dispatch<float>(w, w2, x, bias, res, y, ws, tk, B, K, N, splits, rows, act, batched,
                           s);
  if (dtype == DT_BF16)
    return dispatch<__nv_bfloat16>(w, w2, x, bias, res, y, ws, tk, B, K, N, splits, rows, act,
                                   batched, s);
  if (dtype == DT_F64)
    return dispatch<double>(w, w2, x, bias, res, y, ws, tk, B, K, N, splits, rows, act,
                            batched, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
