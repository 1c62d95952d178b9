// The packed int8 GEMV's first design (csrc/qgemv.cu before its redesign):
// a block of 4 warps owns 4 stored rows and reads x from L1 beside every
// 16-byte weight chunk.  Kept only so that chip_smoke.py can time it beside
// the redesign on the same inputs (its `quant_kernels` phase, `replaced_ms`);
// no path of the port calls it.  chip_smoke.py builds it with
// -I src/repro_torch/csrc into build/replaced/.
//
// Packed int8 GEMV with block scales and a fused epilogue, for Hopper (sm_90a).
//
// Replaces the packed (int8 + block scales) bodies of two Pallas kernels:
//  - `repro/kernels/bgemv.py` (`_bgemv_kernel`, pallas_call at :230; packed
//    body :80-83): the decode projections of `serve --quantize int8`,
//        y[b, i] = epi( sum_k deq(W)[i, k] x[b, k]  [, sum_k deq(W2)[i, k] x[b, k]] )
//    with W the packed weight in its STORED (N, K) layout: output-major,
//    one stored row per output (QuantSpec.transpose folded the op in);
//  - `repro/kernels/gemv.py` (`_gemv_kernel`, pallas_call at :146; packed
//    body :89-90): BLAS gemv with a packed A, batch 1, no epilogue.
// deq(W)[i, k] = W[i, k] * scales[i / qm][k / qn], in the accumulator type
// (max(f32, x's dtype)), as `dequant_tile(..., dtype=acc)`: the weight is
// never rounded to x's dtype.  x (B, K), bias (N,), residual (B, N) and y
// (B, N) are in x's dtype (f32, bf16, or f64 for the BLAS gemv).
//
// Bound: bytes.  At decode batch 4 each weight byte feeds 4 multiply-adds,
// so the time is the weight stream over HBM: 1 byte a weight plus one f32
// scale per block (qkv 2048 x 2048: 4.2 MB, 1.25 us at 3.35 TB/s).
//
// Design against that bound:
//  - the output-major layout makes every output ONE independent dot over a
//    contiguous stored row, so a block owns whole rows (ROWS = 4 of them)
//    and finishes them: no second pass and no workspace (unlike bgemv.cu's
//    column walk).  At N = 2048 that is 512 blocks: even the narrowest
//    projection fills the card;
//  - the block's 4 warps sweep K of its rows together, each lane loading
//    16 int8 values (16 bytes) of every row before any arithmetic, and meet
//    in shared memory at the end: a warp per row or two would leave ~8
//    warps an SM at N = 2048, each with K / 512 dependent load rounds, no
//    faster than the dense bgemv (PERF.md);
//  - each row is read ONCE for up to 4 batch members (4 accumulators a row
//    a lane), and each x chunk, loaded from L1, feeds the block's 4 rows;
//    larger batches run in chunks of 4 (grid.y), re-reading W per chunk;
//  - int8 -> f32 by byte permute + one subtract (exact), not I2F, whose
//    quarter rate would compete with the FMAs at 16 conversions a load;
//  - scales: with one scale block across K (the default (64, K) spec) the
//    row's sum is scaled once at the end; when qn is a multiple of 16 each
//    16-byte chunk lies in one block and its partial sum is scaled; any
//    other case (awkward `_fit_block` blocks, ragged K, unaligned rows or x)
//    takes element loads, each element dequantized at its own block index;
//  - the epilogue (common.cuh) runs in the accumulator type.
// No atomics: each output is summed in one fixed order.
// Later work (not here): TMA bulk loads; int8 activations (W8A8 dp4a/IMMA)
// would change the result and are not the reference's pallas semantics.
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 4;   // stored rows a block owns
constexpr int BMAX = 4;   // batch members a block reads each row for
constexpr int CHUNK = 16; // int8 values in one 16-byte load

// x[k0 .. k0 + 15] of one batch member in the accumulator type, 16-byte loads
template <typename T>
__device__ __forceinline__ void load_x16(const T* __restrict__ p,
                                         typename Acc<T>::type (&f)[CHUNK]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int u = 0; u < CHUNK / V; ++u) {
    typename Acc<T>::type g[V];
    load16(p + u * V, g);
#pragma unroll
    for (int e = 0; e < V; ++e) f[u * V + e] = g[e];
  }
}

struct Rows {  // the block's ROWS rows (clamped to N - 1) and their scale rows
  int row[ROWS], srow[ROWS];
};

// 16-byte loads: chunk c of each of the block's rows for c = tid, tid +
// THREADS, ...; all ROWS loads (x2 under the gate) issued before the math.
// ROW_SCALE: one scale block across K, applied after the sum.
template <typename T, bool GATE, bool ROW_SCALE>
__device__ __forceinline__ void sweep_vec(
    const int8_t* __restrict__ w, const int8_t* __restrict__ w2, const float* __restrict__ s,
    const float* __restrict__ s2, const T* __restrict__ x, int K, int nb, int sn, int qn,
    const Rows& rw, typename Acc<T>::type (&acc)[ROWS][BMAX],
    typename Acc<T>::type (&acc2)[ROWS][BMAX]) {
  using A = typename Acc<T>::type;
  const int chunks = K / CHUNK;
  const int per_block = qn / CHUNK;  // chunks per scale block (ROW_SCALE: unused)
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    uint4 raw[ROWS], raw2[GATE ? ROWS : 1];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long off = (long)rw.row[r] * K + (long)c * CHUNK;
      raw[r] = __ldg(reinterpret_cast<const uint4*>(w + off));
      if constexpr (GATE) raw2[r] = __ldg(reinterpret_cast<const uint4*>(w2 + off));
    }
    const int blk = ROW_SCALE ? 0 : c / per_block;
#pragma unroll
    for (int half = 0; half < (GATE ? 2 : 1); ++half) {  // W, then the gate's W2
      const uint4* rr = half ? raw2 : raw;
      float f[ROWS][CHUNK];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) unpack_i8(rr[r], f[r]);
      A(&out)[ROWS][BMAX] = half ? acc2 : acc;
#pragma unroll
      for (int b = 0; b < BMAX; ++b) {
        if (b >= nb) break;
        A xv[CHUNK];
        load_x16<T>(x + (long)b * K + (long)c * CHUNK, xv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          A q = 0;
#pragma unroll
          for (int e = 0; e < CHUNK; ++e) q += static_cast<A>(f[r][e]) * xv[e];
          if constexpr (ROW_SCALE) {
            out[r][b] += q;
          } else {
            const float* sc = half ? s2 : s;
            out[r][b] += static_cast<A>(sc[rw.srow[r] * sn + blk]) * q;
          }
        }
      }
    }
  }
}

// Element loads, each element dequantized at its own block index: ragged K,
// unaligned rows or x, awkward blocks.
template <typename T, bool GATE>
__device__ __forceinline__ void sweep_scalar(
    const int8_t* __restrict__ w, const int8_t* __restrict__ w2, const float* __restrict__ s,
    const float* __restrict__ s2, const T* __restrict__ x, int K, int nb, int sn, int qn,
    const Rows& rw, typename Acc<T>::type (&acc)[ROWS][BMAX],
    typename Acc<T>::type (&acc2)[ROWS][BMAX]) {
  using A = typename Acc<T>::type;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const int blk = k / qn;
    A xb[BMAX];
#pragma unroll
    for (int b = 0; b < BMAX; ++b) xb[b] = b < nb ? to_f(x[(long)b * K + k]) : A(0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long off = (long)rw.row[r] * K + k;
      const A wv = static_cast<A>(w[off]) * static_cast<A>(s[rw.srow[r] * sn + blk]);
      A wv2 = 0;
      if constexpr (GATE)
        wv2 = static_cast<A>(w2[off]) * static_cast<A>(s2[rw.srow[r] * sn + blk]);
#pragma unroll
      for (int b = 0; b < BMAX; ++b) {
        acc[r][b] += wv * xb[b];
        if constexpr (GATE) acc2[r][b] += wv2 * xb[b];
      }
    }
  }
}

// grid (ceil(N / ROWS), batch chunks of BMAX); the block's 4 warps sweep K of
// its ROWS rows together and meet in shared memory.  mode: 0 element loads,
// 1 16-byte loads with per-chunk scales, 2 16-byte loads, one scale a row.
template <typename T, bool GATE>
__global__ void __launch_bounds__(THREADS)
qgemv_kernel(const int8_t* __restrict__ w, const float* __restrict__ s,
             const int8_t* __restrict__ w2, const float* __restrict__ s2,
             const T* __restrict__ x, const T* __restrict__ bias, const T* __restrict__ res,
             T* __restrict__ y, int B, int K, int N, int qm, int qn, int mode, int act) {
  using A = typename Acc<T>::type;
  __shared__ A red[GATE ? 2 : 1][WARPS][ROWS * BMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * ROWS;
  const int b0 = blockIdx.y * BMAX, nb = min(BMAX, B - b0);
  const int sn = K / qn;
  const T* xb = x + (long)b0 * K;
  Rows rw;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rw.row[r] = min(first + r, N - 1);  // a ragged last block repeats row N-1, stores once
    rw.srow[r] = rw.row[r] / qm;
  }
  A acc[ROWS][BMAX], acc2[ROWS][BMAX];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < BMAX; ++b) acc[r][b] = acc2[r][b] = 0;

  if (mode == 2)
    sweep_vec<T, GATE, true>(w, w2, s, s2, xb, K, nb, sn, qn, rw, acc, acc2);
  else if (mode == 1)
    sweep_vec<T, GATE, false>(w, w2, s, s2, xb, K, nb, sn, qn, rw, acc, acc2);
  else
    sweep_scalar<T, GATE>(w, w2, s, s2, xb, K, nb, sn, qn, rw, acc, acc2);

  // each warp's sums, then the 4 warps' in a fixed order
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < BMAX; ++b) {
      const A v = warp_sum(acc[r][b]);
      if (lane == 0) red[0][warp][r * BMAX + b] = v;
      if constexpr (GATE) {
        const A v2 = warp_sum(acc2[r][b]);
        if (lane == 0) red[1][warp][r * BMAX + b] = v2;
      }
    }
  __syncthreads();
  const int t = threadIdx.x, r = t / BMAX, b = t % BMAX;
  if (t < ROWS * BMAX && b < nb && first + r < N) {
    A v = 0, v2 = 0;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
      v += red[0][q][t];
      if constexpr (GATE) v2 += red[1][q][t];
    }
    if (mode == 2) {  // the row's one scale (sn == 1)
      v *= static_cast<A>(s[rw.srow[r]]);
      if constexpr (GATE) v2 *= static_cast<A>(s2[rw.srow[r]]);
    }
    const int row = first + r;
    const long o = (long)(b0 + b) * N + row;
    y[o] = from_f<T>(epilogue<T>(v, v2, bias, res, row, o, act, GATE));
  }
}

template <typename T>
int run(const void* w, const void* s, const void* w2, const void* s2, const void* x,
        const void* bias, const void* res, void* y, int B, int K, int N, int qm, int qn,
        int act, cudaStream_t st) {
  const int8_t* wt = static_cast<const int8_t*>(w);
  const int8_t* w2t = static_cast<const int8_t*>(w2);
  const T* xt = static_cast<const T*>(x);
  const bool vec = K % CHUNK == 0 && aligned16(wt) && (!w2t || aligned16(w2t)) &&
                   aligned16(xt) && ((long)K * sizeof(T)) % 16 == 0;
  const int mode = !vec || qn % CHUNK ? 0 : (qn == K ? 2 : 1);
  const dim3 grid((N + ROWS - 1) / ROWS, (B + BMAX - 1) / BMAX);
  const float* sf = static_cast<const float*>(s);
  const float* s2f = static_cast<const float*>(s2);
  const T* bt = static_cast<const T*>(bias);
  const T* rt_ = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  if (w2)
    qgemv_kernel<T, true><<<grid, THREADS, 0, st>>>(wt, sf, w2t, s2f, xt, bt, rt_, yt, B, K, N,
                                                    qm, qn, mode, act);
  else
    qgemv_kernel<T, false><<<grid, THREADS, 0, st>>>(wt, sf, w2t, s2f, xt, bt, rt_, yt, B, K,
                                                     N, qm, qn, mode, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (B, N) = epi(deq(W) x [, deq(W2) x]) with W, W2 (N, K) int8 and their
// scales (N / qm, K / qn) f32.  w2/s2, bias and res may be NULL.  Returns
// cudaGetLastError() after the launch.
extern "C" int qgemv_rows4_launch(int dtype, const void* w, const void* s, const void* w2,
                            const void* s2, const void* x, const void* bias, const void* res,
                            void* y, int B, int K, int N, int qm, int qn, int act,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qm < 1 || qn < 1 || N % qm || K % qn) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) return run<float>(w, s, w2, s2, x, bias, res, y, B, K, N, qm, qn, act, st);
  if (dtype == DT_BF16)
    return run<__nv_bfloat16>(w, s, w2, s2, x, bias, res, y, B, K, N, qm, qn, act, st);
  if (dtype == DT_F64)
    return run<double>(w, s, w2, s2, x, bias, res, y, B, K, N, qm, qn, act, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
