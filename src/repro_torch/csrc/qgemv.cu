// Packed int8 GEMV with block scales and a fused epilogue, one launch a
// call, for Hopper (sm_90a).
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
// scale per block (qkv 2048 x 2048: 4.2 MB, 1.25 us at 3.35 TB/s), and at
// the served shapes (4-23 MB) the latency of getting that stream started.
// On the CUDA cores the work per weight byte is not small either: an exact
// int8 -> float (a byte permute and an add) and 4 FMAs, ~6 issue slots a
// byte, within 2x of what the card can issue at HBM speed.
//
// Two bodies; `kernels/bgemv.py::plan_int8` picks the body (`tc`) and the
// K split:
//  - the tensor-core body (bf16 x under one scale a row: every served
//    decode projection) takes the FMAs to mma.sync: the int8 values and
//    bf16 x are exact operands, the products exact in f32 (its note below);
//  - the CUDA-core body (f32 and f64 x, per-chunk scales, awkward blocks,
//    ragged K): a warp streams 4 stored weight rows at once (4 rows, or 2
//    rows and their gate rows), each lane one 16-byte load (16 int8) of
//    each row a step, 512 columns a warp-step; a block's 8 warps own 32
//    weight rows (the first design's block owned 4) and stage their batch
//    chunk's slice of x ONCE in shared memory, in the accumulator type
//    (XU 16-byte loads a thread in flight), every lane reading each x value
//    once a step for all 4 of its rows: x costs 8 / 32 bytes of global
//    reads per weight byte at batch 4 (the first design read x from L1
//    beside every 16-byte weight chunk, 2 bytes per weight byte); a lane
//    keeps two steps of loads in flight and refills each as soon as it is
//    used, the first two issued before x is staged; a warp reduces its
//    sums by a halving butterfly (16 shuffles for 16 sums, not 16 trees of
//    5); at batch 1 a lane keeps one batch member's sums (NB = 1);
//  - both: K is cut into `splits` slices of `cols` columns (a multiple of
//    16) when the row groups alone would leave the card idle or x would not
//    fit in shared memory (f64 x at K = 16384 is 128 KB); each block writes
//    its partials to a workspace and the last block of a row group (an int
//    ticket after __threadfence, as bgemv.cu) sums the splits in split
//    order, scales, applies the epilogue and resets the ticket.  No
//    floating-point atomics: a row's bits depend on the plan (the shape)
//    alone, and two launches give the same bits;
//  - int8 -> float by byte permute (exact, vec.cuh), not I2F; into double
//    with the byte in the mantissa of 2^52, not F2F.F64.F32;
//  - scales, the CUDA-core template's MODE: 2, one scale block across K
//    (the serving spec): each row's sum is scaled once at the end; 1, qn a
//    multiple of 16: each 16-column chunk lies in one block and its partial
//    is scaled; 0, anything else (awkward `_fit_block` blocks, ragged K,
//    unaligned rows): element loads, each element dequantized at its own
//    block index;
//  - the epilogue (common.cuh) runs in the accumulator type.
#include "mma.cuh"
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = 4;             // weight rows a warp streams (rows x NACC)
constexpr int BMAX = 4;              // batch members a block
constexpr int CHUNK = 16;            // int8 values in one 16-byte load
constexpr int STEP = 32 * CHUNK;     // columns a warp takes a step
constexpr int MAX_X_BYTES = 64 * 1024;  // x's slice in shared memory (kernels/bgemv.py)
constexpr int XU = 4;                   // x's 16-byte loads a thread issues together

// columns of a 16-byte chunk taken at once against x held in registers
template <typename A> struct Sub { static constexpr int N = 8; };
template <> struct Sub<double> { static constexpr int N = 4; };

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Sub<A>::N consecutive x values from shared memory, two 16-byte reads
__device__ __forceinline__ void lds_sub(const float* p, float (&f)[8]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0], v = reinterpret_cast<const float4*>(p)[1];
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
}
__device__ __forceinline__ void lds_sub(const double* p, double (&f)[4]) {
  const double2 u = reinterpret_cast<const double2*>(p)[0],
                v = reinterpret_cast<const double2*>(p)[1];
  f[0] = u.x; f[1] = u.y; f[2] = v.x; f[3] = v.y;
}

// one 16-byte load of x, unpacked, into shared memory by 16-byte stores
template <int V>
__device__ __forceinline__ void sts_x(float* p, const float (&g)[V]) {
#pragma unroll
  for (int e = 0; e < V; e += 4)
    *reinterpret_cast<float4*>(p + e) = make_float4(g[e], g[e + 1], g[e + 2], g[e + 3]);
}
__device__ __forceinline__ void sts_x(double* p, const double (&g)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(g[0], g[1]);
}

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// one halving stage of warp_reduce: lanes with bit 2 * HALF set keep the
// upper half of v[0 .. 2 * HALF), the others the lower, each adding its
// partner's copy of the half it keeps
template <int HALF, int NV, typename A>
__device__ __forceinline__ void halve(A (&v)[NV], int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = lane & (2 * HALF);
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const A send = upper ? v[j] : v[j + HALF];
      const A keep = upper ? v[j + HALF] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
    }
    halve<HALF / 2>(v, lane);
  }
}

// sums v[0..NV) (NV = 4 or 16) over the warp by halving: lane l ends with
// the total of v[(l >> 1) % NV] (lanes 2j and 2j + 1 both; with NV = 4 every
// lane group of 8); a fixed order for every lane
template <int NV, typename A>
__device__ __forceinline__ A warp_reduce(A (&v)[NV], int lane) {
  halve<NV / 2>(v, lane);
  A t = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
#pragma unroll
  for (int m = 2 * NV; m < 32; m *= 2) t += __shfl_xor_sync(0xffffffffu, t, m);
  return t;
}

// grid (row groups of 32 / NACC rows, splits, batch chunks of BMAX); NB, the
// batch members a lane accumulates: 4, or 1 for a batch of one (the BLAS
// gemv), which keeps the registers of f64 x to two blocks an SM
template <typename T, bool GATE, int MODE, int NB>
__global__ void __launch_bounds__(THREADS, sizeof(typename Acc<T>::type) == 8 && NB == 4 ? 1 : 2)
qgemv_kernel(const int8_t* __restrict__ w, const float* __restrict__ s,
             const int8_t* __restrict__ w2, const float* __restrict__ s2,
             const T* __restrict__ x, const T* __restrict__ bias, const T* __restrict__ res,
             T* __restrict__ y, typename Acc<T>::type* __restrict__ ws,
             int* __restrict__ tickets, int B, int K, int N, int qm, int qn, int cols,
             int act, bool xvec) {
  using A = typename Acc<T>::type;
  constexpr int NACC = GATE ? 2 : 1;
  constexpr int R = WROWS / NACC;  // rows a warp
  constexpr int BR = WARPS * R;    // rows a block
  constexpr int SUB = Sub<A>::N;
  extern __shared__ float4 smem[];
  A* xs = reinterpret_cast<A*>(smem);  // x[b0 + b][k0 + c] at b * cols + c
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y, splits = gridDim.y;
  const int b0 = blockIdx.z * BMAX, nb = min(BMAX, B - b0);
  const int k0 = split * cols, len = min(K, k0 + cols) - k0;
  const int first = blockIdx.x * BR + warp * R;  // the warp's first row
  const int sn = K / qn;
  int row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) row[r] = min(first + r, N - 1);  // ragged: repeat row N-1
  const int8_t* wp[NACC] = {w};
  const float* sp[NACC] = {s};
  if constexpr (GATE) {
    wp[1] = w2;
    sp[1] = s2;
  }

  // 16-byte loads of step st (columns st * STEP + lane * 16 of the slice) of
  // the warp's rows; past the slice, zeros
  const int steps = (len + STEP - 1) / STEP;
  using Batch = uint4[NACC][R];
  auto load = [&](int st, Batch& raw) {
    const int c = st * STEP + lane * CHUNK;
    const bool live = c < len;
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int r = 0; r < R; ++r)
        raw[a][r] = live ? __ldg(reinterpret_cast<const uint4*>(wp[a] + (long)row[r] * K + k0 + c))
                         : make_uint4(0, 0, 0, 0);
  };
  Batch ra, rb;
  if constexpr (MODE != 0) {  // two steps in flight while x is staged
    load(0, ra);
    load(1, rb);
  }

  // x[b0 + b][k0 + i] -> xs[b * cols + i]: 16-byte loads, XU of them issued
  // before their stores, where every row of the slice starts on 16 bytes
  if (xvec) {
    constexpr int V = Vec<T>::N;
    const int per_b = len / V, nvec = nb * per_b;
    for (int q0 = tid; q0 < nvec; q0 += XU * THREADS) {
      uint4 xr[XU];
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int q = q0 + u * THREADS, b = q / per_b;
        if (q < nvec)
          xr[u] = __ldg(reinterpret_cast<const uint4*>(x + (long)(b0 + b) * K + k0 +
                                                       (q - b * per_b) * V));
      }
#pragma unroll
      for (int u = 0; u < XU; ++u) {
        const int q = q0 + u * THREADS, b = q / per_b;
        if (q < nvec) {
          A g[V];
          Vec<T>::unpack(xr[u], g);
          sts_x(xs + b * cols + (q - b * per_b) * V, g);
        }
      }
    }
  } else {
    for (int b = 0; b < nb; ++b)
      for (int i = tid; i < len; i += THREADS)
        xs[b * cols + i] = to_f(x[(long)(b0 + b) * K + k0 + i]);
  }
  __syncthreads();

  A acc[NACC][R][NB];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[a][r][b] = 0;

  if constexpr (MODE != 0) {
    int srow[R];
#pragma unroll
    for (int r = 0; r < R; ++r) srow[r] = row[r] / qm;
    auto consume = [&](int st, const Batch& raw) {
      const int c = st * STEP + lane * CHUNK;
      if (c >= len) return;
      // the 16 columns' products into d: acc itself (MODE 2), or this
      // chunk's sums, scaled once (MODE 1)
      auto madd = [&](A (&d)[NACC][R][NB]) {
#pragma unroll
        for (int h = 0; h < CHUNK / SUB; ++h) {
          A xv[NB][SUB];
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < nb) lds_sub(xs + b * cols + c + h * SUB, xv[b]);
#pragma unroll
          for (int a = 0; a < NACC; ++a)
#pragma unroll
            for (int r = 0; r < R; ++r) {
              A f[SUB];
#pragma unroll
              for (int u = 0; u < SUB / 4; ++u) {
                A g[4];
                unpack_i8x4(word(raw[a][r], h * SUB / 4 + u), g);
#pragma unroll
                for (int e = 0; e < 4; ++e) f[u * 4 + e] = g[e];
              }
#pragma unroll
              for (int b = 0; b < NB; ++b)
                if (b < nb) {
#pragma unroll
                  for (int e = 0; e < SUB; ++e) d[a][r][b] = fma_(f[e], xv[b][e], d[a][r][b]);
                }
            }
        }
      };
      if constexpr (MODE == 2) madd(acc);
      if constexpr (MODE == 1) {
        A part[NACC][R][NB];
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int b = 0; b < NB; ++b) part[a][r][b] = 0;
        madd(part);
        const int blk = (k0 + c) / qn;
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const A sc = static_cast<A>(sp[a][srow[r] * sn + blk]);
#pragma unroll
            for (int b = 0; b < NB; ++b) acc[a][r][b] = fma_(sc, part[a][r][b], acc[a][r][b]);
          }
      }
    };
    for (int st = 0; st < steps; st += 2) {  // each batch refilled as soon as it is used
      consume(st, ra);
      if (st + 2 < steps) load(st + 2, ra);
      if (st + 1 < steps) consume(st + 1, rb);
      if (st + 3 < steps) load(st + 3, rb);
    }
  } else {  // element loads, each element dequantized at its own block index
    for (int c = lane; c < len; c += 32) {
      const int blk = (k0 + c) / qn;
      A xb[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) xb[b] = b < nb ? xs[b * cols + c] : A(0);
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const A wv = static_cast<A>(wp[a][(long)row[r] * K + k0 + c]) *
                       static_cast<A>(sp[a][(row[r] / qm) * sn + blk]);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[a][r][b] = fma_(wv, xb[b], acc[a][r][b]);
        }
    }
  }

  // the warp's NACC * R * NB sums (index (a * R + r) * NB + b), lane 2j
  // ending with j
  constexpr int NV = NACC * R * NB;
  A vs[NV];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < NB; ++b) vs[(a * R + r) * NB + b] = acc[a][r][b];
  const A v = warp_reduce<NV>(vs, lane);
  const int j = (lane >> 1) % NV, a_ = j / (R * NB), r_ = (j / NB) % R, b_ = j % NB;
  const int row_ = first + r_;
  const bool mine = lane < 2 * NV && !(lane & 1) && b_ < nb && row_ < N;  // sum j, real
  const long o = (long)(b0 + b_) * N + row_;

  if (splits == 1) {
    const A v2 = GATE ? __shfl_down_sync(0xffffffffu, v, 2 * R * NB) : A(0);  // the gate's
    if (mine && a_ == 0) {
      A h = v, h2 = v2;
      if constexpr (MODE == 2) {  // the row's one scale (sn == 1)
        h *= static_cast<A>(s[row_ / qm]);
        if constexpr (GATE) h2 *= static_cast<A>(s2[row_ / qm]);
      }
      y[o] = from_f<T>(epilogue<T>(h, h2, bias, res, row_, o, act, GATE));
    }
    return;
  }

  // ws is [NACC][splits][B][N]: this split's partials, then the ticket
  const long plane = (long)B * N;
  if (mine) ws[(long)(a_ * splits + split) * plane + o] = v;
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *ticket = 0;
  // the block's outputs, one a thread: rows blockIdx.x * BR + t / BMAX
  const int t_row = blockIdx.x * BR + tid / BMAX, t_b = tid % BMAX;
  if (tid >= BR * BMAX || t_b >= nb || t_row >= N) return;
  const long ot = (long)(b0 + t_b) * N + t_row;
  A t[2] = {0, 0};  // the splits' partials, summed in split order
  for (int k = 0; k < splits; ++k)
#pragma unroll
    for (int a = 0; a < NACC; ++a) t[a] += __ldcg(ws + (long)(a * splits + k) * plane + ot);
  if constexpr (MODE == 2) {
    t[0] *= static_cast<A>(s[t_row / qm]);
    if constexpr (GATE) t[1] *= static_cast<A>(s2[t_row / qm]);
  }
  y[ot] = from_f<T>(epilogue<T>(t[0], t[1], bias, res, t_row, ot, act, GATE));
}

// ---------------------------------------------------------------------------
// The tensor-core body: bf16 x, one scale a row (the serving spec).  int8
// values are exact in bf16 and a bf16 x bf16 product is exact in f32, so
// mma.sync m16n8k16 (f32 accumulate) sums the raw rows in f32 as the
// CUDA-core body does, and the row's scale is applied once after the sum.
// A block owns 16 rows and its WARPS warps (8, or 4 where the row groups
// outnumber the SMs: the plan's) cut the block's K slice (an intra-block
// split, summed through shared memory in warp order): the 16 rows of
// N = 2048 make 128 blocks, one an SM, with every load of a row group in
// flight at once and no cross-block combine.  (64 rows a block with x
// staged in shared memory and K split across blocks ran slower: PERF.md.)  Lane (g, q) = (lane
// / 4, lane % 4) loads 16 bytes of rows g and g + 8 at columns 16 q and
// 64 + 16 q of each 128-column step, and x[batch g] at the same columns
// (read through L1, no staging: x costs 8 / 16 bytes of L2 reads a weight
// byte at batch 4, 8 / 32 with the gate).  The dot product's k order inside
// 64 columns is permuted (mma k 2q + h + 8e <-> column 16 q + 4 j + 2 e + h
// for the j-th mma), identically for W and x, so each lane's fragments come
// straight from its own loads.  Per weight byte: a byte permute, an add and
// half a permute (exact int8 -> bf16), against the CUDA-core body's 2 ops
// and 4 FMAs at batch 4.

constexpr int TC_ROWS = 16;   // rows a block (kernels/bgemv.py)
constexpr int TC_STEP = 128;  // columns a warp-step: 2 x (4 lanes x 16 int8)
constexpr int TC_UNIT = 64;   // a warp's share of the block's slice is a multiple of this

// 4 int8 values (a word) -> bf16 pairs (bytes 0, 1) and (2, 3), exactly:
// unpack_i8x4's floats are small integers, whose bf16 is their high half
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  unpack_i8x4(w, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// grid (row groups of TC_ROWS, splits, batch chunks of BMAX); WARPS (4 or
// 8, the plan's) share the block's K slice
template <bool GATE, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
qgemv_tc_kernel(const int8_t* __restrict__ w, const float* __restrict__ s,
                const int8_t* __restrict__ w2, const float* __restrict__ s2,
                const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ y,
                float* __restrict__ ws, int* __restrict__ tickets, int B, int K, int N, int qm,
                int cols, int act, bool xvec) {
  constexpr int NACC = GATE ? 2 : 1;
  __shared__ float red[NACC][WARPS][4][32];  // each warp's C fragments
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int b0 = blockIdx.z * BMAX, nb = min(BMAX, B - b0);
  const int k0 = split * cols, len = min(K, k0 + cols) - k0;
  // the warp's columns [wb, we) of the slice, whole 64-column units
  const int share = (len + WARPS * TC_UNIT - 1) / (WARPS * TC_UNIT) * TC_UNIT;
  const int wb = min(len, warp * share), we = min(len, wb + share);
  const int steps = (we - wb + TC_STEP - 1) / TC_STEP;
  const int first = blockIdx.x * TC_ROWS;
  const long rg = (long)min(first + g, N - 1) * K + k0 + wb;  // rows g, g + 8 (ragged: N - 1)
  const long rg8 = (long)min(first + g + 8, N - 1) * K + k0 + wb;
  const __nv_bfloat16* xg = x + (long)(b0 + min(g, nb - 1)) * K + k0 + wb;  // x[batch g]
  const int8_t* wp[NACC] = {w};
  if constexpr (GATE) wp[1] = w2;

  // a step's loads: W rows g, g + 8 and x[g] at columns c_h = st * 128 +
  // 64 h + 16 q (h = 0, 1) of the warp's share; past it, zeros
  struct Batch {
    uint4 w[NACC][2][2];  // [a][row g, g + 8][h]
    uint4 x[2][2];        // [h][columns c_h .. + 7, c_h + 8 .. + 15]
  };
  auto load = [&](int st, Batch& bt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = st * TC_STEP + h * TC_UNIT + q * CHUNK;
      const bool live = wb + c < we;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        bt.w[a][0][h] = live ? __ldg(reinterpret_cast<const uint4*>(wp[a] + rg + c))
                             : make_uint4(0, 0, 0, 0);
        bt.w[a][1][h] = live ? __ldg(reinterpret_cast<const uint4*>(wp[a] + rg8 + c))
                             : make_uint4(0, 0, 0, 0);
      }
      if (live && g < nb && xvec) {
        bt.x[h][0] = __ldg(reinterpret_cast<const uint4*>(xg + c));
        bt.x[h][1] = __ldg(reinterpret_cast<const uint4*>(xg + c + 8));
      } else {  // element loads (x off 16 bytes), or zeros
        uint32_t e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool on = live && g < nb;
          const uint32_t lo = on ? __bfloat16_as_ushort(xg[c + 2 * i]) : 0u;
          const uint32_t hi = on ? __bfloat16_as_ushort(xg[c + 2 * i + 1]) : 0u;
          e[i] = lo | hi << 16;
        }
        bt.x[h][0] = make_uint4(e[0], e[1], e[2], e[3]);
        bt.x[h][1] = make_uint4(e[4], e[5], e[6], e[7]);
      }
    }
  };
  float acc[NACC][4] = {};
  auto consume = [&](const Batch& bt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t xw[8] = {bt.x[h][0].x, bt.x[h][0].y, bt.x[h][0].z, bt.x[h][0].w,
                              bt.x[h][1].x, bt.x[h][1].y, bt.x[h][1].z, bt.x[h][1].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          uint32_t af[4];
          i8x4_to_bf16x2(word(bt.w[a][0][h], j), af[0], af[2]);
          i8x4_to_bf16x2(word(bt.w[a][1][h], j), af[1], af[3]);
          mma_bf16(acc[a], af, xw[2 * j], xw[2 * j + 1]);
        }
    }
  };
  Batch ba, bb;  // two steps in flight, each refilled as soon as it is used
  load(0, ba);
  load(1, bb);
  for (int st = 0; st < steps; st += 2) {
    consume(ba);
    if (st + 2 < steps) load(st + 2, ba);
    if (st + 1 < steps) consume(bb);
    if (st + 3 < steps) load(st + 3, bb);
  }

  // the 8 warps' fragments, summed in warp order: acc[a][i] holds row
  // first + g + 8 (i >> 1), batch member 2 q + (i & 1)
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[a][warp][i][lane] = acc[a][i];
  __syncthreads();
  const int orow = tid / BMAX, ob = tid % BMAX;  // this thread's output (row first + orow, ob)
  const int row = first + orow;
  const bool mine = tid < TC_ROWS * BMAX && ob < nb && row < N;
  const int src_lane = 4 * (orow % 8) + ob / 2, src_i = 2 * (orow / 8) + (ob & 1);
  float sum[2] = {0.f, 0.f};
  if (mine) {
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) sum[a] += red[a][wi][src_i][src_lane];
  }
  const long o = (long)(b0 + ob) * N + row;
  if (splits == 1) {
    if (mine) {
      const float h = sum[0] * s[row / qm], h2 = GATE ? sum[1] * s2[row / qm] : 0.f;
      y[o] = from_f<__nv_bfloat16>(epilogue<__nv_bfloat16>(h, h2, bias, res, row, o, act, GATE));
    }
    return;
  }
  // ws is [NACC][splits][B][N]: this split's partials, then the ticket
  const long plane = (long)B * N;
  if (mine) {
#pragma unroll
    for (int a = 0; a < NACC; ++a) ws[(long)(a * splits + split) * plane + o] = sum[a];
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *ticket = 0;
  if (!mine) return;
  float t[2] = {0.f, 0.f};  // the splits' partials, summed in split order
  for (int k = 0; k < splits; ++k)
#pragma unroll
    for (int a = 0; a < NACC; ++a) t[a] += __ldcg(ws + (long)(a * splits + k) * plane + o);
  const float h = t[0] * s[row / qm], h2 = GATE ? t[1] * s2[row / qm] : 0.f;
  y[o] = from_f<__nv_bfloat16>(epilogue<__nv_bfloat16>(h, h2, bias, res, row, o, act, GATE));
}

// ---------------------------------------------------------------------------

template <typename T, bool GATE, int MODE, int NB>
int launch(const int8_t* w, const float* s, const int8_t* w2, const float* s2, const T* x,
           const T* bias, const T* res, T* y, void* ws, int* tickets, int B, int K, int N,
           int qm, int qn, int splits, int cols, int act, bool xvec, cudaStream_t st) {
  using A = typename Acc<T>::type;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(qgemv_kernel<T, GATE, MODE, NB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 MAX_X_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  constexpr int BR = WARPS * WROWS / (GATE ? 2 : 1);
  const dim3 grid((N + BR - 1) / BR, splits, (B + BMAX - 1) / BMAX);
  const int smem = min(B, BMAX) * cols * static_cast<int>(sizeof(A));
  qgemv_kernel<T, GATE, MODE, NB><<<grid, THREADS, smem, st>>>(
      w, s, w2, s2, x, bias, res, y, static_cast<A*>(ws), tickets, B, K, N, qm, qn, cols, act,
      xvec);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATE, int WARPS>
int launch_tc(const int8_t* w, const float* s, const int8_t* w2, const float* s2,
              const __nv_bfloat16* x, const __nv_bfloat16* bias, const __nv_bfloat16* res,
              __nv_bfloat16* y, float* ws, int* tickets, int B, int K, int N, int qm, int splits,
              int cols, int act, bool xvec, cudaStream_t st) {
  const dim3 grid((N + TC_ROWS - 1) / TC_ROWS, splits, (B + BMAX - 1) / BMAX);
  qgemv_tc_kernel<GATE, WARPS><<<grid, WARPS * 32, 0, st>>>(w, s, w2, s2, x, bias, res, y, ws,
                                                            tickets, B, K, N, qm, cols, act,
                                                            xvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* w, const void* s, const void* w2, const void* s2, const void* x,
        const void* bias, const void* res, void* y, void* ws, int* tickets, int B, int K, int N,
        int qm, int qn, int splits, int cols, int act, int tc, cudaStream_t st) {
  using A = typename Acc<T>::type;
  const int8_t* wt = static_cast<const int8_t*>(w);
  const int8_t* w2t = static_cast<const int8_t*>(w2);
  const T* xt = static_cast<const T*>(x);
  if (splits < 1 || cols < 1 || (long)splits * cols < K || (long)(splits - 1) * cols >= K ||
      (splits > 1 && (cols % CHUNK || !ws || !tickets)) ||
      (!tc && (long)min(B, BMAX) * cols * (long)sizeof(A) > MAX_X_BYTES))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % CHUNK == 0 && aligned16(wt) && (!w2t || aligned16(w2t));
  const int mode = !vec || qn % CHUNK ? 0 : (qn == K ? 2 : 1);
  // x staged by 16-byte loads where every row of its slice starts on 16 bytes
  const bool xvec = vec && aligned16(xt) && ((long)K * sizeof(T)) % 16 == 0 &&
                    ((long)cols * sizeof(T)) % 16 == 0;
  const float* sf = static_cast<const float*>(s);
  const float* s2f = static_cast<const float*>(s2);
  const T* bt = static_cast<const T*>(bias);
  const T* rt_ = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  if (tc) {  // the plan's route: bf16 x, one scale a row, 16-byte rows; tc warps a block
    if constexpr (sizeof(T) == 2) {
      if (mode != 2 || (tc != 4 && tc != 8)) return static_cast<int>(cudaErrorInvalidValue);
      float* wsf = static_cast<float*>(ws);
#define QGEMV_TC(G, W)                                                                    \
  return launch_tc<G, W>(wt, sf, w2t, s2f, xt, bt, rt_, yt, wsf, tickets, B, K, N, qm, splits, \
                         cols, act, xvec, st)
      if (w2) {
        if (tc == 4) QGEMV_TC(true, 4);
        QGEMV_TC(true, 8);
      }
      if (tc == 4) QGEMV_TC(false, 4);
      QGEMV_TC(false, 8);
#undef QGEMV_TC
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define QGEMV_LAUNCH(G, M, NB)                                                                \
  return launch<T, G, M, NB>(wt, sf, w2t, s2f, xt, bt, rt_, yt, ws, tickets, B, K, N, qm, qn, \
                             splits, cols, act, xvec, st)
  if (w2) {
    if (mode == 2) QGEMV_LAUNCH(true, 2, 4);
    if (mode == 1) QGEMV_LAUNCH(true, 1, 4);
    QGEMV_LAUNCH(true, 0, 4);
  }
  if (B == 1) {
    if (mode == 2) QGEMV_LAUNCH(false, 2, 1);
    if (mode == 1) QGEMV_LAUNCH(false, 1, 1);
    QGEMV_LAUNCH(false, 0, 1);
  }
  if (mode == 2) QGEMV_LAUNCH(false, 2, 4);
  if (mode == 1) QGEMV_LAUNCH(false, 1, 4);
  QGEMV_LAUNCH(false, 0, 4);
#undef QGEMV_LAUNCH
}

}  // namespace

// One launch.  y (B, N) = epi(deq(W) x [, deq(W2) x]) with W, W2 (N, K) int8
// and their scales (N / qm, K / qn) f32; w2/s2, bias and res may be NULL.
// `tc` picks the tensor-core body with tc (4 or 8) warps a block (bf16 x,
// qn == K, K % 16 == 0, 16-byte rows; rows = 16 a block), 0 the CUDA-core
// one (rows = 32, 16 with w2).
// K is cut into `splits` slices of `cols` columns (a multiple of 16 when
// splits > 1; the last slice may be short; x's slice at most 64 KB of
// shared memory: min(B, 4) * cols accumulators; the tensor-core body stages
// none).  With splits > 1, ws holds (w2 ? 2 : 1) * splits * B * N
// accumulators (f32, f64 for f64 x) and tickets ceil(N / rows) * ceil(B / 4)
// ints, all zero (the kernel leaves them zero).  Returns
// cudaErrorInvalidValue for a plan the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int qgemv_launch(int dtype, const void* w, const void* s, const void* w2,
                            const void* s2, const void* x, const void* bias, const void* res,
                            void* y, void* ws, void* tickets, int B, int K, int N, int qm, int qn,
                            int splits, int cols, int act, int tc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tk = static_cast<int*>(tickets);
  if (qm < 1 || qn < 1 || N % qm || K % qn) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return run<float>(w, s, w2, s2, x, bias, res, y, ws, tk, B, K, N, qm, qn, splits, cols, act,
                      tc, st);
  if (dtype == DT_BF16)
    return run<__nv_bfloat16>(w, s, w2, s2, x, bias, res, y, ws, tk, B, K, N, qm, qn, splits,
                              cols, act, tc, st);
  if (dtype == DT_F64)
    return run<double>(w, s, w2, s2, x, bias, res, y, ws, tk, B, K, N, qm, qn, splits, cols,
                       act, tc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
