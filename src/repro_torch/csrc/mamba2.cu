// Chunked Mamba2 SSD (scalar decay per head and step) for Hopper (sm_90a),
// parallel across chunks.
//
// Replaces the Pallas kernel `repro/kernels/mamba2.py` (`_ssd_kernel`, call
// at :84) with the contract of the model's `ssd_chunked`
// (`repro/models/mamba.py:23`): an optional initial state in, the final
// state out.  For each row r of BH = batch * heads:
//
//     H_t = exp(a_t) H_{t-1} + b_t x_t^T          (a_t <= 0 log-decay)
//     y_t = c_t^T H_t
//
//     x (BH, T, P), a (BH, T) f32, b, c (BH, T, N), h0 (BH, N, P) f32 or NULL
//     -> y (BH, T, P) in x's dtype, h_fin (BH, N, P) f32
//
// x/b/c/y are f32 or bf16; a and the state are f32, and every sum is f32
// but L's.  Time is cut into chunks of C rows; rows past T are staged as
// a = 0, x = b = c = 0, which leave the state exact, and only live rows of y
// are written.  Inside chunk n, with L the inclusive cumsum of a over its
// rows and L_C its last row:
//
//     y  = exp(L_t) (c H_{n-1}) + A x
//     A[t, s] = (c_t . b_s) exp(min(L_t - L_s, 0)),  s <= t
//     H_n = exp(L_C) H_{n-1} + dH_n,  dH_n = (b * exp(L_C - L))^T x
//
// Stability (the Pallas kernel's rule): every exponent is a sum of
// log-decays over a forward interval, so it is <= 0 and nothing overflows
// however strong the decay.  L is summed and differenced in f64 and each
// exponent rounded to f32 once: under strong decay |L| passes 10^3 within
// a chunk, where an f32 prefix sum loses ~1e-4 of every exponent
// difference, and two summation orders (this scan, torch's cumsum in the
// plain version) then part by ~1e-4 of the state.
//
// Bound: at the zamba2-1.2b serving prefill (BH = 4 * 64, T = 128,
// N = P = C = 64, bf16 x/b/c) ~25 MB (7.6 us at 3.35 TB/s) against the
// token recurrence's 5*N*P f32 operations a token and head, 0.67 GFLOP
// (10 us at 67 TFLOP/s): operations.  The workspace below adds ~34 MB of
// traffic (10 us).
//
// Design: the first design (scripts/replaced/mamba2_serial.cu) gave a block
// one (row, 16-column slice) walking its chunks in series, so each block
// recomputed the chunk's (C x C) matrix A, four a head, from two scalar
// shared-memory reads an FMA.  The decay is a scalar a (row, step), so
// every term but the carried state depends on its chunk alone, and the
// carry is one multiply-add a state element a chunk.  Three launches on the
// stream, as csrc/rwkv6.cu:
//  1. states, a block per (row, chunk): the f64 log-decay scan, dH_n and
//     d_n = exp(L_C) into a workspace (BH, chunks, N, P) / (BH, chunks);
//  2. scan, a thread per 4 state elements (row, n, p .. p + 3): H_n = d_n
//     H_{n-1} + dH_n over the chunks in 16-byte vectors, each slot of the
//     workspace overwritten with the state ENTERING its chunk, the last one
//     written to h_fin; 8 or 16 chunks' loads in flight;
//  3. outputs, a block per (row, chunk) owning all P columns, so A is
//     computed once a chunk: y = exp(L_t) (c H_{n-1}) + A x.
// Inside the blocks: c b^T runs on mma.sync.m16n8k16 when x, b and c are
// bf16 (both operands are the inputs, so every product is exact in f32 and
// only the summation order changes), 16 x 16 tiles of A a warp, the tiles
// above the diagonal skipped; every product with an f32 operand (c H, A x,
// dH, and c b^T for f32 inputs) stays on FFMA, since TF32 or rounding those
// operands to bf16 would miss the state's f32 gate.  Those products are
// 4 x 4 register tiles a thread whose shared-memory operands are 16-byte
// vectors, 8-byte or 4-byte groups of bf16 (f32 c and A are stored
// transposed), never two scalar reads an FMA.  What the chip showed
// (PERF.md): the kernels follow how many blocks an SM holds, so
// tiles arrive by cp.async as they are where the products can read them so
// (x and b in the states kernel, H and bf16 c and b in the outputs kernel:
// no staging registers), the others' loads all issued before a block
// waits; in the outputs kernel c H is summed first and A then takes H's
// place: 53 KB and 64 registers a thread with bf16 inputs, four blocks an
// SM.  8 x 8 register
// tiles in 64-thread blocks (fewer shared-memory reads an FMA), blocks that
// walk several chunks with the next chunk's loads in flight, and 40
// registers for six states blocks an SM all ran slower.  N, P <= 64 and
// C <= 64.
#include "mma.cuh"
#include "vec.cuh"

using namespace rt;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int CMAX = 64;
constexpr int NMAX = 64;
constexpr int PMAX = 64;
constexpr int LT = CMAX + 4;   // row stride of the transposed c, b and A (16-byte rows)
constexpr int L16 = NMAX + 8;  // row stride of the bf16 c and b (16 bytes of padding)
constexpr unsigned FULL = 0xffffffffu;

// Element (n, t) of a transposed (N x C) f32 tile, row stride LT: the
// 4-column groups of t are permuted by n's eighth (an XOR on bits 2-4 of t),
// so the staging's stores, whose lanes hold n 8 apart, fall in distinct
// banks, while each aligned group of 4 t's stays one 16-byte vector.
__device__ __forceinline__ int tr(int n, int t) { return n * LT + (t ^ (((n >> 3) & 7) << 2)); }

// A (rows x cols) tile of T at src (row-major, contiguous; at most ROWS x
// COLS), rows from `live` on read as zero.  Where src starts on 16 bytes and
// a row is whole 16-byte vectors, load() issues all of a thread's 16-byte
// loads and put() unpacks them later, so several tiles' loads fly together;
// otherwise put() reads element by element.  put(f): f(t, i, value as f32)
// for each element.
template <typename T, int ROWS, int COLS>
struct Tile {
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int NV = (ROWS * COLS / VE + THREADS - 1) / THREADS;
  const T* src;
  int rows, live, cols;
  bool vec;
  uint4 v[NV];

  __device__ __forceinline__ void load(const T* __restrict__ s, int r, int l, int c) {
    src = s, rows = r, live = l, cols = c;
    vec = aligned16(s) && (c * sizeof(T)) % 16 == 0;
    if (!vec) return;
    const int nvec = rows * cols / VE;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int q = threadIdx.x + u * THREADS;
      v[u] = q < nvec && q * VE / cols < live ? __ldg(reinterpret_cast<const uint4*>(src) + q)
                                              : make_uint4(0, 0, 0, 0);
    }
  }

  template <typename F>
  __device__ __forceinline__ void put(F f) const {
    if (vec) {
      const int nvec = rows * cols / VE;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int q = threadIdx.x + u * THREADS;
        if (q < nvec) {
          const int g = q * VE, t = g / cols, i = g - t * cols;
          typename Acc<T>::type e[VE];
          Vec<T>::unpack(v[u], e);
#pragma unroll
          for (int k = 0; k < VE; ++k) f(t, i + k, e[k]);
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
        const int t = idx / cols, i = idx - t * cols;
        f(t, i, t < live ? to_f(src[idx]) : 0.f);
      }
    }
  }
};

// rows x cols elements of T at src (row-major, contiguous) into dst (row
// stride ld elements, 16-byte rows), rows from `live` on zero: by 16-byte
// cp.async copies where src starts on 16 bytes and a row is whole 16-byte
// vectors (they land at the caller's cp_async_wait), else element by element.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* __restrict__ src, int rows,
                                          int live, int cols) {
  constexpr int VE = 16 / sizeof(T);
  if (aligned16(src) && (cols * sizeof(T)) % 16 == 0) {
    const int per_row = cols / VE;
    for (int q = threadIdx.x; q < rows * per_row; q += THREADS) {
      const int t = q / per_row, i = (q - t * per_row) * VE;
      cp_async16(dst + t * ld + i, t < live ? src + t * cols + i : src, t < live);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
      const int t = idx / cols, i = idx - t * cols;
      dst[t * ld + i] = t < live ? src[idx] : T(0.f);
    }
  }
}

// A chunk's place: blk = row * nc + chunk; rows t0 .. t0 + live - 1 of its
// row live, the first at (row, t) index base.
struct Chunk {
  long blk, row, base;
  int t0, live;
  __device__ __forceinline__ Chunk(long b, int n_t, int C, int nc) : blk(b), row(b / nc) {
    t0 = static_cast<int>(b - row * nc) * C;
    live = min(C, n_t - t0);
    base = row * n_t + t0;
  }
};

// The log-decays of a chunk as warp 0 holds them: lane l rows 2 l, 2 l + 1
// (rows from `live` on count as 0), loaded ahead of the scan.
struct Decays {
  double a0, a1;
  __device__ __forceinline__ void load(const float* __restrict__ a, int live) {
    const int i0 = 2 * (threadIdx.x & 31);
    a0 = i0 < live ? a[i0] : 0.0;
    a1 = i0 + 1 < live ? a[i0 + 1] : 0.0;
  }
};

// By warp 0: L[t] (f64) <- the inclusive cumsum of the decays over the
// chunk's C rows; returns L_C to every lane.
__device__ __forceinline__ double logdecay_scan(const Decays& d, int C, double* L) {
  const int lane = threadIdx.x & 31;
  const double pair = d.a0 + d.a1;
  double incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const double l0 = (incl - pair) + d.a0, l1 = l0 + d.a1;
  if (2 * lane < C) L[2 * lane] = l0;
  if (2 * lane + 1 < C) L[2 * lane + 1] = l1;
  return __shfl_sync(FULL, ((C - 1) & 1) ? l1 : l0, (C - 1) >> 1);
}

// The first min(4, live) of v (rounded to T) at p: one 16-byte (f32) or
// 8-byte (bf16) store where live >= 4 and p is 4-element aligned, else one
// at a time.
template <typename T>
__device__ __forceinline__ void st4(T* p, const float (&v)[4], int live) {
  T o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = from_f<T>(v[j]);
  if (live >= 4 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(o);
    else
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(o);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < live) p[j] = o[j];
  }
}

// Four consecutive values of T from shared memory as f32: 8 bytes of bf16
// (exact) or 16 of f32
__device__ __forceinline__ void ld4(float (&r)[4], const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  r[0] = __uint_as_float(w.x << 16), r[1] = __uint_as_float(w.x & 0xffff0000u);
  r[2] = __uint_as_float(w.y << 16), r[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void ld4(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}

template <typename T>
struct StatesSmem {
  double L[CMAX];
  float w[CMAX];  // exp(L_C - L)
  T x[CMAX * PMAX];  // x and b as they are
  T b[CMAX * NMAX];
};

// 1. states, a block per (row, chunk): dH_n = (b * exp(L_C - L))^T x and
// d_n = exp(L_C).  x and b arrive by cp.async as they are (no staging
// registers); each b is scaled by its row's exp(L_C - L) in f32 before its
// products, as the plain version rounds b * exp(L_C - L)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ a,
                  const T* __restrict__ b, float* __restrict__ dh, float* __restrict__ dec,
                  int n_t, int N, int P, int C, int nc) {
  __shared__ __align__(16) StatesSmem<T> sm;
  const int tid = threadIdx.x;
  const Chunk k(blockIdx.x, n_t, C, nc);
  copy_tile(sm.x, PMAX, x + k.base * P, C, k.live, P);
  copy_tile(sm.b, NMAX, b + k.base * N, C, k.live, N);
  if (tid < 32) {  // warp 0: the scan and w while the copies fly
    Decays da;
    da.load(a + k.base, k.live);
    const double l_last = logdecay_scan(da, C, sm.L);
    const int i0 = 2 * tid;
    if (i0 < C) sm.w[i0] = expf(static_cast<float>(l_last - sm.L[i0]));
    if (i0 + 1 < C) sm.w[i0 + 1] = expf(static_cast<float>(l_last - sm.L[i0 + 1]));
    if (tid == 0) dec[k.blk] = expf(static_cast<float>(l_last));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // dH[n][p], a thread 4 x 4: rows 4 (tid / 16), columns 4 (tid % 16)
  const int n0 = 4 * (tid / 16), p0 = 4 * (tid % 16);
  if (n0 >= N || p0 >= P) return;
  float acc[4][4] = {};
  for (int s = 0; s < C; ++s) {
    float br[4], xr[4];
    ld4(br, sm.b + s * NMAX + n0);
    ld4(xr, sm.x + s * PMAX + p0);
    const float ws = sm.w[s];
#pragma unroll
    for (int i = 0; i < 4; ++i) br[i] *= ws;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(br[i], xr[j], acc[i][j]);
  }
  float* out = dh + k.blk * N * P;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n0 + i < N) st4(out + (n0 + i) * P + p0, acc[i], P - p0);
}

// V consecutive floats, loaded and stored as one access (V = 4: 16 bytes)
template <int V> struct Floats { float f[V]; };

template <int V>
__device__ __forceinline__ Floats<V> ld(const float* p) {
  Floats<V> r;
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r.f[0] = v.x, r.f[1] = v.y, r.f[2] = v.z, r.f[3] = v.w;
  } else {
    r.f[0] = *p;
  }
  return r;
}
template <int V>
__device__ __forceinline__ void st(float* p, const Floats<V>& r) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.f[0], r.f[1], r.f[2], r.f[3]);
  else
    *p = r.f[0];
}

// 2. a thread per V consecutive state elements of a row (V = 4 where they
// are 16-byte vectors): the carried state over the chunks, U chunks' loads
// in flight; slot k of dh becomes H_{k-1}, the state entering chunk k
template <int V, int U>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(float* __restrict__ dh, const float* __restrict__ dec,
                const float* __restrict__ h0, float* __restrict__ h_fin, long groups, int NP,
                int nc) {
  const long g = blockIdx.x * (long)THREADS + threadIdx.x;
  if (g >= groups) return;
  const long e = g * V, row = e / NP, rem = e - row * NP;
  float* q = dh + row * nc * NP + rem;
  const float* d = dec + row * nc;
  Floats<V> h = h0 ? ld<V>(h0 + e) : Floats<V>{};
  for (int k0 = 0; k0 < nc; k0 += U) {
    Floats<V> dv[U];
    float dd[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u < nc) {
        dv[u] = ld<V>(q + (k0 + u) * (long)NP);
        dd[u] = d[k0 + u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k0 + u < nc) {
        st<V>(q + (k0 + u) * (long)NP, h);
#pragma unroll
        for (int j = 0; j < V; ++j) h.f[j] = dd[u] * h.f[j] + dv[u].f[j];
      }
  }
  st<V>(h_fin + e, h);
}

// c and b of a chunk: bf16 inputs as they are (for ldmatrix, and c H), f32
// inputs transposed (cT[tr(n, t)], bT[tr(n, s)])
template <bool TC> struct CB {
  bf16 c[CMAX * L16];
  bf16 b[CMAX * L16];
};
template <> struct CB<false> {
  float cT[NMAX * LT];
  float bT[NMAX * LT];
};

template <bool TC>
struct OutputsSmem {
  double L[CMAX];
  float expL[CMAX];  // exp(L_t)
  float x[CMAX * PMAX];
  union {
    float h[NMAX * PMAX];  // H_{n-1}, until c H is summed
    float aT[CMAX * LT];   // then A transposed: aT[s][t], 0 above the diagonal
  } ha;
  CB<TC> u;
};

// 3. outputs, a block per (row, chunk) owning all P columns: y = exp(L_t)
// (c H_{n-1}) + A x.  bf16 inputs: 53 KB of shared memory and at most 64
// registers a thread, four blocks an SM
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 4 : 2)
ssd_outputs_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const T* __restrict__ b, const T* __restrict__ c,
                   const float* __restrict__ hprev, T* __restrict__ y, int n_t, int N, int P,
                   int C, int nc) {
  constexpr bool TC = sizeof(T) == 2;  // bf16 inputs: c b^T on the tensor cores
  extern __shared__ float4 smem_raw[];
  OutputsSmem<TC>& sm = *reinterpret_cast<OutputsSmem<TC>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk k(blockIdx.x, n_t, C, nc);
  if (TC && (C % 16 || N % 16)) {  // the tiles' padding must be zeros
    uint4* z = reinterpret_cast<uint4*>(&sm.u);
    for (int i = tid; i < static_cast<int>(sizeof(sm.u) / 16); i += THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  // H and bf16 c and b land as they are, by cp.async (no registers); x (and
  // f32 c and b, transposed) through registers
  copy_tile(sm.ha.h, PMAX, hprev + k.blk * N * P, N, N, P);
  Tile<T, CMAX, PMAX> sx;
  sx.load(x + k.base * P, C, k.live, P);
  if constexpr (TC) {
    copy_tile(sm.u.c, L16, c + k.base * N, C, k.live, N);
    copy_tile(sm.u.b, L16, b + k.base * N, C, k.live, N);
  } else {
    Tile<T, CMAX, NMAX> sc, sb;
    sc.load(c + k.base * N, C, k.live, N);
    sb.load(b + k.base * N, C, k.live, N);
    sc.put([&](int t, int n, float v) { sm.u.cT[tr(n, t)] = v; });
    sb.put([&](int t, int n, float v) { sm.u.bT[tr(n, t)] = v; });
  }
  if (tid < 32) {
    Decays da;
    da.load(a + k.base, k.live);
    logdecay_scan(da, C, sm.L);
  }
  sx.put([&](int t, int p, float v) { sm.x[t * PMAX + p] = v; });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < C) sm.expL[tid] = expf(static_cast<float>(sm.L[tid]));

  // y[t][p], a thread 4 x 4: rows tb .. tb + 3, columns p0 .. p0 + 3; c H
  // first, so that A can take H's place
  const int tb = 4 * (tid / 16), p0 = 4 * (tid % 16);
  const bool mine = tb < C && p0 < P;
  float inter[4][4] = {}, intra[4][4] = {};
  auto add_ch = [&](const float (&cr)[4], int n) {
    const float4 hv = *reinterpret_cast<const float4*>(sm.ha.h + n * PMAX + p0);
    const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cr[i], hr[j], inter[i][j]);
  };
  if constexpr (TC) {
    // c H from the bf16 rows of c: a 4-byte read of two n a row (broadcast
    // to the lanes sharing tb), unpacked exactly
    int n = 0;
    for (; mine && n + 1 < N; n += 2) {
      float c0[4], c1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(sm.u.c + (tb + i) * L16 + n);
        c0[i] = __uint_as_float(w << 16);
        c1[i] = __uint_as_float(w & 0xffff0000u);
      }
      add_ch(c0, n);
      add_ch(c1, n + 1);
    }
    if (mine && n < N) {
      float c0[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c0[i] = __bfloat162float(sm.u.c[(tb + i) * L16 + n]);
      add_ch(c0, n);
    }
  } else {
    for (int n = 0; mine && n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(sm.u.cT + tr(n, tb));
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      add_ch(cr, n);
    }
  }
  __syncthreads();  // every c H is summed: H's tile is free

  // A = (c b^T) * exp(min(L_t - L_s, 0)) on s <= t, 0 above, stored transposed
  auto put_a = [&](int t, int s, float cb) {
    if (t < C && s < C)
      sm.ha.aT[s * LT + t] =
          s <= t ? cb * expf(fminf(static_cast<float>(sm.L[t] - sm.L[s]), 0.f)) : 0.f;
  };
  if constexpr (TC) {
    // 16 x 16 blocks (rows mt, columns np) on or below the diagonal, a warp
    // at a time: two m16n8 tiles, N / 16 k-steps each
    const int tiles = (C + 15) / 16, n16 = (N + 15) & ~15;  // the mma tiles' extents
    const int g = lane >> 2, tq = lane & 3;
    for (int pr = warp; pr < tiles * tiles; pr += THREADS / 32) {
      const int mt = pr / tiles, np = pr - mt * tiles;
      if (np > mt) continue;
      float acc[2][4] = {};
      for (int kk = 0; kk < n16; kk += 16) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, sm.u.c + (16 * mt + (lane & 15)) * L16 + kk + (lane >> 4) * 8);
        ldsm_x4(bf, sm.u.b + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * L16 + kk +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          put_a(16 * mt + g + 8 * (i >> 1), 16 * np + 8 * j + 2 * tq + (i & 1), acc[j][i]);
          __syncwarp();  // one element at a time: the f64 L values stay few in registers
        }
    }
  } else {
    // a thread 4 x 4: rows 4 (tid / 16), columns 4 (tid % 16), on FFMA
    const int ta = 4 * (tid / 16), sa = 4 * (tid % 16);
    if (ta < C && sa < C) {
      float acc[4][4] = {};
      if (sa <= ta + 3)
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(sm.u.cT + tr(n, ta));
          const float4 bv = *reinterpret_cast<const float4*>(sm.u.bT + tr(n, sa));
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) put_a(ta + i, sa + j, acc[i][j]);
    }
  }
  __syncthreads();

  if (!mine) return;
  const Chunk ko(blockIdx.x, n_t, C, nc);  // recomputed: nothing 64-bit lives across A
  const int s_end = min(tb + 4, C);  // A is 0 above the diagonal
  for (int s = 0; s < s_end; ++s) {
    const float4 av = *reinterpret_cast<const float4*>(sm.ha.aT + s * LT + tb);
    const float4 xv = *reinterpret_cast<const float4*>(sm.x + s * PMAX + p0);
    const float ar[4] = {av.x, av.y, av.z, av.w}, xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(ar[i], xr[j], intra[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tb + i;
    if (t >= ko.live) break;
    const float el = sm.expL[t];
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = el * inter[i][j] + intra[i][j];
    st4(y + (ko.base + t) * P + p0, v, P - p0);
  }
}

template <typename T>
int run(const void* x, const float* a, const void* b, const void* c, const float* h0,
        void* y, float* h_fin, float* dh, float* dec, int BH, int n_t, int N, int P, int C,
        cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(OutputsSmem<sizeof(T) == 2>));
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_outputs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (n_t + C - 1) / C;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  ssd_states_kernel<T><<<BH * nc, THREADS, 0, stream>>>(xt, a, bt, dh, dec, n_t, N, P, C, nc);
  // the scan: 16-byte vectors where the rows allow; 16 chunks' loads in
  // flight where there are more than 8 chunks (T = 4096: 82 -> 65 us), else
  // 8 (half the registers: twice the threads an SM at the prefill shape)
  const long elems = (long)BH * N * P;
  const bool v4 = (N * P) % 4 == 0 && aligned16(dh) && aligned16(h0) && aligned16(h_fin);
  const long groups = v4 ? elems / 4 : elems;
  const unsigned grid = static_cast<unsigned>((groups + THREADS - 1) / THREADS);
  auto scan = v4 ? (nc > 8 ? ssd_scan_kernel<4, 16> : ssd_scan_kernel<4, 8>)
                 : (nc > 8 ? ssd_scan_kernel<1, 16> : ssd_scan_kernel<1, 8>);
  scan<<<grid, THREADS, 0, stream>>>(dh, dec, h0, h_fin, groups, N * P, nc);
  ssd_outputs_kernel<T><<<BH * nc, THREADS, smem, stream>>>(
      xt, a, bt, static_cast<const T*>(c), dh, static_cast<T*>(y), n_t, N, P, C, nc);
  return 0;
}

}  // namespace

// x/b/c/y of `dtype` (0 f32, 1 bf16); a, h0 (NULL: zeros) and h_fin f32;
// C is the chunk (min(chunk, T)); dh (BH, ceil(T / C), N, P) and dec (BH,
// ceil(T / C)) are f32 workspaces.  Three launches on `stream`.  Returns
// cudaGetLastError() after them (cudaErrorInvalidValue for an unsupported
// dtype or size).
extern "C" int mamba2_ssd_launch(int dtype, const void* x, const float* a, const void* b,
                                 const void* c, const float* h0, void* y, float* h_fin,
                                 float* dh, float* dec, int BH, int T, int N, int P, int C,
                                 void* stream) {
  if (BH < 1 || T < 1 || N < 1 || N > NMAX || P < 1 || P > PMAX || C < 1 || C > CMAX || !dh ||
      !dec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = run<float>(x, a, b, c, h0, y, h_fin, dh, dec, BH, T, N, P, C, s);
  else if (dtype == DT_BF16)
    err = run<bf16>(x, a, b, c, h0, y, h_fin, dh, dec, BH, T, N, P, C, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
