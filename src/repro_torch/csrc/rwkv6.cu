// Chunked RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), parallel across
// chunks and state columns.
//
// Replaces the Pallas kernel `repro/kernels/rwkv6.py` (`_wkv6_kernel`, call
// at :99) with the contract of the model's `wkv6_chunked`
// (`repro/models/rwkv.py:31`): an optional initial state in, the final state
// out.  For each row b of BH = batch * heads:
//
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T        (w_t = log-decay <= 0)
//
//     r, k, w (BH, T, K), v (BH, T, V), u (BH, K), s0 (BH, K, V) or NULL
//     -> y (BH, T, V) in r's dtype, s_fin (BH, K, V) f32
//
// r/k/v/y are f32 or bf16; w, u and the state are f32, and every sum is f32.
// Time is cut into chunks of C rows; a chunk past T is padded with zero rows
// (w = k = v = 0 leave the state unchanged, so s_fin is exact), as the
// reference pads.  Inside chunk n, with L the inclusive cumsum of w over the
// chunk's rows, Lprev = L - w and L_C its last row:
//
//     y  = (r * exp(Lprev)) S_{n-1} + A v + diag(r u k) v
//     A[t, s] = sum_i r[t,i] k[s,i] exp(min(Lprev[t,i] - L[s,i], 0)), s < t
//     S_n = diag(exp(L_C)) S_{n-1} + dS_n,  dS_n = (k * exp(L_C - L))^T v
//
// Stability (the Pallas kernel's rule): every exponent is a sum of log-decays
// over a forward interval, so it is <= 0.  A is computed pairwise and never
// factored into exp(Lprev[t]) * exp(-L[s]), whose second factor overflows
// under strong decay (w is clamped at -20, so -L reaches 640 in one chunk).
//
// Bound: at the prefill shape (BH = 128, T = 128, K = V = 64, bf16 r/k/v)
// ~14.7 MB of inputs and outputs (4.4 us at 3.35 TB/s) against ~0.36 GFLOP
// of f32 work (5.3 us at 67 TFLOP/s) and C*(C-1)/2*K exp evaluations a
// chunk on the SFU; the workspace below adds ~42 MB of traffic (12.6 us).
//
// Design: the first design walked the chunks in series, one block a row
// (32 blocks at T = 4096, ~58 us a chunk).  The decay is diagonal, so every
// term but the carried state depends on its chunk alone, and the carry is
// one multiply-add a state element a chunk.  Three launches on the stream:
//  1. states, a block per (row, chunk): the log-decay scan, dS_n and
//     d_n = exp(L_C) into a workspace (BH, chunks, K, V) / (BH, chunks, K);
//  2. scan, a thread per (row, i, j): S_n = d_n[i] S_{n-1} + dS_n over the
//     chunks, each slot of the workspace overwritten with the state ENTERING
//     its chunk, the last one written to s_fin; 8 chunks' loads in flight;
//  3. outputs, a block per (row, chunk): the scan again, A and the bonus
//     diagonal, then y = (r * exp(Lprev)) S_{n-1} + A v + diag v.
// Inside a block: the log-decay scan runs on all 256 threads (a thread per
// channel and quarter of the chunk, then the quarters' offsets); A takes a
// thread per (t, s) pair looping over the channels (the rows padded to 65
// floats, so the 32 lanes' rows fall in distinct banks), the diagonal a
// warp per row; the products are register tiles (dS: 8 x 2 a thread, y:
// 4 x 2) whose shared-memory operands are broadcasts or 8-byte vectors,
// never two scalar reads per FMA.  Measured and dropped (PERF.md): S_{n-1}
// read through L1 for four blocks an SM (slower), each outputs block
// carrying the state over the chunks before its own in place of launch 2
// up to 4 chunks (slower: 74 against 60 us at the prefill shape),
// 512-thread blocks, a thread per 2 x 2 tile of pairs with 16-byte reads of
// r * exp(Lprev), and every tile's loads issued before any store (each
// within 2%).  K, V <= 64 and C <= 32.
#include "common.cuh"
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 64;
constexpr int VMAX = 64;
constexpr int CMAX = 32;
constexpr int KP = KMAX + 1;  // padded row of r, k, w and L in the outputs kernel
constexpr int SEGS = THREADS / KMAX;  // quarters of the chunk in the scan
constexpr int SCAN_UNROLL = 8;        // chunks' loads in flight in the scan

// L (stride ld) <- the inclusive cumsum over the chunk's C rows of w (the
// same array, in place), for channels i < K: thread (i, quarter) sums its
// quarter's rows in order, then adds the earlier quarters' totals in order.
// tot is [SEGS][KMAX] of scratch.  Ends with a __syncthreads.
__device__ __forceinline__ void logdecay_scan(float* l, int ld, float* tot, int C, int K) {
  const int i = threadIdx.x % KMAX, seg = threadIdx.x / KMAX;
  const int rows = (C + SEGS - 1) / SEGS, t0 = seg * rows, t1 = min(C, t0 + rows);
  float run = 0.f;
  if (i < K) {
    for (int t = t0; t < t1; ++t) {
      run += l[t * ld + i];
      l[t * ld + i] = run;
    }
    tot[seg * KMAX + i] = run;
  }
  __syncthreads();
  if (i < K && seg > 0) {
    float off = 0.f;
    for (int q = 0; q < seg; ++q) off += tot[q * KMAX + i];
    for (int t = t0; t < t1; ++t) l[t * ld + i] += off;
  }
  __syncthreads();
}

// rows x cols elements of T at src (row-major, row stride cols) into f32
// dst[t * LD + i] (and dst2[t * LD + i] where given); rows from `live` on
// are zeros.  16-byte loads, every one issued before the first store, where
// each row starts on 16 bytes; the columns past cols are left as they are
// (their outputs are not kept).
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int rows, int live,
                                      int cols, float* dst2 = nullptr) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int NV = (ROWS * COLS / VE + THREADS - 1) / THREADS;
  if (aligned16(src) && (cols * sizeof(T)) % 16 == 0) {
    const int nvec = rows * cols / VE;
    uint4 raw[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int q = threadIdx.x + u * THREADS;
      raw[u] = q < nvec && q * VE / cols < live ? __ldg(reinterpret_cast<const uint4*>(src) + q)
                                                : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int q = threadIdx.x + u * THREADS;
      if (q < nvec) {
        const int g = q * VE, t = g / cols, i = g - t * cols;
        float f[VE];
        Vec<T>::unpack(raw[u], f);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          dst[t * LD + i + e] = f[e];
          if (dst2) dst2[t * LD + i + e] = f[e];
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
      const int t = idx / cols, i = idx - t * cols;
      dst[t * LD + i] = t < live ? to_f(src[idx]) : 0.f;
      if (dst2) dst2[t * LD + i] = dst[t * LD + i];
    }
  }
}

struct StatesSmem {
  float k[CMAX * KMAX];  // k, then k * exp(L_C - L)
  float v[CMAX * VMAX];
  float l[CMAX * KMAX];  // w, then L
  float tot[SEGS * KMAX];
};

// 1. a block per (row, chunk): dS_n = (k * exp(L_C - L))^T v and d_n = exp(L_C)
template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_states_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
                   float* __restrict__ ds, float* __restrict__ dec, int n_t, int K, int V,
                   int C, int nc) {
  __shared__ StatesSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long blk = blockIdx.x;  // row * nc + chunk
  const long row = blk / nc;
  const int t0 = static_cast<int>(blk - row * nc) * C, live = min(C, n_t - t0);
  const long base = row * n_t + t0;  // the chunk's first row
  stage<T, CMAX, KMAX, KMAX>(sm.k, k + base * K, C, live, K);
  stage<T, CMAX, VMAX, VMAX>(sm.v, v + base * V, C, live, V);
  stage<float, CMAX, KMAX, KMAX>(sm.l, w + base * K, C, live, K);
  __syncthreads();
  logdecay_scan(sm.l, KMAX, sm.tot, C, K);
  const float* lc = sm.l + (C - 1) * KMAX;  // L_C
  if (tid < K) dec[blk * K + tid] = expf(lc[tid]);
  for (int idx = tid; idx < C * KMAX; idx += THREADS) {
    const int i = idx % KMAX;
    sm.k[idx] *= expf(lc[i] - sm.l[idx]);
  }
  __syncthreads();
  // dS[i][j], a thread 8 rows i (warp) x 2 columns j (lane)
  const int i0 = warp * 8, j0 = lane * 2;
  float acc[8][2] = {};
  for (int t = 0; t < C; ++t) {
    const float4 ka = *reinterpret_cast<const float4*>(sm.k + t * KMAX + i0);
    const float4 kb = *reinterpret_cast<const float4*>(sm.k + t * KMAX + i0 + 4);
    const float2 vv = *reinterpret_cast<const float2*>(sm.v + t * VMAX + j0);
    const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      acc[a][0] = fmaf(kr[a], vv.x, acc[a][0]);
      acc[a][1] = fmaf(kr[a], vv.y, acc[a][1]);
    }
  }
  float* out = ds + blk * K * V;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (i0 + a < K && j0 + c < V) out[(i0 + a) * V + j0 + c] = acc[a][c];
}

// 2. a thread per state element (row, i, j): the carried state over the
// chunks; slot n of ds becomes S_{n-1}, the state entering chunk n
__global__ void __launch_bounds__(THREADS)
wkv6_scan_kernel(float* __restrict__ ds, const float* __restrict__ dec,
                 const float* __restrict__ s0, float* __restrict__ s_fin, long elems, int K,
                 int V, int nc) {
  const long e = blockIdx.x * (long)THREADS + threadIdx.x;
  if (e >= elems) return;
  const long kv = (long)K * V, row = e / kv, rem = e - row * kv;
  const int i = static_cast<int>(rem / V);
  float* p = ds + row * nc * kv + rem;
  const float* d = dec + row * nc * K + i;
  float s = s0 ? s0[e] : 0.f;
  for (int n0 = 0; n0 < nc; n0 += SCAN_UNROLL) {
    float dsv[SCAN_UNROLL], dv[SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u)
      if (n0 + u < nc) {
        dsv[u] = p[(n0 + u) * kv];
        dv[u] = d[(n0 + u) * K];
      }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u)
      if (n0 + u < nc) {
        p[(n0 + u) * kv] = s;
        s = dv[u] * s + dsv[u];
      }
  }
  s_fin[e] = s;
}

struct OutputsSmem {
  float r[CMAX * KP];  // r, then r * exp(Lprev)
  float k[CMAX * KP];
  float w[CMAX * KP];  // w, then Lprev = L - w
  float l[CMAX * KP];  // w, then L
  float v[CMAX * VMAX];
  float s[KMAX * VMAX];  // S_{n-1}
  float a[CMAX * CMAX];  // A[t][s], s < t
  float diag[CMAX];      // r_t . (u * k_t)
  float u[KMAX];
  float tot[SEGS * KMAX];
};

// 3. a block per (row, chunk): y = (r * exp(Lprev)) S_{n-1} + A v + diag v
template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_outputs_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const float* __restrict__ u,
                    const float* __restrict__ sprev, T* __restrict__ y, int n_t, int K, int V,
                    int C, int nc) {
  extern __shared__ float4 smem_raw[];
  OutputsSmem& sm = *reinterpret_cast<OutputsSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long blk = blockIdx.x;  // row * nc + chunk
  const long row = blk / nc;
  const int t0 = static_cast<int>(blk - row * nc) * C, live = min(C, n_t - t0);
  const long base = row * n_t + t0;  // the chunk's first row
  stage<T, CMAX, KMAX, KP>(sm.r, r + base * K, C, live, K);
  stage<T, CMAX, KMAX, KP>(sm.k, k + base * K, C, live, K);
  stage<float, CMAX, KMAX, KP>(sm.w, w + base * K, C, live, K, sm.l);
  stage<T, CMAX, VMAX, VMAX>(sm.v, v + base * V, C, live, V);
  stage<float, KMAX, VMAX, VMAX>(sm.s, sprev + blk * K * V, K, K, V);
  if (tid < K) sm.u[tid] = u[row * K + tid];
  __syncthreads();
  logdecay_scan(sm.l, KP, sm.tot, C, K);
  for (int idx = tid; idx < C * K; idx += THREADS) {  // w <- Lprev = L - w
    const int t = idx / K, i = idx % K;
    sm.w[t * KP + i] = sm.l[t * KP + i] - sm.w[t * KP + i];
  }
  __syncthreads();

  // A[t][s] for s < t: a thread per pair, over the channels; __expf (ex2 on
  // the SFU) is within 2 ulp of expf for the exponents that matter (>= -88;
  // below, both are 0 or denormal)
  const int pairs = C * (C - 1) / 2;
  for (int p = tid; p < pairs; p += THREADS) {
    int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);  // t(t-1)/2 <= p
    while (t * (t - 1) / 2 > p) --t;
    while ((t + 1) * t / 2 <= p) ++t;
    const int s = p - t * (t - 1) / 2;
    const float* rt = sm.r + t * KP;
    const float* lpt = sm.w + t * KP;
    const float* ks = sm.k + s * KP;
    const float* ls = sm.l + s * KP;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < K; ++i)
      acc = fmaf(rt[i] * ks[i], __expf(fminf(lpt[i] - ls[i], 0.f)), acc);
    sm.a[t * CMAX + s] = acc;
  }
  // the bonus diagonal, a warp per row
  for (int t = warp; t < C; t += WARPS) {
    float part = 0.f;
    for (int i = lane; i < K; i += 32) part += sm.r[t * KP + i] * sm.u[i] * sm.k[t * KP + i];
    part = warp_sum(part);
    if (lane == 0) sm.diag[t] = part;
  }
  __syncthreads();
  for (int idx = tid; idx < C * K; idx += THREADS) {  // r <- r * exp(Lprev)
    const int t = idx / K, i = idx % K;
    sm.r[t * KP + i] *= __expf(sm.w[t * KP + i]);
  }
  __syncthreads();

  // y[t][j], a thread RW = 4 rows t (warp) x 2 columns j (lane)
  constexpr int RW = CMAX / WARPS;
  const int tb = warp * RW, j0 = lane * 2;
  if (tb >= C) return;
  float inter[RW][2] = {}, intra[RW][2] = {};
  for (int i = 0; i < K; ++i) {
    const float2 sv = *reinterpret_cast<const float2*>(sm.s + i * VMAX + j0);
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const float rq = sm.r[min(tb + q, CMAX - 1) * KP + i];
      inter[q][0] = fmaf(rq, sv.x, inter[q][0]);
      inter[q][1] = fmaf(rq, sv.y, inter[q][1]);
    }
  }
  for (int s = 0; s < min(tb + RW - 1, C); ++s) {
    const float2 vv = *reinterpret_cast<const float2*>(sm.v + s * VMAX + j0);
#pragma unroll
    for (int q = 0; q < RW; ++q)
      if (s < tb + q) {
        const float aq = sm.a[(tb + q) * CMAX + s];
        intra[q][0] = fmaf(aq, vv.x, intra[q][0]);
        intra[q][1] = fmaf(aq, vv.y, intra[q][1]);
      }
  }
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int t = tb + q;
    if (t >= live) continue;
    const float dg = sm.diag[t];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + c;
      if (j < V)
        y[(row * n_t + t0 + t) * V + j] =
            from_f<T>((inter[q][c] + intra[q][c]) + dg * sm.v[t * VMAX + j]);
    }
  }
}

template <typename T>
int run(const void* r, const void* k, const void* v, const float* w, const float* u,
        const float* s0, void* y, float* s_fin, float* ds, float* dec, int BH, int n_t, int K,
        int V, int C, cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(OutputsSmem));
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_outputs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int nc = (n_t + C - 1) / C;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  wkv6_states_kernel<T><<<BH * nc, THREADS, 0, stream>>>(kt, vt, w, ds, dec, n_t, K, V, C, nc);
  const long elems = (long)BH * K * V;
  wkv6_scan_kernel<<<static_cast<unsigned>((elems + THREADS - 1) / THREADS), THREADS, 0,
                     stream>>>(ds, dec, s0, s_fin, elems, K, V, nc);
  wkv6_outputs_kernel<T><<<BH * nc, THREADS, smem, stream>>>(rt, kt, vt, w, u, ds,
                                                              static_cast<T*>(y), n_t, K, V, C,
                                                              nc);
  return 0;
}

}  // namespace

// r/k/v/y of `dtype` (0 f32, 1 bf16); w, u, s0 (NULL: zeros) and s_fin f32;
// C is the chunk (min(chunk, T)); ds (BH, ceil(T / C), K, V) and dec (BH,
// ceil(T / C), K) are f32 workspaces.  Three launches on `stream`.  Returns
// cudaGetLastError() after them (cudaErrorInvalidValue for an unsupported
// dtype or size).
extern "C" int rwkv6_launch(int dtype, const void* r, const void* k, const void* v,
                            const float* w, const float* u, const float* s0, void* y,
                            float* s_fin, float* ds, float* dec, int BH, int T, int K, int V,
                            int C, void* stream) {
  if (BH < 1 || T < 1 || K < 1 || K > KMAX || V < 1 || V > VMAX || C < 1 || C > CMAX || !ds ||
      !dec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = run<float>(r, k, v, w, u, s0, y, s_fin, ds, dec, BH, T, K, V, C, s);
  else if (dtype == DT_BF16)
    err = run<__nv_bfloat16>(r, k, v, w, u, s0, y, s_fin, ds, dec, BH, T, K, V, C, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
