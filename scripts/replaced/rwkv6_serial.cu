// The WKV6 kernel's first design (csrc/rwkv6.cu before its redesign): one
// block a row walks the chunks in series.  Kept only so that chip_smoke.py
// can time it beside the redesign on the same inputs (its `wkv6` phase,
// `replaced_ms`); no path of the port calls it.  chip_smoke.py builds it
// with -I src/repro_torch/csrc into build/replaced/.
//
// Chunked RWKV6 (Finch) WKV recurrence for Hopper (sm_90a).
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
// reference pads.  Inside a chunk, with L the inclusive cumsum of w over the
// chunk's rows and Lprev = L - w:
//
//     y  = (r * exp(Lprev)) S + A v + diag(r u k) v
//     A[t, s] = sum_i r[t,i] k[s,i] exp(min(Lprev[t,i] - L[s,i], 0)), s < t
//     S <- exp(L_C) S + (k * exp(L_C - L))^T v
//
// Stability (the Pallas kernel's rule): every exponent is a sum of log-decays
// over a forward interval, so it is <= 0.  A is computed pairwise and never
// factored into exp(Lprev[t]) * exp(-L[s]), whose second factor overflows
// under strong decay (w is clamped at -20, so -L reaches 640 in one chunk).
//
// Bound: at the prefill shape (BH = 128, T = 128, K = V = 64, bf16 r/k/v)
// ~14.7 MB from a zero state (4.4 us at 3.35 TB/s) against ~0.36 GFLOP of
// f32 work (5.3 us at 67 TFLOP/s) and C*(C-1)/2*K exp evaluations a chunk
// on the SFU (~4.4 us in all); but the chunk loop is serial, and the time
// is its latency (H100: ~60 us a chunk, PERF.md).
//
// Design (simple first): one block of 256 threads per BH row keeps the
// (K x V) f32 state in shared memory across the serial chunk loop; each chunk
// stages r, k, v, w as f32 in shared memory, scans w per channel, builds A
// and the diagonal bonus one warp per (t, s) pair with lanes over channels,
// then computes y (one thread per output) and updates S (one thread per
// state element).  At B = 1 this gives only H = 32 blocks on 132 SMs;
// state columns are independent, so a block per (row, V-slice) is the
// obvious later split.  K, V <= 64 and C <= 32.
#include "common.cuh"
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 64;
constexpr int VMAX = 64;
constexpr int CMAX = 32;

struct Smem {
  float S[KMAX * VMAX];   // carried state (K x V), row-major
  float r[CMAX * KMAX];   // r, then r * exp(Lprev)
  float k[CMAX * KMAX];   // k, then k * exp(L_C - L)
  float v[CMAX * VMAX];
  float lp[CMAX * KMAX];  // w, then Lprev = L - w
  float l[CMAX * KMAX];   // L: inclusive cumsum of w over the chunk
  float a[CMAX * CMAX];   // intra-chunk pairs, strict lower triangle
  float diag[CMAX];       // r_t . (u * k_t)
  float decay[KMAX];      // exp(L_C)
  float u[KMAX];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_fin,
            int n_t, int K, int V, int C) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row = blockIdx.x;
  const long kv_off = row * K * V;
  for (int idx = tid; idx < K * V; idx += THREADS) sm.S[idx] = s0 ? s0[kv_off + idx] : 0.f;
  for (int i = tid; i < K; i += THREADS) sm.u[i] = u[row * K + i];

  const int nc = (n_t + C - 1) / C;
  for (int n = 0; n < nc; ++n) {
    const int t0 = n * C;
    const int live_rows = min(C, n_t - t0);
    const long k_base = (row * n_t + t0) * K;
    const long v_base = (row * n_t + t0) * V;
    __syncthreads();  // the previous chunk is done with the staged rows and S
    for (int idx = tid; idx < C * K; idx += THREADS) {
      const bool live = idx / K < live_rows;
      sm.r[idx] = live ? to_f(r[k_base + idx]) : 0.f;
      sm.k[idx] = live ? to_f(k[k_base + idx]) : 0.f;
      sm.lp[idx] = live ? w[k_base + idx] : 0.f;
    }
    for (int idx = tid; idx < C * V; idx += THREADS)
      sm.v[idx] = idx / V < live_rows ? to_f(v[v_base + idx]) : 0.f;
    __syncthreads();

    for (int i = tid; i < K; i += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float wt = sm.lp[t * K + i];
        acc += wt;
        sm.l[t * K + i] = acc;
        sm.lp[t * K + i] = acc - wt;
      }
      sm.decay[i] = expf(acc);
    }
    __syncthreads();

    // A (s < t) and the bonus diagonal (s == t): a warp per pair
    for (int p = warp; p < C * C; p += WARPS) {
      const int t = p / C, s = p % C;
      if (s > t) continue;
      const float* rt = sm.r + t * K;
      float part = 0.f;
      if (s < t) {
        const float* ks = sm.k + s * K;
        const float* lpt = sm.lp + t * K;
        const float* ls = sm.l + s * K;
        for (int i = lane; i < K; i += 32)
          part += rt[i] * ks[i] * expf(fminf(lpt[i] - ls[i], 0.f));
      } else {
        const float* kt = sm.k + t * K;
        for (int i = lane; i < K; i += 32) part += rt[i] * sm.u[i] * kt[i];
      }
      part = warp_sum(part);
      if (lane == 0) {
        if (s < t)
          sm.a[t * C + s] = part;
        else
          sm.diag[t] = part;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < C * K; idx += THREADS) {
      const int i = idx % K;
      sm.r[idx] *= expf(sm.lp[idx]);
      sm.k[idx] *= expf(sm.l[(C - 1) * K + i] - sm.l[idx]);
    }
    __syncthreads();

    for (int idx = tid; idx < C * V; idx += THREADS) {
      const int t = idx / V, j = idx % V;
      const float* qt = sm.r + t * K;
      float acc = 0.f;
      for (int i = 0; i < K; ++i) acc += qt[i] * sm.S[i * V + j];
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra += sm.a[t * C + s] * sm.v[s * V + j];
      acc += intra;
      acc += sm.diag[t] * sm.v[t * V + j];
      if (t < live_rows) y[v_base + idx] = from_f<T>(acc);
    }
    __syncthreads();

    for (int idx = tid; idx < K * V; idx += THREADS) {
      const int i = idx / V, j = idx % V;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += sm.k[s * K + i] * sm.v[s * V + j];
      sm.S[idx] = sm.decay[i] * sm.S[idx] + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < K * V; idx += THREADS) s_fin[kv_off + idx] = sm.S[idx];
}

template <typename T>
int run(const void* r, const void* k, const void* v, const float* w, const float* u,
        const float* s0, void* y, float* s_fin, int BH, int n_t, int K, int V, int C,
        cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(Smem));
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  wkv6_kernel<T><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, static_cast<T*>(y), s_fin, n_t, K, V, C);
  return 0;
}

}  // namespace

// r/k/v/y of `dtype` (0 f32, 1 bf16); w, u, s0 (NULL: zeros) and s_fin f32;
// C is the chunk (min(chunk, T)).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype or size).
extern "C" int rwkv6_serial_launch(int dtype, const void* r, const void* k, const void* v,
                            const float* w, const float* u, const float* s0, void* y,
                            float* s_fin, int BH, int T, int K, int V, int C,
                            void* stream) {
  if (BH < 1 || T < 1 || K < 1 || K > KMAX || V < 1 || V > VMAX || C < 1 || C > CMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = run<float>(r, k, v, w, u, s0, y, s_fin, BH, T, K, V, C, s);
  else if (dtype == DT_BF16)
    err = run<__nv_bfloat16>(r, k, v, w, u, s0, y, s_fin, BH, T, K, V, C, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
