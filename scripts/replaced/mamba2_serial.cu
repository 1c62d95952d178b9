// The SSD kernel's first design (csrc/mamba2.cu before its redesign): a
// block a (row, 16-column slice) walks the chunks in series.  Kept only so
// that chip_smoke.py can time it beside the redesign on the same inputs (its
// `ssd` phase, `replaced_ms`, and profile_prefill_zamba); no path of the
// port calls it.  chip_smoke.py builds it with -I src/repro_torch/csrc into
// build/replaced/.
//
// Chunked Mamba2 SSD (scalar decay per head and step) for Hopper (sm_90a).
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
// but L's (FMA on the CUDA cores; no operand is rounded below f32).  Time is cut
// into chunks of C rows; rows past T are staged as a = 0, x = b = c = 0,
// which leave the state exact, and only live rows of y are written.  Inside
// a chunk, with L the inclusive cumsum of a over its rows:
//
//     y  = exp(L_t) (c H) + A x
//     A[t, s] = (c_t . b_s) exp(min(L_t - L_s, 0)),  s <= t
//     H <- exp(L_C) H + (b * exp(L_C - L))^T x
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
// (10 us at 67 TFLOP/s; the causal chunked form here needs 0.81): operations.
//
// Design (simple first, and shaped by the WKV6 kernel's lesson: one block
// per head walking its chunks left 100 of 132 SMs idle).  The P columns of
// y and H are independent given the chunk's (C x C) matrix A, so a block
// owns one (row, 16-column slice): 4 blocks a head at P = 64, 1024 blocks
// at the serving prefill.  Each block recomputes A (C^2 N = 262 k FMAs a
// chunk, half skipped above the diagonal) and walks its chunks in series
// with its (N x 16) slice of H in shared memory.  Per chunk: stage x, b, c
// as f32 (b and c rows padded to 65 floats, so a warp's column reads hit
// distinct banks) while warp 0 scans a with shuffles; A as 4 x 4 register
// tiles a thread; then y, then H, one thread per 4 outputs.  N, P <= 64 and
// C <= 64.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256;
constexpr int CMAX = 64;
constexpr int NMAX = 64;
constexpr int PMAX = 64;
constexpr int PS = 16;        // columns of y and H a block owns
constexpr int BS = NMAX + 1;  // row stride of the staged b and c
constexpr int AS = CMAX + 1;  // row stride of A
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  double L[CMAX];      // inclusive cumsum of a over the chunk, f64
  float H[NMAX * PS];  // carried state slice (N x PS), row-major
  float x[CMAX * PS];  // the chunk's x slice
  float b[CMAX * BS];
  float c[CMAX * BS];
  float A[CMAX * AS];  // (c b^T) * exp(min(L_t - L_s, 0)), s <= t
  float expL[CMAX];    // exp(L_t)
  float w[CMAX];       // exp(L_C - L_s)
  float decay;         // exp(L_C)
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, const float* __restrict__ h0, T* __restrict__ y,
           float* __restrict__ h_fin, int n_t, int N, int P, int C) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row = blockIdx.x;
  const int j0 = blockIdx.y * PS;
  const int jw = min(PS, P - j0);  // live columns of this slice
  const long h_off = row * N * P;
  // thread roles: rows tq + 16 i (y) or states tq + 16 i (H) in column jj;
  // A tile rows 4 tq .. 4 tq + 3 by columns jj + 16 j
  const int tq = tid / PS, jj = tid % PS;

  for (int idx = tid; idx < N * PS; idx += THREADS) {
    const int n = idx / PS, j = idx % PS;
    const bool live = h0 != nullptr && j < jw;
    sm.H[idx] = live ? h0[h_off + static_cast<long>(n) * P + j0 + j] : 0.f;
  }

  const int nc = (n_t + C - 1) / C;
  for (int ch = 0; ch < nc; ++ch) {
    const long r0 = row * n_t + static_cast<long>(ch) * C;  // first (row, t) of the chunk
    const int live = min(C, n_t - ch * C);
    __syncthreads();  // the previous chunk is done with the staged rows and H
    for (int idx = tid; idx < C * PS; idx += THREADS) {
      const int t = idx / PS, j = idx % PS;
      sm.x[idx] = (t < live && j < jw) ? to_f(x[(r0 + t) * P + j0 + j]) : 0.f;
    }
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int t = idx / N, n = idx % N;
      const bool lv = t < live;
      sm.b[t * BS + n] = lv ? to_f(b[(r0 + t) * N + n]) : 0.f;
      sm.c[t * BS + n] = lv ? to_f(c[(r0 + t) * N + n]) : 0.f;
    }
    if (warp == 0) {  // L in f64: lane holds rows 2 lane and 2 lane + 1
      const int i0 = 2 * lane, i1 = i0 + 1;
      const double a0 = i0 < live ? a[r0 + i0] : 0.0;
      const double a1 = i1 < live ? a[r0 + i1] : 0.0;
      const double pair = a0 + a1;
      double incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      const double l0 = (incl - pair) + a0;
      const double l1 = l0 + a1;
      const double l_last = __shfl_sync(FULL, ((C - 1) & 1) ? l1 : l0, (C - 1) >> 1);
      if (i0 < C) {
        sm.L[i0] = l0;
        sm.expL[i0] = expf(static_cast<float>(l0));
        sm.w[i0] = expf(static_cast<float>(l_last - l0));
      }
      if (i1 < C) {
        sm.L[i1] = l1;
        sm.expL[i1] = expf(static_cast<float>(l1));
        sm.w[i1] = expf(static_cast<float>(l_last - l1));
      }
      if (lane == 0) sm.decay = expf(static_cast<float>(l_last));
    }
    __syncthreads();

    // A: a 4 x 4 tile a thread, rows tb .. tb + 3, columns jj + 16 j
    const int tb = 4 * tq;
    if (tb < C) {
      const int s_hi = min(tb + 3, C - 1);  // no column past the tile's last row
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sm.c[(tb + i) * BS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = jj + 16 * j;
          if (s <= s_hi) {
            const float bv = sm.b[s * BS + n];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += cv[i] * bv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tb + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = jj + 16 * j;
          if (t < C && s <= t)
            sm.A[t * AS + s] =
                acc[i][j] * expf(fminf(static_cast<float>(sm.L[t] - sm.L[s]), 0.f));
        }
      }
    }
    __syncthreads();

    // y = exp(L_t) (c H) + A x, rows tq + 16 i of column jj
    {
      float acc[4] = {};
      for (int n = 0; n < N; ++n) {
        const float h = sm.H[n * PS + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tq + 16 * i;
          if (t < C) acc[i] += sm.c[t * BS + n] * h;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tq + 16 * i;
        if (t >= C) continue;
        float intra = 0.f;
        for (int s = 0; s <= t; ++s) intra += sm.A[t * AS + s] * sm.x[s * PS + jj];
        const float out = acc[i] * sm.expL[t] + intra;
        if (t < live && jj < jw) y[(r0 + t) * P + j0 + jj] = from_f<T>(out);
      }
    }
    __syncthreads();  // every y is done reading H

    // H <- exp(L_C) H + (b * exp(L_C - L))^T x, states tq + 16 i of column jj
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tq + 16 * i;
      if (n >= N) continue;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += (sm.b[s * BS + n] * sm.w[s]) * sm.x[s * PS + jj];
      sm.H[n * PS + jj] = sm.decay * sm.H[n * PS + jj] + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * PS; idx += THREADS) {
    const int n = idx / PS, j = idx % PS;
    if (j < jw) h_fin[h_off + static_cast<long>(n) * P + j0 + j] = sm.H[idx];
  }
}

template <typename T>
int run(const void* x, const float* a, const void* b, const void* c, const float* h0,
        void* y, float* h_fin, int BH, int n_t, int N, int P, int C, cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(Smem));
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(BH, (P + PS - 1) / PS);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(b), static_cast<const T*>(c), h0,
      static_cast<T*>(y), h_fin, n_t, N, P, C);
  return 0;
}

}  // namespace

// x/b/c/y of `dtype` (0 f32, 1 bf16); a, h0 (NULL: zeros) and h_fin f32;
// C is the chunk (min(chunk, T)).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported dtype or size).
extern "C" int mamba2_serial_launch(int dtype, const void* x, const float* a, const void* b,
                                    const void* c, const float* h0, void* y, float* h_fin,
                                    int BH, int T, int N, int P, int C, void* stream) {
  if (BH < 1 || T < 1 || N < 1 || N > NMAX || P < 1 || P > PMAX || C < 1 || C > CMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = run<float>(x, a, b, c, h0, y, h_fin, BH, T, N, P, C, s);
  else if (dtype == DT_BF16)
    err = run<__nv_bfloat16>(x, a, b, c, h0, y, h_fin, BH, T, N, P, C, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
