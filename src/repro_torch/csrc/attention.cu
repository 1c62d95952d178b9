// Causal flash attention over the KV cache's native layout, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/attention.py` (`_flash_kernel`,
// the dense cache-layout form with per-row `kv_lens` and GQA folding that
// prefill and ragged slot decode use):
//
//     q (B, Tq, H, D), k/v (B, S, KVH, D), kv_lens (B*H,) -> out (B, Tq, H, D)
//
// Query head h reads KV head h / (H / KVH).  Row r = b*H + h sees keys
// [0, kvl) with kvl = min(kv_lens[r], S), causally aligned to the END of that
// range: query t sits at absolute position t + kvl - Tq.  Scores use
// q * D^-0.5 in f32 and a finite NEG_INF mask, as the reference does.
//
// Bound: bytes.  Decode reads each cached key and value once per KV head for
// 2 FLOPs per element per query head, and a 128-token prefill is below the
// ridge too at D = 64, so the time is the K/V (and Q/O) stream.
//
// Design: one block per (row, 32-query tile) with a loop over 32-key tiles
// inside the block; the online-softmax statistics (m, l) and the output
// accumulator stay in registers across the key sweep, so the score matrix
// never reaches device memory.  Key tiles that no query of the block can see
// (past kvl, or above the causal diagonal) are never loaded.  K and V rows at
// or past kvl are loaded as zeros: the cache may hold garbage there
// (uninitialised or stale slots) and a masked score alone would still let
// 0 * NaN poison P.V (attention.py:135-141).  Four threads share a query row
// (eight when D = 128) and meet through warp shuffles.
// Later work (not here): split-KV for decode, mma/wgmma for the two products.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 128;

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lens,
                 T* __restrict__ out, int Tq, int H, int S, int KVH,
                 float scale) {
  constexpr int TPR = THREADS / BQ;  // threads per query row
  constexpr int CPT = BK / TPR;      // score columns per thread
  constexpr int DPT = D / TPR;       // output columns per thread
  static_assert(TPR <= 32 && CPT * TPR == BK && DPT * TPR == D, "tile shape");
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];

  const int row = blockIdx.x;  // b * H + h
  const int b = row / H, h = row % H;
  const int kh = h / (H / KVH);
  const int q0 = blockIdx.y * BQ;
  const int kvl = min(kv_lens[row], S);
  const int off = kvl - Tq;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int qi = e / D, d = e % D, t = q0 + qi;
    Qs[qi][d] = t < Tq ? to_f(q[(((long)b * Tq + t) * H + h) * D + d]) * scale : 0.f;
  }

  float m_run = NEG_INF, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  const int qpos = q0 + r + off;
  // keys at or past kend are invisible to every query row of this block
  const int kend = min(kvl, q0 + BQ + off);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int kj = e / D, d = e % D, s = k0 + kj;
      const bool ok = s < kvl;
      const long idx = (((long)b * S + s) * KVH + kh) * D + d;
      Ks[kj][d] = ok ? to_f(k[idx]) : 0.f;
      Vs[kj][d] = ok ? to_f(v[idx]) : 0.f;
    }
    __syncthreads();

    float sc[CPT];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kj = sub + c * TPR, kpos = k0 + kj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[kj][d], dot);
      sc[c] = (kpos < kvl && qpos >= kpos) ? dot : NEG_INF;
      mx = fmaxf(mx, sc[c]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float p = expf(sc[c] - m_new);
      Ps[r][sub + c * TPR] = p;
      psum += p;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncwarp();  // a row's P is written and read by lanes of one warp
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int dc = sub + j * TPR;
      float a = alpha * acc[j];
#pragma unroll 8
      for (int kj = 0; kj < BK; ++kj) a = fmaf(Ps[r][kj], Vs[kj][dc], a);
      acc[j] = a;
    }
  }

  const int t = q0 + r;
  if (t < Tq) {
    const long base = (((long)b * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[base + sub + j * TPR] = from_f<T>(acc[j] / l_run);
  }
}

template <typename T, int D>
void run(const void* q, const void* k, const void* v, const int* kv_lens,
         void* out, int B, int Tq, int H, int S, int KVH, float scale,
         cudaStream_t stream) {
  constexpr int BT = D <= 64 ? 32 : 16;  // query and key tile
  const dim3 grid(B * H, (Tq + BT - 1) / BT);
  attention_kernel<T, D, BT, BT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_lens, static_cast<T*>(out), Tq, H, S, KVH,
      scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_lens,
             void* out, int B, int Tq, int H, int S, int KVH, int D,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16: run<T, 16>(q, k, v, kv_lens, out, B, Tq, H, S, KVH, scale, s); break;
    case 32: run<T, 32>(q, k, v, kv_lens, out, B, Tq, H, S, KVH, scale, s); break;
    case 64: run<T, 64>(q, k, v, kv_lens, out, B, Tq, H, S, KVH, scale, s); break;
    case 128: run<T, 128>(q, k, v, kv_lens, out, B, Tq, H, S, KVH, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype or head dim).
extern "C" int attention_launch(int dtype, const void* q, const void* k,
                                const void* v, const int* kv_lens, void* out,
                                int B, int Tq, int H, int S, int KVH, int D,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = dispatch<float>(q, k, v, kv_lens, out, B, Tq, H, S, KVH, D, scale, s);
  else if (dtype == DT_BF16)
    err = dispatch<__nv_bfloat16>(q, k, v, kv_lens, out, B, Tq, H, S, KVH, D, scale, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
