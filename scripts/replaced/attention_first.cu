// Flash attention's first CUDA-core design (csrc/attention.cu, route "ffma",
// before its redesign): 128-thread blocks of one (row, query tile), each key
// tile staged synchronously through registers into static shared memory,
// both products as FMAs with two 4-byte shared loads each.  Kept only so
// that chip_smoke.py can time it beside the redesign on the same inputs
// (`replaced_ms` of its attention rows, `replaced_attention`); no path of
// the port calls it.  It takes q in f32 or bf16 and every K/V form and
// mask.  chip_smoke.py builds it with -I src/repro_torch/csrc into
// build/replaced/.
//
// Route "ffma" of flash attention: a query block on the CUDA cores, over the
// KV cache's native layout, dense or paged, with K/V in the model dtype or
// packed int8, for Hopper (sm_90a).  `kernels/attention.py::plan` sends the
// f32 prefill (Tq > 1) here: TF32 tensor cores would change f32 results,
// which the f32 smoke serves gate bitwise in their tokens.  Decode takes
// csrc/attention_splitkv.cu and the bf16 prefill csrc/attention_mma.cu; this
// kernel takes every form and dtype, so chip_smoke.py also times it on their
// inputs (ffma_ms) as the loop they replaced.
//
// Replaces the Pallas kernel `repro/kernels/attention.py` (`_flash_kernel`,
// the cache-layout form with per-row `kv_lens` and GQA folding that prefill
// and ragged slot decode use): the dense call (:329) and the paged call
// (:316, the page table as a scalar-prefetch operand), each with K/V in the
// model dtype or int8 with per-(token, head) f32 scales (:130-134), under
// the causal, prefix-LM or non-causal mask (:117-123, :149-155):
//
//     q (B, Tq, H, D), k/v (B, S, KVH, D), kv_lens (B*H,) -> out (B, Tq, H, D)
//     paged: k/v the pool (num_pages, P, KVH, D), page_table (B, max_pages),
//            logical key s of slot b at pool[page_table[b, s / P], s % P]
//     int8:  k/v int8, k_scales/v_scales in k's layout with D -> 1, f32
//     flat (:234-238, :289-294): q, out (BH, Tq, D), k/v (BH / g, S, D),
//            run as the view (B = BH / g, Tq, H = g, D) with head stride
//            Tq * D and token stride D (the STRIDED instantiations, which
//            take q's and out's strides as arguments) over k/v (B, S, 1, D)
//
// Query head h reads KV head h / (H / KVH).  Row r = b*H + h sees keys
// [0, kvl) with kvl = min(kv_lens[r], S) (S = max_pages * P when paged),
// aligned to the END of that range: query t sits at absolute position t +
// kvl - Tq and sees key j when j <= t + kvl - Tq or j < `prefix`, the keys
// every query sees (0: causal; prefix_len: prefix-LM; S: non-causal).
// Scores use q * D^-0.5 in f32 and a finite NEG_INF mask, as the reference
// does.  An int8 K or V row is multiplied in f32 by its row's scale as it
// is staged, before either product, where the Pallas body does it.
//
// Bound: bytes, then latency.  A 128-token prefill is below the ridge at
// D = 64, so the floor is the K/V (and Q/O) stream; this kernel runs both
// products as f32 FMAs from shared memory and sits far above it.
//
// Design: one block per (row, 32-query tile) with a loop over 32-key tiles
// at fixed absolute positions inside the block; the online-softmax
// statistics (m, l) and the output accumulator stay in registers across the
// key sweep, so the score matrix never reaches device memory.  Key tiles
// that no query of the block can see (past kvl, or above the causal
// diagonal and at or past `prefix`) are never loaded.  Tiles of 32 queries
// and 32 keys to D = 64, 16 and 16 at D = 128, 16 queries and 8 keys at D =
// 256: the static Q, K, V and P tiles stay under the 48 KB a block's
// static shared memory may hold (33,440 B at D = 256).  Each thread finds
// its staged rows' offsets itself (64-bit): the dense row, or the one
// page-table lookup per four elements (`stage_tile`).  Rows at or past kvl are staged as zeros and
// neither their table entry, values nor scales are read: the cache may hold
// garbage there (uninitialised or stale slots, a NaN scale) and a masked
// score alone would still let 0 * NaN poison P.V (attention.py:135-141).
// The paged form runs the dense form's tiles and arithmetic; only the row
// offset differs, so a paged launch is bitwise the dense launch on the
// gathered cache, at any page size.  Four threads share a query row (eight
// when D >= 128) and meet through warp shuffles.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 128;

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;  // int8 K/V: one scale a (token, KV head) row
  const int *kv_lens, *page_table;
  void* out;
  int B, Tq, H, S, KVH, page_size, max_pages, prefix, q_tok, q_head;
  float scale;
};

// Four consecutive K/V elements in one load (4, 8 or 16 bytes), as f32.
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // bf16 -> f32: the high half
  f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// Stage key tile [k0, k0 + BK) of one (slot, KV head) into shared memory as
// f32, zeros at or past kvl.  The dense model-dtype form loads one element
// a thread, straight-line code whose loads the compiler issues together.
// The paged and int8 forms load four elements a thread, so each thread
// looks up a row's page-table entry (key s in pool row table_row[s / P] * P
// + s % P) and its scales once per four elements; dead rows read no entry,
// value or scale.  An int8 value is multiplied by its row's scale in f32.
template <bool PAGED, typename KV, int D, int BK>
__device__ __forceinline__ void stage_tile(const KV* __restrict__ k, const KV* __restrict__ v,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs,
                                           const int* __restrict__ table_row, long long base,
                                           int page_size, int KVH, int kh, int k0, int kvl,
                                           float (&Ks)[BK][D + 1], float (&Vs)[BK][D]) {
  constexpr bool INT8 = sizeof(KV) == 1;
  if constexpr (!PAGED && !INT8) {
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int kj = e / D, d = e % D, s = k0 + kj;
      const bool ok = s < kvl;
      const long long idx = ((base + s) * KVH + kh) * D + d;
      Ks[kj][d] = ok ? to_f(k[idx]) : 0.f;
      Vs[kj][d] = ok ? to_f(v[idx]) : 0.f;
    }
  } else {
    constexpr int D4 = D / 4;
    for (int e = threadIdx.x; e < BK * D4; e += THREADS) {
      const int kj = e / D4, d = (e % D4) * 4, s = k0 + kj;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < kvl) {
        long long row = base + s;
        if constexpr (PAGED) row = (long long)table_row[s / page_size] * page_size + s % page_size;
        const long long ro = row * KVH + kh;
        load4(k + ro * D + d, kf);
        load4(v + ro * D + d, vf);
        if constexpr (INT8) {
          const float sk = ks[ro], sv = vs[ro];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kf[i] *= sk;
            vf[i] *= sv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Ks[kj][d + i] = kf[i];
        Vs[kj][d + i] = vf[i];
      }
    }
  }
}

// PREFIX: `prefix` may be above 0 (prefix-LM, non-causal).  The causal
// instantiation never reads it, so the causal launch's code carries no
// term of the other masks.  STRIDED: q and out have token stride q_tok and
// head stride q_head (the flat layout's view); otherwise neither is read.
template <typename T, typename KV, int D, int BQ, int BK, bool PREFIX, bool STRIDED>
__global__ void __launch_bounds__(THREADS)
attention_first_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ kv_lens,
                 const int* __restrict__ page_table, T* __restrict__ out, int Tq,
                 int H, int S, int KVH, int page_size, int max_pages, int prefix,
                 float scale, int q_tok, int q_head) {
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
  auto q_at = [&](int t) -> long long {  // token t of head h of slot b in q and out
    if constexpr (STRIDED)
      return (long long)b * Tq * H * D + (long long)t * q_tok + (long long)h * q_head;
    else
      return (((long long)b * Tq + t) * H + h) * D;
  };

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int qi = e / D, d = e % D, t = q0 + qi;
    Qs[qi][d] = t < Tq ? to_f(q[q_at(t) + d]) * scale : 0.f;
  }

  float m_run = NEG_INF, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  const int qpos = q0 + r + off;
  // keys at or past kend are invisible to every query row of this block
  int kend = min(kvl, q0 + BQ + off);
  if constexpr (PREFIX) kend = max(kend, min(prefix, kvl));

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    if (page_table)
      stage_tile<true, KV, D, BK>(k, v, ks, vs, page_table + (long long)b * max_pages, 0,
                                  page_size, KVH, kh, k0, kvl, Ks, Vs);
    else
      stage_tile<false, KV, D, BK>(k, v, ks, vs, nullptr, (long long)b * S, page_size, KVH,
                                   kh, k0, kvl, Ks, Vs);
    __syncthreads();

    float sc[CPT];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int kj = sub + c * TPR, kpos = k0 + kj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[kj][d], dot);
      sc[c] = (kpos < kvl && (qpos >= kpos || (PREFIX && kpos < prefix))) ? dot : NEG_INF;
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
    const long long base = q_at(t);
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[base + sub + j * TPR] = from_f<T>(acc[j] / l_run);
  }
}

template <typename T, typename KV, int D>
void run(const Args& a, cudaStream_t stream) {
  constexpr int BQ = D <= 64 ? 32 : 16;                  // query tile
  constexpr int BK = D <= 64 ? 32 : (D <= 128 ? 16 : 8);  // key tile
  const dim3 grid(a.B * a.H, (a.Tq + BQ - 1) / BQ);
  // the cache layout's strides (H = 1: the head stride is never used)
  const bool strided = a.q_tok != a.H * D || (a.H > 1 && a.q_head != D);
  auto kernel = strided ? (a.prefix > 0 ? attention_first_kernel<T, KV, D, BQ, BK, true, true>
                                        : attention_first_kernel<T, KV, D, BQ, BK, false, true>)
                        : (a.prefix > 0 ? attention_first_kernel<T, KV, D, BQ, BK, true, false>
                                        : attention_first_kernel<T, KV, D, BQ, BK, false, false>);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.kv_lens, a.page_table,
      static_cast<T*>(a.out), a.Tq, a.H, a.S, a.KVH, a.page_size, a.max_pages,
      a.prefix, a.scale, a.q_tok, a.q_head);
}

template <typename T, typename KV>
int dispatch(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: run<T, KV, 16>(a, s); break;
    case 32: run<T, KV, 32>(a, s); break;
    case 64: run<T, KV, 64>(a, s); break;
    case 128: run<T, KV, 128>(a, s); break;
    case 256: run<T, KV, 256>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int dispatch_kv(const Args& a, int kv_int8, int D, cudaStream_t s) {
  return kv_int8 ? dispatch<T, int8_t>(a, D, s) : dispatch<T, T>(a, D, s);
}

}  // namespace

// K/V in q's dtype (kv_int8 = 0) or int8 with f32 k_scales/v_scales
// (kv_int8 = 1).  page_table NULL: k/v are the dense cache (B, S, KVH, D);
// otherwise the pool (num_pages, page_size, KVH, D) and S = max_pages *
// page_size.  prefix: keys below it are seen by every query (0 causal, S
// non-causal).  q_tok and q_head: q's (and out's) token and head strides in
// elements (the cache layout's H * D and D, or any other pair: the strided
// instantiations; batch stride Tq * H * D in both).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype, head dim or page size, or a negative prefix).
extern "C" int attention_first_launch(int dtype, int kv_int8, const void* q,
                                      const void* k, const void* v,
                                      const float* k_scales, const float* v_scales,
                                      const int* kv_lens, const int* page_table,
                                      void* out, int B, int Tq, int H, int S, int KVH,
                                      int D, int page_size, int max_pages, int prefix,
                                      int q_tok, int q_head, float scale, void* stream) {
  if ((page_table && page_size < 1) || (kv_int8 && !(k_scales && v_scales)) || prefix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scales, v_scales, kv_lens, page_table, out,
               B, Tq, H, S, KVH, page_size, max_pages, prefix, q_tok, q_head, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == DT_F32)
    err = dispatch_kv<float>(a, kv_int8, D, s);
  else if (dtype == DT_BF16)
    err = dispatch_kv<__nv_bfloat16>(a, kv_int8, D, s);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
