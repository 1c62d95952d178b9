// Route "splitkv" of flash attention: one query token a row (decode), the
// keys split across blocks, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/attention.py` (`_flash_kernel`)
// at Tq = 1, the ragged slot decode of every serve: the dense call (:329)
// and the paged call (:316), K/V in the model dtype (f32, bf16) or int8
// with per-(token, head) f32 scales (:130-134), GQA, head dims 16-256, under
// every mask: at one query, at position kvl - 1, the causal, prefix-LM and
// non-causal masks (:117-123, :149-155) all see exactly [0, kvl), so the
// kernel has no mask code:
//
//     q (B, 1, H, D), k/v (B, S, KVH, D) or the pool (num_pages, P, KVH, D)
//     with page_table (B, max_pages), kv_lens (B*H,) -> out (B, 1, H, D)
//
// Query head h reads KV head h / G (G = H / KVH) and sees keys [0, kvl),
// kvl = min(kv_lens[b*H + h], S).  Scores are (q * D^-0.5) . k in f32 with
// a finite NEG_INF mask, as the reference computes them; an int8 row's
// scale multiplies its score after the dot and its probability before the
// P.V product (both in f32, as the Pallas body dequantizes in f32).
//
// Bound: bytes.  A decode step reads every live K/V element once for 2
// FLOPs a query head, so the time is the cache stream: at S = 4096, B = 4,
// H = 32, D = 64 in bf16 that is 134 MB, 40 us at 3.35 TB/s.
//
// Design against it:
//  - the keys are cut at fixed absolute positions into splits of `chunk`
//    keys (split j covers [j*chunk, (j+1)*chunk) ∩ [0, kvl)); a block takes
//    `per_block` consecutive splits of one (slot, KV head) and computes each
//    split's partials as if it were alone, so the grid can fill the card at
//    any S (a 4-slot decode with chunk 128: 256 blocks of one split at S =
//    160, 1408 blocks of 3 at S = 4096, where the first design ran 128
//    blocks that each walked the whole row) while a row's bits depend on the
//    chunk alone;
//  - a block holds all G query heads of its KV head and loads each K/V
//    element once for all of them (in passes of GB = 4 heads when G > 4);
//  - every load is 16 bytes a thread, neighbouring threads on neighbouring
//    addresses: a K/V row of D elements is D / E threads (E = 4 f32, 8 bf16,
//    16 int8), and the block holds RG = 128 / (D / E) rows at a time.  A
//    row stays within one warp (its dot products meet through shuffles), so
//    where D / E would pass 32 (f32 at D = 256) a thread takes W = 2
//    consecutive 16-byte pieces of its row (E = 8, 32 threads a row);
//  - a thread loads the K and V of NB rows at once (4, or 2 for a group of
//    query heads) straight into registers, and the next NB rows' loads
//    (across split boundaries) fly while these are used: the latency of a
//    chain of dependent loads, not the bytes, held the first version of
//    this kernel to 45% of the byte bound at S = 4096 and 9% at S = 160;
//  - each row group (the D / E threads of a row) keeps a running softmax
//    (m, l, acc[E]) per query head over its rows, with no shared memory and
//    no barrier in the key loop; a fixed shuffle tree merges the row groups
//    of a warp and a fixed walk the 4 warps;
//  - each split writes (m, l, acc[D]) in f32 per query head to a workspace
//    that the wrapper allocates with torch.empty.
//
// The combine, in the same launch: the last block of a (slot, KV head) to
// finish takes an int ticket (atomicAdd after __threadfence) equal to the
// number of splits, reads the partials of splits 0, 1, ... in that order and
// writes out = sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M) l_j with M =
// max_j m_j, then resets the ticket to 0 for the next launch.  One launch
// and not a second combine kernel, because a decode step is host-bound and
// every launch costs the host microseconds; no floating-point atomics, so two
// launches on the same inputs give the same bits.
//
// Keys at or past kvl are never read: not their table entry, not their
// values, not their scales (the cache may hold garbage there; 0 * NaN would
// poison P.V, attention.py:135-141).  A split that starts at or past every
// kvl of the group loads nothing; the combine of head h reads only the
// ceil(kvl / chunk) splits that start below its kvl.  So a row's bits depend
// on its kvl and the chunk alone, not on S or the page size: a paged launch
// is bitwise the dense launch on the gathered cache, whatever S the pool
// gives.
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 4096;

// 16 bytes of K/V: E elements as f32 (int8: the integer values, exact)
template <typename KV> struct Row16 {
  static constexpr int E = Vec<KV>::N;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[E]) {
    Vec<KV>::unpack(r, f);
  }
};
template <> struct Row16<int8_t> {
  static constexpr int E = 16;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[E]) {
    unpack_i8(r, f);
  }
};

template <typename T, typename KV, int D, int GB>
__global__ void __launch_bounds__(THREADS)
attention_splitkv_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                         const KV* __restrict__ v, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ kv_lens,
                         const int* __restrict__ page_table, T* __restrict__ out,
                         float* __restrict__ part, int* __restrict__ tickets, int H, int S,
                         int KVH, int page_size, int max_pages, int chunk, int nsplit,
                         int per_block, float scale) {
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int E16 = Row16<KV>::E;    // elements of one 16-byte load
  constexpr int W = (D / E16 + 31) / 32;  // 16-byte loads a thread a row
  constexpr int E = W * E16;         // elements a thread a row
  constexpr int TPR = D / E;         // threads a K/V row
  constexpr int RG = THREADS / TPR;  // rows the block holds at a time
  constexpr int NB = GB == 1 ? 4 : 2;  // rows a thread loads at once: a batch
  static_assert(TPR >= 1 && TPR <= 32 && TPR * E == D, "row shape");
  __shared__ float red[WARPS][GB][D];
  __shared__ float red_ml[WARPS][GB][2];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid / TPR, cg = tid % TPR;
  const int bk = blockIdx.y, b = bk / KVH, kh = bk % KVH;
  const int G = H / KVH, h0 = kh * G;
  const int* lens = kv_lens + (long long)b * H + h0;
  const int* table = page_table ? page_table + (long long)b * max_pages : nullptr;
  int kvl_max = 0;
  for (int g = 0; g < G; ++g) kvl_max = max(kvl_max, min(lens[g], S));
  // this block's splits: c0, c0 + 1, ... below c1 that start below kvl_max,
  // each in batches of NB * RG rows
  const int c0 = blockIdx.x * per_block;
  const int c1 = min(min(c0 + per_block, nsplit), (kvl_max + chunk - 1) / chunk);
  const int per_split = (chunk + NB * RG - 1) / (NB * RG);
  const int batches = max(0, c1 - c0) * per_split;
  float* part_acc = part;
  float* part_ml = part + (long long)gridDim.y * nsplit * G * D;

  // Batch t: rows r0 + i * RG + rg (i < NB) of split c0 + t / per_split,
  // W * 16 bytes of K and of V a row (zeros for rows that are not read) and
  // the int8 scales.
  struct Batch {
    uint4 k[NB][W], v[NB][W];
    float ks[NB], vs[NB];
  };
  // row piece of a batch -> E floats
  auto unpack = [](const uint4(&r)[W], float(&f)[E]) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float part[E16];
      Row16<KV>::unpack(r[w], part);
#pragma unroll
      for (int e = 0; e < E16; ++e) f[w * E16 + e] = part[e];
    }
  };
  auto load = [&](int t, Batch& bt) {
    const int j0 = (c0 + t / per_split) * chunk, r0 = (t % per_split) * NB * RG;
    const int jend = min(j0 + chunk, kvl_max);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int r = r0 + i * RG + rg, j = j0 + r;
#pragma unroll
      for (int w = 0; w < W; ++w) bt.k[i][w] = bt.v[i][w] = make_uint4(0u, 0u, 0u, 0u);
      bt.ks[i] = bt.vs[i] = 0.f;
      if (r < chunk && j < jend) {
        const long long r_ = table ? (long long)table[j / page_size] * page_size + j % page_size
                                   : (long long)b * S + j;
        const long long ro = r_ * KVH + kh;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          bt.k[i][w] = __ldg(reinterpret_cast<const uint4*>(k + ro * D + cg * E + w * E16));
          bt.v[i][w] = __ldg(reinterpret_cast<const uint4*>(v + ro * D + cg * E + w * E16));
        }
        if constexpr (INT8) {
          bt.ks[i] = ks[ro];
          bt.vs[i] = vs[ro];
        }
      }
    }
  };

  for (int g0 = 0; g0 < G && batches > 0; g0 += GB) {
    float qr[GB][E];
    int kvl[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const int hg = g0 + g;
      kvl[g] = hg < G ? min(lens[hg], S) : 0;
      const T* qh = q + ((long long)b * H + h0 + min(hg, G - 1)) * D + cg * E;
#pragma unroll
      for (int e0 = 0; e0 < E; e0 += Vec<T>::N) {  // 16-byte loads
        float f[Vec<T>::N];
        load16(qh + e0, f);
#pragma unroll
        for (int e = 0; e < Vec<T>::N; ++e) qr[g][e0 + e] = hg < G ? f[e] * scale : 0.f;
      }
    }
    // a running softmax per (row group, head) over its rows of one split
    float m[GB], l[GB], acc[GB][E];
    Batch cur, nxt;
    load(0, cur);
    for (int t = 0; t < batches; ++t) {
      if (t % per_split == 0) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          m[g] = NEG_INF;
          l[g] = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
        }
      }
      if (t + 1 < batches) load(t + 1, nxt);  // in flight while cur is used
      const int split = c0 + t / per_split, j0 = split * chunk;
      const int r0 = (t % per_split) * NB * RG, jend = min(j0 + chunk, kvl_max);
      float s[NB][GB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float kf[E];
        unpack(cur.k[i], kf);
        const int r = r0 + i * RG + rg, j = j0 + r;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
#pragma unroll
          for (int o = TPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          const bool live = r < chunk && j < jend && j < kvl[g];
          s[i][g] = live ? (INT8 ? dot * cur.ks[i] : dot) : NEG_INF;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = m[g];
#pragma unroll
        for (int i = 0; i < NB; ++i) mx = fmaxf(mx, s[i][g]);
        const float alpha = expf(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          if (!(s[i][g] > NEG_INF)) continue;  // not a key of this head: adds nothing
          float vf[E];
          unpack(cur.v[i], vf);
          const float p = expf(s[i][g] - mx);
          l[g] += p;
          const float pv = INT8 ? p * cur.vs[i] : p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
        }
      }
      cur = nxt;
      if ((t + 1) % per_split) continue;
      // the split is done: merge the row groups (a fixed shuffle tree in the
      // warp, then the warps in order) and write its partials
#pragma unroll
      for (int o = 16; o >= TPR; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
          const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
          const float mx = fmaxf(m[g], mo);
          const float wa = expf(m[g] - mx), wb = expf(mo - mx);
          l[g] = wa * l[g] + wb * lo;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
            acc[g][e] = wa * acc[g][e] + wb * ao;
          }
          m[g] = mx;
        }
      }
      if (lane < TPR) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int e = 0; e < E; ++e) red[warp][g][cg * E + e] = acc[g][e];
          if (cg == 0) {
            red_ml[warp][g][0] = m[g];
            red_ml[warp][g][1] = l[g];
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < GB * D; i += THREADS) {
        const int g = i / D, d = i % D, hg = g0 + g;
        if (hg >= G) continue;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_ml[w][g][0]);
        float a = 0.f, ls = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float wt = expf(red_ml[w][g][0] - mx);
          ls += wt * red_ml[w][g][1];
          a += wt * red[w][g][d];
        }
        const long long p = ((long long)bk * nsplit + split) * G + hg;
        part_acc[p * D + d] = a;
        if (d == 0) {
          part_ml[2 * p] = mx;
          part_ml[2 * p + 1] = ls;
        }
      }
      __syncthreads();  // red and red_ml are reused by the next split
    }
  }

  // the last block of this (slot, KV head) to finish combines its splits
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[bk], 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) tickets[bk] = 0;
  for (int i = tid; i < G * D; i += THREADS) {
    const int hg = i / D, d = i % D;
    const int n = (min(lens[hg], S) + chunk - 1) / chunk;  // splits below kvl
    const long long p0 = (long long)bk * nsplit * G + hg;
    float mx = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < n; ++s) mx = fmaxf(mx, __ldcg(part_ml + 2 * (p0 + (long long)s * G)));
    float ls = 0.f, o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const long long p = p0 + (long long)s * G;
      const float w = expf(__ldcg(part_ml + 2 * p) - mx);
      ls += w * __ldcg(part_ml + 2 * p + 1);
      o += w * __ldcg(part_acc + p * D + d);
    }
    out[((long long)b * H + h0 + hg) * D + d] = from_f<T>(o / ls);
  }
}

template <typename T, typename KV, int D>
int run(const void* q, const void* k, const void* v, const float* ks, const float* vs,
        const int* kv_lens, const int* page_table, void* out, float* work, int* tickets,
        int B, int H, int S, int KVH, int page_size, int max_pages, int chunk, int splits,
        int per_block, float scale, cudaStream_t stream) {
  const dim3 grid((splits + per_block - 1) / per_block, B * KVH);
  const int G = H / KVH;
#define ARGS                                                                              \
  static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, \
      kv_lens, page_table, static_cast<T*>(out), work, tickets, H, S, KVH, page_size,     \
      max_pages, chunk, splits, per_block, scale
  if (G == 1)
    attention_splitkv_kernel<T, KV, D, 1><<<grid, THREADS, 0, stream>>>(ARGS);
  else
    attention_splitkv_kernel<T, KV, D, 4><<<grid, THREADS, 0, stream>>>(ARGS);
#undef ARGS
  return 0;
}

template <typename T, typename KV>
int dispatch(int D, const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* kv_lens, const int* page_table, void* out,
             float* work, int* tickets, int B, int H, int S, int KVH, int page_size,
             int max_pages, int chunk, int splits, int per_block, float scale,
             cudaStream_t s) {
#define CASE(DD)                                                                          \
  case DD:                                                                                \
    return run<T, KV, DD>(q, k, v, ks, vs, kv_lens, page_table, out, work, tickets, B, H, \
                          S, KVH, page_size, max_pages, chunk, splits, per_block, scale, s);
  switch (D) {
    CASE(16)
    CASE(32)
    CASE(64)
    CASE(128)
    CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}

}  // namespace

// Decode attention (Tq = 1) with the keys split into `splits` = ceil(S /
// chunk) chunks, per_block consecutive ones a block.  K/V in q's dtype (kv_int8 = 0) or int8 with f32
// k_scales/v_scales (kv_int8 = 1); page_table NULL: k/v are the dense cache
// (B, S, KVH, D), otherwise the pool and S = max_pages * page_size.  work:
// B * KVH * splits * (H / KVH) * (D + 2) floats, no initial value; tickets:
// B * KVH ints, 0 on entry and 0 again when the launch ends.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for what the
// kernel does not take: dtype, head dim, chunk outside [1, 4096], a split
// count other than ceil(S / chunk), k/v not 16-byte aligned).
extern "C" int attention_splitkv_launch(int dtype, int kv_int8, const void* q, const void* k,
                                        const void* v, const float* k_scales,
                                        const float* v_scales, const int* kv_lens,
                                        const int* page_table, void* out, float* work,
                                        int* tickets, int B, int H, int S, int KVH, int D,
                                        int page_size, int max_pages, int chunk, int splits,
                                        int per_block, float scale, void* stream) {
  if ((page_table && page_size < 1) || (kv_int8 && !(k_scales && v_scales)) || KVH < 1 ||
      H % KVH || chunk < 1 || chunk > MAX_CHUNK || S < 1 || splits != (S + chunk - 1) / chunk ||
      per_block < 1 ||
      !aligned16(k) || !aligned16(v) || !work || !tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define GO(T, KV)                                                                          \
  dispatch<T, KV>(D, q, k, v, k_scales, v_scales, kv_lens, page_table, out, work, tickets, \
                  B, H, S, KVH, page_size, max_pages, chunk, splits, per_block, scale, s)
  if (dtype == DT_F32)
    err = kv_int8 ? GO(float, int8_t) : GO(float, float);
  else if (dtype == DT_BF16)
    err = kv_int8 ? GO(__nv_bfloat16, int8_t) : GO(__nv_bfloat16, __nv_bfloat16);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
#undef GO
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
