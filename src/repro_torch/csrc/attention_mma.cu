// Route "mma" of flash attention: the bf16 prefill (Tq > 1) on the tensor
// cores, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/attention.py` (`_flash_kernel`)
// for a bf16 query block over the cache layout: the dense call (:329) and
// the paged call (:316), K/V bf16 or int8 with per-(token, head) f32
// scales (:130-134), GQA, head dims 16-256, the causal, prefix-LM and
// non-causal masks (:117-123, :149-155):
//
//     q (B, Tq, H, D), k/v (B, S, KVH, D) or the pool (num_pages, P, KVH, D)
//     with page_table (B, max_pages), kv_lens (B*H,) -> out (B, Tq, H, D)
//
// and the flat layout (:234-238, :289-294) as that layout's view: q and
// out (BH, Tq, D) with g query heads a KV row are (B = BH / g, Tq, H = g,
// D) with a head stride of Tq * D and a token stride of D, and k/v (BH /
// g, S, D) are (B, S, KVH = 1, D) as they sit.  The STRIDED instantiations
// take q's (and out's) token and head strides as arguments; the cache
// layout's instantiations keep their constant strides (H * D and D).
//
// Query head h reads KV head h / (H / KVH) and sees keys [0, kvl), kvl =
// min(kv_lens[b*H + h], S), aligned to the end of that range: query t sits
// at position t + kvl - Tq and sees key j when j <= t + kvl - Tq or j <
// `prefix`, the keys every query sees (0: causal; prefix_len: prefix-LM; S:
// non-causal, every key below kvl).
//
// Bound: bytes, then latency.  A 128-token prefill at D = 64 does ~64 FLOPs
// a byte of Q, K, V and O, below the card's ridge (~295), and its 256
// blocks each see one or two key tiles, so what is left after the bytes is
// the latency of the first copies and of the two products' chains.
//
// Design against it:
//  - a block of 4 warps takes 64 query rows of one (slot, query head), 16 a
//    warp; at D <= 128 the Q fragments stay in registers for the whole key
//    sweep.  At D = 256 a warp's O accumulator alone is 16 x 256 f32, 128
//    registers a thread, and S takes 32 more: Q's 64 fragment registers
//    would push it past 255, so D = 256 reads each k-step's Q fragment
//    from shared memory (ldmatrix) where it is used; its shared memory
//    (168,960 B bf16, 167,424 B int8) holds one block an SM;
//  - S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, f32
//    accumulate), fed by ldmatrix (ldmatrix.trans for V) from shared rows
//    padded by 16 bytes, so the eight rows of a matrix fall in eight bank
//    groups;
//  - key tiles of 64 are double-buffered with cp.async 16-byte copies: the
//    next tile's copies fly while this one is computed.  In the paged form
//    each 16-byte chunk finds its pool row from the table (one lookup a
//    row).  Rows at or past kvl are zero-filled (src-size 0) and neither
//    their table entry, values nor scales are read (the cache may hold
//    garbage there, attention.py:135-141);
//  - the online softmax runs in f32 registers (a row's statistics shared by
//    the 4 threads of a quad); key tiles no row of the block sees (above
//    the causal diagonal of every row and at or past `prefix`, or at or
//    past kvl) are neither loaded nor computed.  Blocks are started last
//    query block first, the longest causal sweep first; under the
//    non-causal mask every block sweeps all of [0, kvl) and the order is
//    moot;
//  - int8 K/V: the staged int8 tile is converted to bf16 in shared memory
//    (exact: |v| <= 127 < 2^8) and the scales are folded in where they
//    commute with the products: k_scale multiplies score column j after
//    Q K^T, v_scale multiplies P's column j before P is rounded for P V.
//    The dequantization stays in f32, where the Pallas body puts it.
//
// Rounding, against the plain version (and the Pallas body, which keeps P in
// f32, attention.py:162-167): P is rounded to bf16 for the P V product (its
// row sum l is taken in f32 before the rounding); q D^-0.5 is applied to the
// f32 scores after the product, not to q before it (2^-3 is exact for D =
// 64, D^-0.5 is not for D = 128), folded with log2(e) into one multiply
// before exp2.  The per-launch gate stays bf16's rtol = atol = 1.6e-2.
//
// Key tiles sit at fixed absolute positions [64 i, 64 i + 64), so a row's
// bits depend on its kvl, mask, Tq and q alone: a paged launch is bitwise
// the dense launch on the gathered cache, at any S and page size.
#include "mma.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 64;  // query rows a block: 16 a warp
constexpr int BK = 64;  // keys a tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S (16 x 64, eight 8-key tiles) += Q's k-step kk fragment x the key
// tile's 16 columns kk * 16 .. + 15, through ldmatrix from rows of STR
template <int STR>
__device__ __forceinline__ void qk_step(float (&s)[8][4], const uint32_t (&qa)[4],
                                        const __nv_bfloat16* kt_s, int lane, int kk) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t kb[4];
    ldsm_x4(kb, kt_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                    ((lane >> 3) & 1) * 8);
    mma_bf16(s[2 * np], qa, kb[0], kb[1]);
    mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
  }
}

template <typename KV, int D>
struct Smem {
  static constexpr bool INT8 = sizeof(KV) == 1;
  static constexpr int STR = D + 8;  // bf16 row stride: 16 bytes of padding
  static constexpr int Q = BQ * STR * 2;                      // bf16 Q tile
  static constexpr int KVB = (INT8 ? 1 : 2) * BK * STR * 2;  // bf16 K (and V) stages
  static constexpr int RAW = INT8 ? 2 * BK * D : 0;          // int8 K (and V) stages
  static constexpr int SCALES = INT8 ? 2 * BK * 4 : 0;       // k, v scales of a tile
  static constexpr int BYTES = Q + 2 * KVB + 2 * RAW + SCALES;
};

// PREFIX: `prefix` may be above 0 (prefix-LM, non-causal).  The causal
// instantiation never reads it, so the causal launch's code carries no
// term of the other masks.  STRIDED: q and out have token stride q_tok and
// head stride q_head (the flat layout's view); otherwise neither is read.
template <typename KV, int D, bool PREFIX, bool STRIDED>
__global__ void __launch_bounds__(THREADS)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ kv_lens,
                     const int* __restrict__ page_table, __nv_bfloat16* __restrict__ out,
                     int Tq, int H, int S, int KVH, int page_size, int max_pages, int prefix,
                     float scale, int q_tok, int q_head) {
  using L = Smem<KV, D>;
  constexpr bool INT8 = L::INT8;
  constexpr int STR = L::STR;
  constexpr int DC = D / 8;           // 16-byte chunks of a bf16 row
  constexpr int RC = INT8 ? D / 16 : DC;  // 16-byte chunks of a staged K/V row
  constexpr int KD = D / 16;          // k-steps of Q K^T
  constexpr int ND = D / 8;           // 8-column tiles of O
  constexpr bool QREG = D <= 128;     // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q + L::KVB);
  int8_t* K8 = reinterpret_cast<int8_t*>(smem + L::Q + 2 * L::KVB);
  int8_t* V8 = K8 + L::RAW;
  float* kss = reinterpret_cast<float*>(smem + L::Q + 2 * L::KVB + 2 * L::RAW);
  float* vss = kss + BK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row = blockIdx.y, b = row / H, h = row % H, kh = h / (H / KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest key sweeps first
  const int kvl = min(kv_lens[row], S);
  const int off = kvl - Tq;
  // keys at or past kend: no row sees them
  int kend = min(kvl, q0 + BQ + off);
  if constexpr (PREFIX) kend = max(kend, min(prefix, kvl));
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int* table = page_table ? page_table + (long long)b * max_pages : nullptr;

  auto q_at = [&](int t) -> long long {  // token t of head h of slot b in q and out
    if constexpr (STRIDED)
      return (long long)b * Tq * H * D + (long long)t * q_tok + (long long)h * q_head;
    else
      return (((long long)b * Tq + t) * H + h) * D;
  };
  auto row_of = [&](int j) -> long long {  // (pool or cache row) * KVH + kh of key j
    const long long r = table ? (long long)table[j / page_size] * page_size + j % page_size
                              : (long long)b * S + j;
    return r * KVH + kh;
  };
  auto stage = [&](int kt, int st) {  // key tile kt into stage st
    for (int e = tid; e < BK * RC; e += THREADS) {
      const int r = e / RC, c = e % RC, j = kt * BK + r;
      const bool live = j < kvl;
      const long long src = live ? row_of(j) * D + c * (16 / sizeof(KV)) : 0;
      if constexpr (INT8) {
        cp_async16(K8 + (st * BK + r) * D + c * 16, k + src, live);
        cp_async16(V8 + (st * BK + r) * D + c * 16, v + src, live);
      } else {
        cp_async16(Ks + (st * BK + r) * STR + c * 8, k + src, live);
        cp_async16(Vs + (st * BK + r) * STR + c * 8, v + src, live);
      }
    }
  };

  for (int e = tid; e < BQ * DC; e += THREADS) {
    const int r = e / DC, c = e % DC, t = q0 + r;
    const bool live = t < Tq;
    cp_async16(Qs + r * STR + c * 8,
               q + (live ? q_at(t) + c * 8 : 0), live);
  }
  if (ntiles > 0) stage(0, 0);
  cp_async_commit();

  uint32_t qf[QREG ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const float c = scale * LOG2E;
  const int qrow = q0 + warp * 16 + gid;  // this thread's rows: qrow, qrow + 8
  const int qpos[2] = {qrow + off, qrow + 8 + off};

  for (int kt = 0; kt < ntiles; ++kt) {
    const int st = INT8 ? 0 : kt & 1;
    if (kt + 1 < ntiles) stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (QREG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * STR + kk * 16 + (lane >> 4) * 8);
      }
    }
    if constexpr (INT8) {  // stage kt & 1 -> bf16 (exact), and the tile's scales
      const int8_t* k8 = K8 + (kt & 1) * BK * D;
      const int8_t* v8 = V8 + (kt & 1) * BK * D;
      for (int e = tid; e < BK * RC; e += THREADS) {
        const int r = e / RC, cc = e % RC;
        const uint4 kw = *reinterpret_cast<const uint4*>(k8 + r * D + cc * 16);
        const uint4 vw = *reinterpret_cast<const uint4*>(v8 + r * D + cc * 16);
        const uint32_t kx[4] = {kw.x, kw.y, kw.z, kw.w}, vx[4] = {vw.x, vw.y, vw.z, vw.w};
        uint32_t kb[8], vb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int w = i >> 1, sh = (i & 1) * 16;
          kb[i] = pack_bf16(static_cast<float>(static_cast<int8_t>(kx[w] >> sh)),
                            static_cast<float>(static_cast<int8_t>(kx[w] >> (sh + 8))));
          vb[i] = pack_bf16(static_cast<float>(static_cast<int8_t>(vx[w] >> sh)),
                            static_cast<float>(static_cast<int8_t>(vx[w] >> (sh + 8))));
        }
        uint4* kd = reinterpret_cast<uint4*>(Ks + r * STR + cc * 16);
        uint4* vd = reinterpret_cast<uint4*>(Vs + r * STR + cc * 16);
        kd[0] = make_uint4(kb[0], kb[1], kb[2], kb[3]);
        kd[1] = make_uint4(kb[4], kb[5], kb[6], kb[7]);
        vd[0] = make_uint4(vb[0], vb[1], vb[2], vb[3]);
        vd[1] = make_uint4(vb[4], vb[5], vb[6], vb[7]);
      }
      if (tid < BK) {
        const int j = kt * BK + tid;
        const bool live = j < kvl;
        const long long ro = live ? row_of(j) : 0;
        kss[tid] = live ? ks[ro] : 0.f;
        vss[tid] = live ? vs[ro] : 0.f;
      }
      __syncthreads();
    }
    const __nv_bfloat16* kt_s = Ks + st * BK * STR;
    const __nv_bfloat16* vt_s = Vs + st * BK * STR;

    // S = Q K^T: 16 x 64 a warp, eight 8-key tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (QREG) {
        qk_step<STR>(s, qf[kk], kt_s, lane, kk);
      } else {  // D = 256: this k-step's Q fragment from shared memory
        uint32_t qs[4];
        ldsm_x4(qs, Qs + (warp * 16 + (lane & 15)) * STR + kk * 16 + (lane >> 4) * 8);
        qk_step<STR>(s, qs, kt_s, lane, kk);
      }
    }
    // mask, scale (after the product), online softmax in the log2 domain
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n * 8 + 2 * tig + (i & 1), kpos = kt * BK + col, rr = i >> 1;
        float x = s[n][i];
        if constexpr (INT8) x *= kss[col];
        x = (kpos < kvl && (kpos <= qpos[rr] || (PREFIX && kpos < prefix))) ? x * c : NEG_INF;
        s[n][i] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      alpha[rr] = exp2f(m_run[rr] - mx[rr]);
      m_run[rr] = mx[rr];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - mx[i >> 1]);
        lsum[i >> 1] += p;
        s[n][i] = INT8 ? p * vss[n * 8 + 2 * tig + (i & 1)] : p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l_run[rr] = alpha[rr] * l_run[rr] + lsum[rr];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: P (bf16) from the score registers, V through ldmatrix.trans
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt_s + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage (and the converted tile) may be refilled now
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = qrow + rr * 8;
    if (t >= Tq) continue;
    __nv_bfloat16* orow = out + q_at(t);
    const float inv_l = 1.f / l_run[rr];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tig) =
          pack_bf16(o[n][2 * rr] * inv_l, o[n][2 * rr + 1] * inv_l);
  }
}

template <typename KV, int D, bool PREFIX, bool STRIDED>
int run(const void* q, const void* k, const void* v, const float* ks, const float* vs,
        const int* kv_lens, const int* page_table, void* out, int B, int Tq, int H, int S,
        int KVH, int page_size, int max_pages, int prefix, float scale, int q_tok, int q_head,
        cudaStream_t stream) {
  auto kernel = attention_mma_kernel<KV, D, PREFIX, STRIDED>;
  constexpr int SMEM = Smem<KV, D>::BYTES;
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, kv_lens, page_table,
      static_cast<__nv_bfloat16*>(out), Tq, H, S, KVH, page_size, max_pages, prefix, scale,
      q_tok, q_head);
  return 0;
}

template <typename KV, bool STRIDED>
int dispatch(int D, const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* kv_lens, const int* page_table, void* out, int B,
             int Tq, int H, int S, int KVH, int page_size, int max_pages, int prefix,
             float scale, int q_tok, int q_head, cudaStream_t s) {
#define CASE(DD)                                                                             \
  case DD:                                                                                   \
    return prefix > 0                                                                        \
               ? run<KV, DD, true, STRIDED>(q, k, v, ks, vs, kv_lens, page_table, out, B, Tq, \
                                            H, S, KVH, page_size, max_pages, prefix, scale,  \
                                            q_tok, q_head, s)                                \
               : run<KV, DD, false, STRIDED>(q, k, v, ks, vs, kv_lens, page_table, out, B,   \
                                             Tq, H, S, KVH, page_size, max_pages, 0, scale,  \
                                             q_tok, q_head, s);
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

// Prefill attention in bf16 on the tensor cores.  K/V bf16 (kv_int8 = 0) or
// int8 with f32 k_scales/v_scales (kv_int8 = 1); page_table NULL: k/v are
// the dense cache (B, S, KVH, D), otherwise the pool and S = max_pages *
// page_size.  prefix: keys below it are seen by every query (0 causal, S
// non-causal).  Returns the number of dynamic shared-memory bytes of the
// (kv_int8, D) instantiation, or 0 for one that does not exist.
extern "C" int attention_mma_smem_bytes(int kv_int8, int D) {
  switch (D) {
    case 16: return kv_int8 ? Smem<int8_t, 16>::BYTES : Smem<__nv_bfloat16, 16>::BYTES;
    case 32: return kv_int8 ? Smem<int8_t, 32>::BYTES : Smem<__nv_bfloat16, 32>::BYTES;
    case 64: return kv_int8 ? Smem<int8_t, 64>::BYTES : Smem<__nv_bfloat16, 64>::BYTES;
    case 128: return kv_int8 ? Smem<int8_t, 128>::BYTES : Smem<__nv_bfloat16, 128>::BYTES;
    case 256: return kv_int8 ? Smem<int8_t, 256>::BYTES : Smem<__nv_bfloat16, 256>::BYTES;
    default: return 0;
  }
}

// q_tok and q_head: q's (and out's) token and head strides in elements;
// the cache layout's H * D and D take its own instantiations (so does H =
// 1, whose head stride is never used), any other pair the strided ones
// (batch stride Tq * H * D in both).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for what the kernel does not take: a head
// dim outside 16-256, B * H above 65535, q, k or v not 16-byte aligned, a
// negative prefix, strides off 8 elements).
extern "C" int attention_mma_launch(int kv_int8, const void* q, const void* k, const void* v,
                                    const float* k_scales, const float* v_scales,
                                    const int* kv_lens, const int* page_table, void* out,
                                    int B, int Tq, int H, int S, int KVH, int D, int page_size,
                                    int max_pages, int prefix, int q_tok, int q_head,
                                    float scale, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if ((page_table && page_size < 1) || (kv_int8 && !(k_scales && v_scales)) || KVH < 1 ||
      H % KVH || B * H > 65535 || Tq < 1 || prefix < 0 || !aligned(q) || !aligned(k) ||
      !aligned(v) || q_tok % 8 || q_head % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool strided = q_tok != H * D || (H > 1 && q_head != D);
#define GO(KV, STRIDED)                                                                      \
  dispatch<KV, STRIDED>(D, q, k, v, k_scales, v_scales, kv_lens, page_table, out, B, Tq, H, \
                        S, KVH, page_size, max_pages, prefix, scale, q_tok, q_head, s)
  const int err = kv_int8 ? (strided ? GO(int8_t, true) : GO(int8_t, false))
                          : (strided ? GO(__nv_bfloat16, true) : GO(__nv_bfloat16, false));
#undef GO
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
