// Route "ffma" of flash attention: an f32 query block (Tq > 1) on the CUDA
// cores, over the KV cache's native layout, dense or paged, with K/V in f32
// or packed int8, for Hopper (sm_90a).  `kernels/attention.py::plan` sends
// the f32 prefill here with the tile it launches (`Plan.block_q`,
// `Plan.block_k`): TF32 tensor cores would change f32 results, which the
// f32 smoke serves gate in their greedy tokens.  Decode takes
// csrc/attention_splitkv.cu and the bf16 prefill csrc/attention_mma.cu.
//
// Replaces the Pallas kernel `repro/kernels/attention.py` (`_flash_kernel`,
// the cache-layout form with per-row `kv_lens` and GQA folding that prefill
// and ragged slot decode use): the dense call (:329) and the paged call
// (:316, the page table as a scalar-prefetch operand), each with K/V in f32
// or int8 with per-(token, head) f32 scales (:130-134), under the causal,
// prefix-LM or non-causal mask (:117-123, :149-155):
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
// does.  An int8 K or V row is multiplied in f32 by its row's scale before
// either product, where the Pallas body does it.
//
// Bound: operations.  Both products run as f32 FFMA (67 TFLOP/s): whisper's
// encoder (T = 1500, D = 64, non-causal) does ~690 us of them on ~62 MB.
// The first design (scripts/replaced/attention_first.cu) read both operands
// of every FFMA from shared memory (two 4-byte loads an FMA), staged each
// key tile synchronously through registers and kept its tiles under 48 KB
// of static shared memory (16 x 8 at D = 256): 14% of the bound there.
// What caps an FFMA body fed from shared memory is the floats the SM moves
// from shared memory into registers, 32 a cycle against 128 FMAs: a thread
// has to do 4 FMAs a float it loads to keep the FFMA pipes busy.
//
// Design against it:
//  - a block of 4 warps takes BQ queries of one (slot, query head) row: 64
//    at D <= 128, 32 at D = 256 (`Tile`), the longest causal sweeps first,
//    two blocks an SM (one at D = 256); Q is staged once, pre-scaled by
//    D^-0.5 log2(e), in rows padded by 16 bytes;
//  - K/V tiles of BK keys (fixed by D alone: 64 to D = 64, 32 above) come
//    by cp.async 16-byte copies into a ring of 2-3 stages in dynamic shared
//    memory; the next tiles' copies fly while this one multiplies.  Rows at
//    or past kvl are zero-filled (src-size 0): neither their table entry,
//    values nor scales are read (the cache may hold garbage there and a
//    masked score alone would still let 0 * NaN poison P V,
//    attention.py:135-141).  8 lanes copy 128 contiguous bytes of a key
//    row at once and find its cache or pool row (its page-table entry) once
//    a tile;
//  - int8 K/V: the ring holds the bytes and the row scales; once a tile has
//    landed the block converts it into one f32 K and V tile, each value
//    (exact, by a byte permute and one subtraction: I2F runs at a quarter
//    of the FMA rate) times its row's scale in f32, the single multiply
//    before either product, so no thread converts a value twice;
//  - S = Q K^T: a warp takes BQ / 4 query rows and all BK keys, a thread TM
//    rows x TN keys (rows ty + SY i, keys tx + SX j of lane SX ty + tx; 4 x
//    8 at BQ = BK = 64): each 4 d-steps cost TM + TN 16-byte shared loads
//    for 4 TM TN FFMAs, 2.7 FMAs a float.  The 8 keys or rows a quarter
//    warp loads sit in distinct bank groups (rows padded by 4 floats);
//  - the online softmax (log2 domain, exp2) keeps each row's running max
//    and sum in the registers of its SX lanes, met by shuffles; the tile's
//    P and each row's rescale factor go to shared memory;
//  - O += P V: warps WY x WX over the BQ x D output, a thread TMO rows x
//    TD4 16-byte groups of d kept in registers across the key sweep (4 x 8
//    floats at D = 64); each 4 keys cost TMO + 4 TD4 16-byte loads (P rows,
//    V rows contiguous along d) for 16 TMO TD4 FFMAs;
//  - key tiles that no query of the block sees (past kvl, or above the
//    causal diagonal and at or past `prefix`) are never copied; a tile every
//    row sees whole skips the mask.
// Larger tiles a thread would need more registers or more shared memory
// than two blocks an SM leave: PERF.md has the variants measured against
// this one (scripts/torch_attention_study.py ffma).
// Every product and sum runs in one fixed order set by D alone, and tiles
// sit at fixed absolute key positions: a row's bits depend on its kvl, its
// mask and D, never on B, S, the page size or the query tiling, so a paged
// launch is bitwise the dense launch on the gathered cache.  No atomics.
#include "mma.cuh"

using namespace rt;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// Four int8 values (one little-endian word) as f32, each times s: a byte b
// + 128 is placed under the exponent of 2^23 (one byte permute) and 2^23 +
// 128 subtracted, exactly b, without the quarter-rate I2F.
__device__ __forceinline__ float4 s8x4_scaled(uint32_t w, float s) {
  const uint32_t u = w ^ 0x80808080u;  // each byte b + 128, unsigned
  auto f = [&](uint32_t sel) {
    return (__uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f) * s;
  };
  return make_float4(f(0x7540), f(0x7541), f(0x7542), f(0x7543));
}

// The tile a head dim runs (kernels/attention.py FFMA_TILES names BQ and
// BK): threads a block, queries and keys a block, the ring's stages, lanes
// along the keys in S (SX), warps along d in P V (WX), blocks an SM the
// registers are capped for.
template <int D> struct Tile;
template <> struct Tile<16> {
  static constexpr int THREADS = 128, BQ = 64, BK = 64, STAGES = 3, SX = 8, WX = 1, BLOCKS = 2;
};
template <> struct Tile<32> {
  static constexpr int THREADS = 128, BQ = 64, BK = 64, STAGES = 3, SX = 8, WX = 1, BLOCKS = 2;
};
template <> struct Tile<64> {
  static constexpr int THREADS = 128, BQ = 64, BK = 64, STAGES = 2, SX = 8, WX = 1, BLOCKS = 2;
};
template <> struct Tile<128> {
  static constexpr int THREADS = 128, BQ = 64, BK = 32, STAGES = 2, SX = 8, WX = 1, BLOCKS = 2;
};
template <> struct Tile<256> {
  static constexpr int THREADS = 128, BQ = 32, BK = 32, STAGES = 2, SX = 8, WX = 2, BLOCKS = 1;
};

template <typename KV, int D>
struct Cfg {
  static constexpr bool INT8 = sizeof(KV) == 1;
  static constexpr int THREADS = Tile<D>::THREADS, WARPS = THREADS / 32;
  static constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, STAGES = Tile<D>::STAGES;
  // S = Q K^T: lanes SY x SX, a thread TM rows x TN keys
  static constexpr int SX = Tile<D>::SX, SY = 32 / SX;
  static constexpr int TM = BQ / (SY * WARPS), TN = BK / SX;
  // O += P V: warps WY x WX, lanes OY x OX, a thread TMO rows x TD4 float4s
  static constexpr int WX = Tile<D>::WX, WY = WARPS / WX;
  static constexpr int OX = D / 4 < 8 ? D / 4 : 8, OY = 32 / OX;
  static constexpr int TMO = BQ / (OY * WY), TD4 = D / (4 * OX * WX);
  // shared rows in floats: Q and K padded by 4 (the 8 rows or keys of a
  // quarter warp's 16-byte loads in distinct bank groups), P by SX (its
  // stores' SY rows of SX keys in distinct banks)
  static constexpr int QSTR = D + 4, KSTR = D + 4, VSTR = D, PSTR = BK + SX;
  static constexpr int KF = BK * KSTR, VF = BK * VSTR;  // an f32 K, V tile
  static constexpr int HEAD = BQ * QSTR + BQ * PSTR + 2 * BQ;  // Q, P, alpha, l
  // a ring stage: the f32 K and V tiles, or the int8 ones and their scales
  static constexpr int STAGE = INT8 ? 2 * BK * D + 2 * BK * 4 : (KF + VF) * 4;
  static constexpr int BYTES = HEAD * 4 + STAGES * STAGE + (INT8 ? (KF + VF) * 4 : 0);
  static constexpr int MIN_BLOCKS = Tile<D>::BLOCKS;
  static_assert(TM >= 1 && TM * SY * WARPS == BQ && TN * SX == BK, "S tile");
  static_assert(TMO >= 1 && TMO * OY * WY == BQ && TD4 >= 1 && TD4 * 4 * OX * WX == D,
                "O tile");
  static_assert(BK % 32 == 0 && D % 16 == 0 && HEAD % 4 == 0 && STAGE % 16 == 0, "layout");
  static_assert(MIN_BLOCKS * (BYTES + 1024) <= 233472, "shared memory");
};

// PREFIX: `prefix` may be above 0 (prefix-LM, non-causal).  The causal
// instantiation never reads it, so the causal launch's code carries no
// term of the other masks.  STRIDED: q and out have token stride q_tok and
// head stride q_head (the flat layout's view); otherwise neither is read.
// BQ and BK name the tile (Cfg's) in the kernel's symbol.
template <typename KV, int D, int BQ, int BK, bool PREFIX, bool STRIDED>
__global__ void __launch_bounds__(Cfg<KV, D>::THREADS, Cfg<KV, D>::MIN_BLOCKS)
attention_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ kv_lens,
                 const int* __restrict__ page_table, float* __restrict__ out, int Tq, int H,
                 int S, int KVH, int page_size, int max_pages, int prefix, float scale,
                 int q_tok, int q_head) {
  using C = Cfg<KV, D>;
  static_assert(BQ == C::BQ && BK == C::BK, "the tile of this head dim");
  constexpr bool INT8 = C::INT8;
  constexpr int THREADS = C::THREADS, STAGES = C::STAGES, TM = C::TM, TN = C::TN;
  constexpr int SX = C::SX, SY = C::SY;
  constexpr int TMO = C::TMO, TD4 = C::TD4, OX = C::OX, OY = C::OY;
  constexpr int QSTR = C::QSTR, KSTR = C::KSTR, VSTR = C::VSTR, PSTR = C::PSTR;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + BQ * QSTR;
  float* alpha_s = Ps + BQ * PSTR;  // each row's rescale factor for this tile
  float* l_s = alpha_s + BQ;        // each row's softmax sum, at the end
  unsigned char* ring = smem + C::HEAD * 4;
  float* Kc = reinterpret_cast<float*>(ring + STAGES * C::STAGE);  // int8: converted tile
  float* Vc = Kc + C::KF;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x, b = row / H, h = row % H, kh = h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest key sweeps first
  const int kvl = min(kv_lens[row], S);
  const int off = kvl - Tq;
  // keys at or past kend: no row of this block sees them
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
  // key tile kt into ring stage st.  LPR (8) lanes share a key row and copy
  // 128 contiguous bytes of it at once (with fewer lanes a row, each 16-byte
  // copy became an L2 request of its own: PERF.md); each lane finds its rows
  // (their page-table entries) once a tile
  auto stage = [&](int kt, int st) {
    unsigned char* base = ring + st * C::STAGE;
    constexpr int CH = INT8 ? D / 16 : D / 4;  // 16-byte copies a row
    constexpr int LPR = CH < 8 ? CH : 8, EL = 16 / (int)sizeof(KV);
    for (int r = tid / LPR; r < BK; r += THREADS / LPR) {
      const int j = kt * BK + r;
      const bool live = j < kvl;
      const long long ro = live ? row_of(j) : 0;
      const KV* krow = k + ro * D;
      const KV* vrow = v + ro * D;
      for (int c = tid % LPR; c < CH; c += LPR) {
        if constexpr (INT8) {
          cp_async16(base + r * D + c * 16, krow + c * EL, live);
          cp_async16(base + (BK + r) * D + c * 16, vrow + c * EL, live);
        } else {
          float* kf = reinterpret_cast<float*>(base);
          cp_async16(kf + r * KSTR + c * 4, krow + c * EL, live);
          cp_async16(kf + C::KF + r * VSTR + c * 4, vrow + c * EL, live);
        }
      }
      if constexpr (INT8) {
        if (tid % LPR == 0) {
          float* sc = reinterpret_cast<float*>(base + 2 * BK * D);
          cp_async4(sc + r, ks + ro, live);
          cp_async4(sc + BK + r, vs + ro, live);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) stage(s, s);
    cp_async_commit();
  }
  const float qscale = scale * LOG2E;  // scores in the log2 domain
  for (int e = tid; e < BQ * (D / 4); e += THREADS) {
    const int r = e / (D / 4), c = e % (D / 4), t = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Tq) x = *reinterpret_cast<const float4*>(q + q_at(t) + 4 * c);
    *reinterpret_cast<float4*>(Qs + r * QSTR + 4 * c) =
        make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
  }

  // S: rows srow + SY i, keys tx + SX j.  O: rows orow + OY i, d ocol + 4 OX j.
  const int ty = lane / SX, tx = lane % SX;
  const int srow = warp * (BQ / C::WARPS) + ty;
  const int wy = warp / C::WX, wx = warp % C::WX;
  const int orow = wy * OY * TMO + lane / OX;
  const int ocol = wx * 4 * OX * TD4 + 4 * (lane % OX);
  float m_run[TM], l_run[TM];  // l_run: this lane's keys only, met at the end
#pragma unroll
  for (int i = 0; i < TM; ++i) m_run[i] = NEG_INF, l_run[i] = 0.f;
  float4 o[TMO][TD4];
#pragma unroll
  for (int i = 0; i < TMO; ++i)
#pragma unroll
    for (int j = 0; j < TD4; ++j) o[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();  // everyone's; and tile kt - 1's stage, P and alpha are consumed
    if (kt + STAGES - 1 < ntiles) stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* base = ring + (kt % STAGES) * C::STAGE;
    const float* Kt = reinterpret_cast<const float*>(base);
    const float* Vt = Kt + C::KF;
    if constexpr (INT8) {  // bytes x row scale -> the f32 tile, once a value
      const int8_t* k8 = reinterpret_cast<const int8_t*>(base);
      const float* sc = reinterpret_cast<const float*>(base + 2 * BK * D);
      constexpr int CH = D / 16;
      for (int e = tid; e < 2 * BK * CH; e += THREADS) {
        const int isv = e >= BK * CH, r = (e - isv * BK * CH) / CH, c = e % CH;
        const uint4 w = *reinterpret_cast<const uint4*>(k8 + (isv * BK + r) * D + c * 16);
        const float s = sc[isv * BK + r];
        float* dst = (isv ? Vc + r * VSTR : Kc + r * KSTR) + c * 16;
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) *reinterpret_cast<float4*>(dst + 4 * u) = s8x4_scaled(ws[u], s);
      }
      __syncthreads();
      Kt = Kc;
      Vt = Vc;
    }

    // S = Q K^T, each score summed over d in order
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qa[TM], kb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (srow + SY * i) * QSTR + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Kt + (tx + SX * j) * KSTR + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          s[i][j] = fmaf(qa[i].w, kb[j].w, a);
        }
    }
    // mask (skipped where every row of the block sees the whole tile)
    const int k0 = kt * BK;
    const bool whole = k0 + BK <= kvl &&
                       (k0 + BK - 1 <= q0 + off || (PREFIX && k0 + BK <= prefix));
    if (!whole) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int qpos = q0 + srow + SY * i + off;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int kpos = k0 + tx + SX * j;
          if (!(kpos < kvl && (kpos <= qpos || (PREFIX && kpos < prefix)))) s[i][j] = NEG_INF;
        }
      }
    }
    // online softmax: the row's max over its SX lanes, P and alpha to shared
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o = SX / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float* prow = Ps + (srow + SY * i) * PSTR + tx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        ps += p;
        prow[SX * j] = p;
      }
      l_run[i] = alpha * l_run[i] + ps;
      if (tx == 0) alpha_s[srow + SY * i] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V, each output summed over the tile's keys in order
#pragma unroll
    for (int i = 0; i < TMO; ++i) {
      const float a = alpha_s[orow + OY * i];
#pragma unroll
      for (int j = 0; j < TD4; ++j) {
        o[i][j].x *= a;
        o[i][j].y *= a;
        o[i][j].z *= a;
        o[i][j].w *= a;
      }
    }
#pragma unroll 4
    for (int kj = 0; kj < BK; kj += 4) {
      float pa[TMO][4];
#pragma unroll
      for (int i = 0; i < TMO; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + (orow + OY * i) * PSTR + kj);
        pa[i][0] = p4.x, pa[i][1] = p4.y, pa[i][2] = p4.z, pa[i][3] = p4.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < TD4; ++j) {
          const float4 vb =
              *reinterpret_cast<const float4*>(Vt + (kj + kk) * VSTR + ocol + 4 * OX * j);
#pragma unroll
          for (int i = 0; i < TMO; ++i) {
            o[i][j].x = fmaf(pa[i][kk], vb.x, o[i][j].x);
            o[i][j].y = fmaf(pa[i][kk], vb.y, o[i][j].y);
            o[i][j].z = fmaf(pa[i][kk], vb.z, o[i][j].z);
            o[i][j].w = fmaf(pa[i][kk], vb.w, o[i][j].w);
          }
        }
    }
  }
  cp_async_wait<0>();

  // each row's sum over its SX lanes, then O / l
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int o = SX / 2; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (tx == 0) l_s[srow + SY * i] = l;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TMO; ++i) {
    const int r = orow + OY * i, t = q0 + r;
    if (t >= Tq) continue;
    const float l = l_s[r];
    float* orow_p = out + q_at(t) + ocol;
#pragma unroll
    for (int j = 0; j < TD4; ++j)
      *reinterpret_cast<float4*>(orow_p + 4 * OX * j) =
          make_float4(o[i][j].x / l, o[i][j].y / l, o[i][j].z / l, o[i][j].w / l);
  }
}

struct Args {
  const float* q;
  const void *k, *v;
  const float *ks, *vs;
  const int *kv_lens, *page_table;
  float* out;
  int B, Tq, H, S, KVH, page_size, max_pages, prefix, q_tok, q_head;
  float scale;
};

template <typename KV, int D, bool PREFIX, bool STRIDED>
int run(const Args& a, cudaStream_t stream) {
  using C = Cfg<KV, D>;
  auto kernel = attention_kernel<KV, D, C::BQ, C::BK, PREFIX, STRIDED>;
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const dim3 grid(a.B * a.H, (a.Tq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(
      a.q, static_cast<const KV*>(a.k), static_cast<const KV*>(a.v), a.ks, a.vs, a.kv_lens,
      a.page_table, a.out, a.Tq, a.H, a.S, a.KVH, a.page_size, a.max_pages, a.prefix, a.scale,
      a.q_tok, a.q_head);
  return 0;
}

// the tile is the head dim's (Cfg) or the launch is refused
template <typename KV, int D>
int dispatch_masks(const Args& a, int block_q, int block_k, cudaStream_t s) {
  if (block_q != Cfg<KV, D>::BQ || block_k != Cfg<KV, D>::BK)
    return static_cast<int>(cudaErrorInvalidValue);
  // the cache layout's strides (H = 1: the head stride is never used)
  const bool strided = a.q_tok != a.H * D || (a.H > 1 && a.q_head != D);
  if (a.prefix > 0)
    return strided ? run<KV, D, true, true>(a, s) : run<KV, D, true, false>(a, s);
  return strided ? run<KV, D, false, true>(a, s) : run<KV, D, false, false>(a, s);
}

template <typename KV>
int dispatch(const Args& a, int D, int block_q, int block_k, cudaStream_t s) {
  switch (D) {
    case 16: return dispatch_masks<KV, 16>(a, block_q, block_k, s);
    case 32: return dispatch_masks<KV, 32>(a, block_q, block_k, s);
    case 64: return dispatch_masks<KV, 64>(a, block_q, block_k, s);
    case 128: return dispatch_masks<KV, 128>(a, block_q, block_k, s);
    case 256: return dispatch_masks<KV, 256>(a, block_q, block_k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// f32 prefill attention on the CUDA cores.  K/V f32 (kv_int8 = 0) or int8
// with f32 k_scales/v_scales (kv_int8 = 1).  page_table NULL: k/v are the
// dense cache (B, S, KVH, D), otherwise the pool (num_pages, page_size,
// KVH, D) and S = max_pages * page_size.  prefix: keys below it are seen by
// every query (0 causal, S non-causal).  q_tok and q_head: q's (and out's)
// token and head strides in elements (the cache layout's H * D and D, or
// any other pair: the strided instantiations; batch stride Tq * H * D in
// both).  block_q and block_k: the plan's tile, which must be the head
// dim's.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for what the kernel does not take: a head dim
// outside 16-256, another tile, q, k, v or out off 16 bytes, strides off 4
// elements, a negative prefix, a page size below 1, int8 without scales).
// Every stride of K/V is a multiple of 16 bytes at these head dims, so the
// 16-byte copies need nothing but aligned bases, which ops.flash_attention
// requires.
extern "C" int attention_launch(int kv_int8, const float* q, const void* k, const void* v,
                                const float* k_scales, const float* v_scales,
                                const int* kv_lens, const int* page_table, float* out, int B,
                                int Tq, int H, int S, int KVH, int D, int page_size,
                                int max_pages, int prefix, int q_tok, int q_head, int block_q,
                                int block_k, float scale, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if ((page_table && page_size < 1) || (kv_int8 && !(k_scales && v_scales)) || KVH < 1 ||
      H % KVH || Tq < 1 || prefix < 0 || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(out) || q_tok % 4 || q_head % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scales, v_scales, kv_lens, page_table, out, B, Tq, H, S, KVH,
               page_size, max_pages, prefix, q_tok, q_head, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = kv_int8 ? dispatch<int8_t>(a, D, block_q, block_k, s)
                          : dispatch<float>(a, D, block_q, block_k, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
