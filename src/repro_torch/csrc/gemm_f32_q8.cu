// f32 GEMM with a packed int8 B and a fused epilogue on the H100's CUDA
// cores, the int8 dequantized in the ring's staging.
//
// Replaces, for the packed forms `kernels/gemm.py` routes to "ffma_sm90"
// (f32 A; int8 rows TMA can address), the packed bodies of
// `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at :184, int8 body
// `:63-76`) and `repro/kernels/bgemm.py` (`_bgemm_kernel`, pallas_call at
// :217, int8 body `:80-90`, batched B `:180-182`): C[z] = epi(A[z] @ deq(B[z])
// [, A[z] @ deq(B2[z])]) with B block-scaled int8 (core/quant.py) stored (K,
// N) ("kn") or (N, K) ("nk", the scales along K or not), f32 scales, one
// per (qa, qb) block of the stored layout; f32 A, bias, residual and C.
//
// Bound: operations where M is large (8192^3: 1.1e12 flops on 0.5 GB),
// bytes at the MoE decode's 32 rows a member.  The first design
// (csrc/gemm.cu's and csrc/gemm_batched.cu's CUDA-core tile) dequantizes
// each element on its way from registers into a float tile of two buffers,
// one barrier a k-step of 8, and keeps 128 rows at M = 32 (3/4 of its FFMAs
// on zero rows).  Here the f32 ring and consumers of csrc/gemm_f32.cu
// (gemm_f32.cuh) take it: one producer thread brings A (rank-3 map, 128-byte
// swizzle) and the stored int8 tile (32 k x BN bytes, or BN rows x 32 k) by
// TMA into a landing tile a stage; the consumer warps, before they multiply
// stage k, write stage k + 1's value x scale in f32 into its B tile, each
// element once a block ("nk" transposed by byte permutes), and meet at a
// named barrier once a stage.  Three converter warps beside the consumers,
// the other design, held the ring at 1.5-1.8x its time without conversion
// at 8192^3 (PERF.md): a converter warp shares its scheduler with FFMA
// warps that are always ready.  Each element is rounded as the plain
// version's `dequantize_in` rounds it (one f32 product); only the order of
// the sum differs from `reference_int8`, and no k-step is scaled apart.
// Batched stacks read their int8 and scales through rank-3 maps and member
// offsets, the batch outermost (the MoE's 32 rows a member take the 32 x
// 64 tile).  Each output is summed over all of K in one order: two launches
// give the same bits.
#include "gemm_f32.cuh"

namespace {

// the stored layout of the int8 B: (K, N) ("kn") or (N, K) ("nk")
enum Q8Layout { Q8_KN = 0, Q8_NK = 1 };

// gemm_f32_q8_kernel's arguments; batch member z = blockIdx.z
struct Q8Args {
  CUtensorMap ta, tb, tb2;  // A (K, M, batch), B's and B2's stored int8 rows (a stack)
  const float *bs, *b2s;    // the scales, member z's ss on (ss = 0: shared)
  const float *bias, *res;
  float* c;
  long ss;
  int M, K, N, act;
  int qa, qb;     // the scale block over the stored layout
  int b_batched;  // B a stack of one a member (else of one)
  int vec;        // C takes 16-byte stores (N % 4 == 0, C on 16 bytes)
};

template <class C>
struct Q8Ring {
  static constexpr int Q_BYTES = BK * C::BN;  // one int8 tile
  // the ring's stages, then a landing tile a stage and operand, then the
  // barriers: landed and empty, one a stage each
  static constexpr int LAND = STAGES * C::STAGE;
  static constexpr int BARRIERS = LAND + STAGES * C::NB * Q_BYTES;
  static constexpr int SMEM = BARRIERS + 2 * STAGES * 8 + SW;
  static_assert(SMEM <= SMEM_MAX, "ring too large");
};

// 4 int8 (one word, byte e the e-th) -> f32, exact: each byte + 128 under
// 2^23's exponent, less 2^23 + 128 (I2F runs at a quarter of FFMA's rate)
__device__ __forceinline__ float4 s8x4_to_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float MAGIC = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - MAGIC,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - MAGIC,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - MAGIC,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - MAGIC);
}

// Consumer thread ct's share of converting stage s (k from k0): the landed
// int8 tiles -> value x scale in f32 (rounded once, as the plain version's
// dequantize_in) into the stage's B (and B2) tile.  A thread loads every
// word of its units first, then converts and stores.  "kn": a unit is 4
// columns of one k-row (a word in, a 16-byte store out); a thread's columns
// stay the same for every unit.  "nk": a unit is 4 stored rows (n) x 4 k,
// transposed by byte permutes; lanes 0-7 of a warp take 8 consecutive n
// (each 16-byte store quarter-warp contiguous) and lanes 8g.. 4 consecutive
// k groups, each lane's 4 row reads rotated by n % 4 so that they meet at
// most 2 to a bank.  A scale index clamps to the matrix (past it the values
// are 0).
template <class C, int LAYOUT>
__device__ __forceinline__ void convert_stage(const Q8Args& p, const float* const (&sc)[2],
                                              uint8_t* smem, int s, int k0, int n0, int ct) {
  using L = Q8Ring<C>;
  constexpr int NT = C::CTHREADS;
  // units an operand: "kn" 4 columns of a k-row, "nk" 4 stored rows x 4 k
  constexpr int BN = C::BN, HG = BN / 4, UNITS = BK * BN / (LAYOUT == Q8_KN ? 4 : 16);
  constexpr int ALL = C::NB * UNITS, STEPS = (ALL + NT - 1) / NT;
  static_assert(NT % HG == 0 && NT % 8 == 0 && HG % 8 == 0, "a thread's columns / rows");
  const int K = p.K, N = p.N, qa = p.qa, qb = p.qb;
  const uint8_t* __restrict__ src = smem + L::LAND + s * C::NB * L::Q_BYTES;
  uint8_t* __restrict__ dst = smem + s * C::STAGE + C::A_BYTES;
  auto live = [&](int t) { return ALL % NT == 0 || ct + t * NT < ALL; };
  if constexpr (LAYOUT == Q8_KN) {
    const int s_cols = N / qb, c4 = ct % HG, n = n0 + 4 * c4;
    // one scale for all of a stage's units of an operand (the expert rule)
    const bool one = qb % 4 == 0 && qa % BK == 0;
    uint32_t w[STEPS];
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const int u = ct + t * NT, j = u / UNITS, r = u % UNITS / HG;
      if (live(t))
        w[t] = *reinterpret_cast<const uint32_t*>(src + j * L::Q_BYTES + r * BN + 4 * c4);
    }
    float s_one[2];
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
      if (one) s_one[j] = __ldg(sc[j] + (long)(k0 / qa) * s_cols + min(n, N - 1) / qb);
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const int u = ct + t * NT, j = u / UNITS, r = u % UNITS / HG;
      if (!live(t)) continue;
      float s4[4];
      if (one) {
        s4[0] = s4[1] = s4[2] = s4[3] = s_one[j];
      } else {
        const float* srow = sc[j] + (long)(min(k0 + r, K - 1) / qa) * s_cols;
#pragma unroll
        for (int e = 0; e < 4; ++e) s4[e] = __ldg(srow + min(n + (qb % 4 ? e : 0), N - 1) / qb);
      }
      float4 f = s8x4_to_f32(w[t]);
      f.x *= s4[0];
      f.y *= s4[1];
      f.z *= s4[2];
      f.w *= s4[3];
      *reinterpret_cast<float4*>(dst + j * C::B_BYTES + r * BN * 4 + 16 * c4) = f;
    }
  } else {
    const int s_cols = K / qb, hr = ct & 3;  // hr: n % 4 of every unit of this thread
    uint32_t rot = 0;  // output byte i from transposed byte (i - hr) % 4
#pragma unroll
    for (int i = 0; i < 4; ++i) rot |= static_cast<uint32_t>((i - hr) & 3) << (4 * i);
    const bool one_k = qb % 4 == 0, one_n = qa % 4 == 0;
    // unit t: operand j, 4 stored rows from 4h, k bytes from 4g
    auto unit = [&](int t, int& j, int& h, int& g) {
      const int u = ct + t * NT, v = u % UNITS, hi = v >> 5;
      j = u / UNITS;
      h = (v & 7) + 8 * (hi % (HG / 8));
      g = ((v >> 3) & 3) + 4 * (hi / (HG / 8));
    };
    uint32_t raw[STEPS][4];
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      int j, h, g;
      unit(t, j, h, g);
      const uint8_t* q = src + j * L::Q_BYTES + 4 * h * BK + 4 * g;
      if (live(t))
#pragma unroll
        for (int r = 0; r < 4; ++r)
          raw[t][r] = *reinterpret_cast<const uint32_t*>(q + ((r + hr) & 3) * BK);
    }
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      int j, h, g;
      unit(t, j, h, g);
      if (!live(t)) continue;
      const uint32_t x0 = __byte_perm(raw[t][0], raw[t][1], 0x5140);
      const uint32_t x1 = __byte_perm(raw[t][0], raw[t][1], 0x7362);
      const uint32_t x2 = __byte_perm(raw[t][2], raw[t][3], 0x5140);
      const uint32_t x3 = __byte_perm(raw[t][2], raw[t][3], 0x7362);
      uint32_t tr[4];
      tr[0] = __byte_perm(__byte_perm(x0, x2, 0x5410), 0, rot);
      tr[1] = __byte_perm(__byte_perm(x0, x2, 0x7632), 0, rot);
      tr[2] = __byte_perm(__byte_perm(x1, x3, 0x5410), 0, rot);
      tr[3] = __byte_perm(__byte_perm(x1, x3, 0x7632), 0, rot);
      const int n = n0 + 4 * h, k = k0 + 4 * g;
      auto scale = [&](int i, int e) {
        return __ldg(sc[j] + (long)(min(n + i, N - 1) / qa) * s_cols + min(k + e, K - 1) / qb);
      };
      const float s00 = scale(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // k + e: stored rows n .. n + 3 -> B[k + e][n ..]
        float s4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s4[i] = (i == 0 || one_n) && (e == 0 || one_k) ? s00 : scale(i, e);
        float4 f = s8x4_to_f32(tr[e]);
        f.x *= s4[0];
        f.y *= s4[1];
        f.z *= s4[2];
        f.w *= s4[3];
        *reinterpret_cast<float4*>(dst + j * C::B_BYTES + (4 * g + e) * BN * 4 + 16 * h) = f;
      }
    }
  }
}

// the consumer warps' named barrier (barrier 0 is __syncthreads')
template <class C>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(C::CTHREADS) : "memory");
}

// One C tile of batch member blockIdx.z with int8 B: the producer warp's
// first thread brings A and the int8 tiles by TMA into a landing tile a
// stage; the consumers convert stage k + 1 into its f32 B tile, multiply
// stage k (multiply_stage, as gemm_f32_kernel's), meet at a named barrier
// and release stage k.
template <class C, int LAYOUT>
__global__ void __launch_bounds__(C::THREADS, 1)
gemm_f32_q8_kernel(const __grid_constant__ Q8Args p) {
  using L = Q8Ring<C>;
  constexpr int TM = C::TM, TN = C::TN;
  constexpr bool GATE = C::GATE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((SW - (smem_u32(smem_raw) & (SW - 1))) & (SW - 1));
  const uint32_t base = smem_u32(smem);
  const uint32_t land0 = base + L::BARRIERS, empty0 = land0 + STAGES * 8;
  const int M = p.M, K = p.K, N = p.N, z = blockIdx.z;
  int m0, n0;
  tile_origin<C>(blockIdx.x, (M + C::BM - 1) / C::BM, GROUP * ((N + C::BN - 1) / C::BN), m0, n0);
  const int KT = (K + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(land0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == C::CWARPS) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      const int bz = p.b_batched ? z : 0;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        const uint32_t land = land0 + 8 * s, q = base + L::LAND + s * C::NB * L::Q_BYTES;
        mbar_wait(empty0 + 8 * s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(land, C::A_BYTES + C::NB * L::Q_BYTES);
        tma_load3(base + s * C::STAGE, &p.ta, land, kt * BK, m0, z);
#pragma unroll
        for (int j = 0; j < C::NB; ++j) {
          if constexpr (LAYOUT == Q8_KN)
            tma_load3(q + j * L::Q_BYTES, j ? &p.tb2 : &p.tb, land, n0, kt * BK, bz);
          else
            tma_load3(q + j * L::Q_BYTES, j ? &p.tb2 : &p.tb, land, kt * BK, n0, bz);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const float* const sc[2] = {p.bs + z * p.ss, GATE ? p.b2s + z * p.ss : p.bs};
  const long plane = static_cast<long>(M) * N;
  const int ty = lane >> 3, tx = lane & 7;
  const int wm = (warp / C::WARPS_N) * C::WM, wn = (warp % C::WARPS_N) * C::WN;
  uint32_t a_row[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) a_row[i] = (wm + ty + 4 * i) * 128;
  const int a_sw = ty & 7;
  const uint32_t b_col = (wn + 4 * tx) * 4;
  float acc[TM][TN], acc2[GATE ? TM : 1][GATE ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      if constexpr (GATE) acc2[i][j] = 0.f;
    }
  mbar_wait(land0, 0);  // stage 0 landed (KT >= 1)
  convert_stage<C, LAYOUT>(p, sc, smem, 0, 0, n0, tid);
  consumers_sync<C>();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES, f = kt + 1;
    if (f < KT) {  // the next stage's B, before this one's products
      mbar_wait(land0 + 8 * (f % STAGES), (f / STAGES) & 1);
      convert_stage<C, LAYOUT>(p, sc, smem, f % STAGES, f * BK, n0, tid);
    }
    multiply_stage<C>(smem + s * C::STAGE, a_row, a_sw, b_col, acc, acc2);
    consumers_sync<C>();  // stage f converted, stage s read by every consumer ...
    if (tid == 0) mbar_arrive(empty0 + 8 * s);  // ... so the producer may refill s
  }
  store_tile<C>(acc, acc2, p.bias, p.res ? p.res + z * plane : nullptr, p.c + z * plane,
                m0 + wm + ty, n0 + wn + 4 * tx, M, N, p.act, p.vec != 0);
}

// one launch of gemm_f32_q8_kernel<C, LAYOUT> over `batch` members: its
// TMA maps (A rank 3, batch outermost; B's stored int8 rows a stack of
// `depth`), then the kernel
template <class C, int LAYOUT>
int run_q8(Q8Args& g, const void* a, const void* b, const void* b2, int batch, int depth,
           cudaStream_t s) {
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const int K = g.K, N = g.N;
  int err = encode3(fn, &g.ta, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, g.M, batch, BK, C::BM,
                    CU_TENSOR_MAP_SWIZZLE_128B, K);
  for (int j = 0; j < (C::GATE ? 2 : 1) && !err; ++j) {
    CUtensorMap* map = j ? &g.tb2 : &g.tb;
    const void* q = j ? b2 : b;
    err = LAYOUT == Q8_KN
              ? encode3(fn, map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, depth, C::BN, BK,
                        CU_TENSOR_MAP_SWIZZLE_NONE, N)
              : encode3(fn, map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, depth, BK, C::BN,
                        CU_TENSOR_MAP_SWIZZLE_NONE, K);
  }
  if (err) return ENCODE_FAILED + err;
  using L = Q8Ring<C>;
  auto kernel = gemm_f32_q8_kernel<C, LAYOUT>;
  static bool sized = false;  // the opt-in above 48 KB, once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long tiles = (long)((g.M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  kernel<<<dim3((unsigned)tiles, 1, (unsigned)batch), C::THREADS, L::SMEM, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[z] (M, N) = epi(A[z] (M, K) @ deq(B[z]) [, A[z] @ deq(B2[z])]) in f32
// for z < batch, one launch: A (batch, M, K), C and res (batch, M, N)
// contiguous; B, B2 int8 stored (K, N) (nk = 0) or (N, K) (nk = 1), one a
// member (b_batched) or one for every member, with f32 scales (stored rows
// / qa, stored cols / qb) a member; the 2-D GEMM is batch 1.  b2/b2s, bias
// and res may be NULL.  (bm, bn): 128 x 128, 128 x 64, 64 x 64 or 32 x 64
// (the gate: 128 x 64, 64 x 64 or 32 x 64).  K % 4 == 0 and a on 16 bytes;
// the stored int8 rows a multiple of 16 bytes (N for "kn", K for "nk") and
// b, b2 on 16 bytes.  Returns cudaErrorInvalidValue for what the kernel does
// not take, 1000 + a CUresult if a TMA descriptor is refused, else
// cudaGetLastError() after the launch.
extern "C" int gemm_f32_q8_launch(const void* a, const void* b, const void* bs, const void* b2,
                                  const void* b2s, int qa, int qb, int nk, const void* bias,
                                  const void* res, void* c, int batch, int b_batched, int M,
                                  int K, int N, int act, int bm, int bn, void* stream) {
  const int rows = nk ? N : K, cols = nk ? K : N;
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || K % 4 || cols % 16 ||
      qa < 1 || qb < 1 || rows % qa || cols % qb || !aligned_to(a, 16) || !aligned_to(b, 16) ||
      !aligned_to(b2, 16) || (b2 && !b2s))
    return static_cast<int>(cudaErrorInvalidValue);
  Q8Args g;
  memset(&g, 0, sizeof(g));
  g.bs = static_cast<const float*>(bs);
  g.b2s = static_cast<const float*>(b2s);
  g.bias = static_cast<const float*>(bias);
  g.res = static_cast<const float*>(res);
  g.c = static_cast<float*>(c);
  g.ss = b_batched ? static_cast<long>(rows / qa) * (cols / qb) : 0;
  g.M = M;
  g.K = K;
  g.N = N;
  g.act = act;
  g.qa = qa;
  g.qb = qb;
  g.b_batched = b_batched ? 1 : 0;
  g.vec = N % 4 == 0 && aligned_to(c, 16);
  const int depth = b_batched ? batch : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = bm * 1000 + bn;
#define Q8_RUN(BM, BN, TM, TN, GATE)                                                        \
  if (tile == BM * 1000 + BN)                                                               \
    return nk ? run_q8<Cfg<BM, BN, TM, TN, GATE>, Q8_NK>(g, a, b, b2, batch, depth, s)      \
              : run_q8<Cfg<BM, BN, TM, TN, GATE>, Q8_KN>(g, a, b, b2, batch, depth, s);
  if (b2) {
    Q8_RUN(128, 64, 8, 4, true)
    Q8_RUN(64, 64, 4, 4, true)
    Q8_RUN(32, 64, 4, 4, true)
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Q8_RUN(128, 128, 8, 8, false)
  Q8_RUN(128, 64, 8, 4, false)
  Q8_RUN(64, 64, 4, 4, false)
  Q8_RUN(32, 64, 4, 4, false)
#undef Q8_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}
