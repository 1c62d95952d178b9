// Dense f32 GEMM with a fused epilogue on the H100's CUDA cores (FFMA), fed
// by TMA, for Hopper (sm_90a).
//
// Replaces, for the forms `kernels/gemm.py::plan` routes to "ffma_sm90",
// the Pallas kernel `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at
// :184) in its dense "kn" form in f32, and `repro/kernels/bgemm.py`
// (`_bgemm_kernel`, pallas_call at :217) in its f32 broadcast-B form (the
// same GEMM over the batch * M rows of A):
//
//     C = epi( A @ B  [, A @ B2] )
//
// with A (M, K), B and B2 (K, N) row-major, bias (N,), residual (M, N) and C
// (M, N), all f32; the products are FFMA in f32 (TF32 would round
// differently from the plain version) and the epilogue (common.cuh: bias ->
// activation -> gate -> residual) runs in f32 from the registers.  K and N
// are multiples of 4 and every operand starts on a 16-byte boundary (TMA's
// 16-byte row strides); odd K or N, unaligned operands and packed B stay on
// csrc/gemm.cu ("ffma").
//
// It also replaces `_bgemm_kernel` in its batched-B form (`bgemm.py:180-182`)
// in f32 with f32 out (`gemm_f32_batched_launch`): C[z] = epi(A[z] @ B[z]
// [, A[z] @ B2[z]]) for z < batch in one launch, grid.z the member, A and B
// read through rank-3 TMA maps with the batch outermost, so that a tile past
// member z's last row or column loads zeros rather than member z + 1's
// elements, and a B shared by every member is a stack of one read at z = 0
// (the BATCHED instantiations, so the 2-D ones keep their code).
//
// Bound: operations.  At 8192^3 the product does 1.1e12 flops on 0.8 GB,
// ~1400 flops per byte; the CUDA cores' f32 FMA peak is 67 TFLOP/s
// (16.4 ms).  The first design (csrc/gemm.cu) stages its loads through
// registers one 4-byte element at a time, transposes A into shared memory
// and keeps two buffers: 56% of that bound.
//
// Design against it:
//  - operand tiles of BK = 32 k come by TMA into a ring of STAGES stages in
//    dynamic shared memory, each guarded by a full and an empty mbarrier; one
//    producer warp keeps the ring full, every other warp computes.  TMA
//    zero-fills rows and columns outside the matrix, so ragged M, N and K
//    need no masks in the main loop (A and B are both zero there);
//  - A keeps its stored layout (BM rows of 32 k, 128-byte rows in TMA's
//    128-byte swizzle): a thread reads A[m][k..k+3] as one 16-byte load, 4
//    k-steps of one row, and the 4 rows a warp reads at once sit in 4
//    distinct bank groups.  B (32 k-rows of BN columns) is read 16 bytes
//    along n, 8 lanes over 128 contiguous bytes;
//  - a thread owns TM x TN outputs: rows wm + ty + 4i (i < TM), columns wn +
//    4tx + 32j + e (a warp is 4 x 8 threads over (4 TM) x (8 TN) outputs);
//    each 16-byte A load feeds 4 TN FFMAs and each B load 4 TM; the next
//    group of 4 k-steps' A values and the next k-step's B values are loaded
//    while these multiply, and a stage's 32 k-steps are unrolled;
//  - tiles: 128 x 128 (8 x 8 a thread), 128 x 64 (8 x 4) and 64 x 64 (4 x
//    4) without the gate, 128 x 64 and 64 x 64 with it (both accumulators a
//    thread); `kernels/gemm.py::FFMA_SM90_TILES` picks by shape;
//  - tiles are visited in groups of 8 tile rows (grouped raster), so blocks
//    that run together share their A and B panels in L2;
//  - the epilogue writes each 4 columns as one 16-byte store (N % 4 == 0);
//    a plain product (no bias, residual, activation or gate) takes a short
//    path of stores alone (the general path's code, fetched once a block,
//    weighs on short-K products such as the LoRA merge's K = 128).
// PERF.md lists the alternatives measured against this design and dropped
// (3 stages, cp.async copies, the k-steps as a loop, a persistent grid).
// No split-K: each output is summed over all of K in one order, so two
// launches give the same bits.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "tma.cuh"

using namespace rt;

namespace {

constexpr int BK = 32;            // k per stage: one 128-byte row of f32
constexpr int STAGES = 4;         // the ring's depth
constexpr int GROUP = 8;          // tile rows of the grouped raster
constexpr int SW = 1024;          // the 128-byte swizzle repeats every 8 rows
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (227 KB)

template <int BM_, int BN_, int TM_, int TN_, bool GATE_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr bool GATE = GATE_;
  static constexpr int WM = 4 * TM, WN = 8 * TN;           // a warp's outputs
  static constexpr int WARPS_N = BN / WN, CWARPS = (BM / WM) * WARPS_N;
  static constexpr int CTHREADS = 32 * CWARPS;             // compute threads
  static constexpr int THREADS = CTHREADS + 32;           // + the producer warp
  static constexpr int NB = GATE ? 2 : 1;                  // B operands
  static constexpr int A_BYTES = BM * BK * 4, B_BYTES = BK * BN * 4;
  static constexpr int STAGE = A_BYTES + NB * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE + SW + 2 * STAGES * 8;
  static_assert(BM % WM == 0 && BN % WN == 0 && TN % 4 == 0, "tile / thread split");
  static_assert(STAGE % SW == 0, "every A tile must start on a swizzle period");
  static_assert(SMEM <= SMEM_MAX, "ring too large");
};

// One C tile.  ta (A, boxes of BK x BM, 128-byte swizzle), tb and tb2 (B,
// B2, boxes of BN x BK) feed the ring.  BATCHED: of batch member blockIdx.z,
// through rank-3 maps (B's member z if b_batched, else its only one).
template <class C, bool BATCHED = false>
__global__ void __launch_bounds__(C::THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tb2, const float* __restrict__ bias,
                const float* __restrict__ res, float* __restrict__ c, int M, int K, int N,
                int act, int b_batched) {
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN;
  constexpr int NJ = TN / 4;  // 16-byte column groups a thread
  constexpr bool GATE = C::GATE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((SW - (smem_u32(smem_raw) & (SW - 1))) & (SW - 1));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + STAGES * C::STAGE, empty0 = full0 + STAGES * 8;

  // grouped raster: GROUP tile rows sweep the tile columns together.  A
  // block walks tiles blockIdx.x, + gridDim.x, ...; the launch gives each
  // block one tile, so the walk is one trip.  It stays: without it ptxas
  // schedules the main loop otherwise, and 128 x 128 ran 11% slower at
  // 8192^3 (25.36 against 22.88 ms, PERF.md)
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n, per_group = GROUP * tiles_n;
  auto origin = [&](int tile, int& m0, int& n0) {
    const int first = tile / per_group * GROUP;
    const int rows_here = min(tiles_m - first, GROUP);
    const int in_group = tile % per_group;
    m0 = (first + in_group % rows_here) * BM;
    n0 = (in_group / rows_here) * BN;
  };
  const int KT = (K + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, C::CWARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == C::CWARPS) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      int it = 0;  // k-steps issued by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        origin(tile, m0, n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          const uint32_t full = full0 + 8 * s, st = base + s * C::STAGE;
          mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full, C::STAGE);
          if constexpr (BATCHED) {
            const int z = blockIdx.z, bz = b_batched ? z : 0;
            tma_load3(st, &ta, full, kt * BK, m0, z);
            tma_load3(st + C::A_BYTES, &tb, full, n0, kt * BK, bz);
            if constexpr (GATE)
              tma_load3(st + C::A_BYTES + C::B_BYTES, &tb2, full, n0, kt * BK, bz);
          } else {
            tma_load(st, &ta, full, kt * BK, m0);
            tma_load(st + C::A_BYTES, &tb, full, n0, kt * BK);
            if constexpr (GATE) tma_load(st + C::A_BYTES + C::B_BYTES, &tb2, full, n0, kt * BK);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (BATCHED) {  // member z's C and residual
    const long plane = static_cast<long>(M) * N;
    c += blockIdx.z * plane;
    if (res) res += blockIdx.z * plane;
  }
  const int ty = lane >> 3, tx = lane & 7;
  const int wm = (warp / C::WARPS_N) * C::WM, wn = (warp % C::WARPS_N) * C::WN;
  // byte offsets inside a stage: row i's A line (its chunk swizzled per
  // k group), the first B column group
  uint32_t a_row[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) a_row[i] = (wm + ty + 4 * i) * 128;
  const int a_sw = ty & 7;  // (wm + ty + 4i) % 8 = (ty + 4 (i % 2)) % 8, wm % 8 == 0
  const uint32_t b_col = (wn + 4 * tx) * 4;
  int it = 0;  // k-steps consumed by this block, over all its tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    origin(tile, m0, n0);
    float acc[TM][TN], acc2[GATE ? TM : 1][GATE ? TN : 1];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = 0.f;
        if constexpr (GATE) acc2[i][j] = 0.f;
      }

    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint8_t* As = smem + s * C::STAGE;
      const uint8_t* Bs = As + C::A_BYTES;
      auto load_a = [&](float4 (&av)[TM], int g) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(As + a_row[i] +
                                                   ((g ^ (a_sw ^ ((i & 1) << 2))) << 4));
      };
      auto load_b = [&](float4 (&bv)[2][NJ], int k) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          bv[0][j] = *reinterpret_cast<const float4*>(Bs + k * BN * 4 + b_col + 128 * j);
          if constexpr (GATE)
            bv[1][j] = *reinterpret_cast<const float4*>(Bs + C::B_BYTES + k * BN * 4 + b_col +
                                                        128 * j);
        }
      };
      // one group of 4 k-steps from A values `cur` (A[row][k..k+3]), loading
      // the next group's into `nxt` and each next k-step's B values ahead
      float4 av[2][TM], bv[2][2][NJ];
      auto group = [&](int g, const float4 (&cur)[TM], float4 (&nxt)[TM]) {
        if (g + 1 < BK / 4) load_a(nxt, g + 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * g + kk;  // k % 2 == kk % 2
          if (k + 1 < BK) load_b(bv[(kk + 1) & 1], k + 1);
          float bf[2][TN];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int h = 0; h < (GATE ? 2 : 1); ++h) {
              const float4 v = bv[kk & 1][h][j];
              bf[h][4 * j] = v.x;
              bf[h][4 * j + 1] = v.y;
              bf[h][4 * j + 2] = v.z;
              bf[h][4 * j + 3] = v.w;
            }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float x =
                kk == 0 ? cur[i].x : kk == 1 ? cur[i].y : kk == 2 ? cur[i].z : cur[i].w;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[i][j] = fmaf(x, bf[0][j], acc[i][j]);
              if constexpr (GATE) acc2[i][j] = fmaf(x, bf[1][j], acc2[i][j]);
            }
          }
        }
      };
      load_a(av[0], 0);
      load_b(bv[0], 0);
      // two groups a trip (the A buffers swap back); the stage's 8 groups
      // fully unrolled (2048 FFMAs a thread at 8 x 8)
#pragma unroll
      for (int g = 0; g < BK / 4; g += 2) {
        group(g, av[0], av[1]);
        group(g + 1, av[1], av[0]);
      }
      __syncwarp();  // every lane's reads of stage s are done ...
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // ... so the producer may refill it
    }

    // ---- epilogue from the registers: 4 columns a 16-byte store ----
    if (!GATE && !bias && !res && act == ACT_NONE) {  // C = A B: the short path
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + wm + ty + 4 * i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + wn + 4 * tx + 32 * j;
          if (col < N)
            *reinterpret_cast<float4*>(c + (long)row * N + col) = make_float4(
                acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + wm + ty + 4 * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + wn + 4 * tx + 32 * j;
        if (col >= N) continue;  // N % 4 == 0: col + 3 < N too
        const long o = (long)row * N + col;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float g = 0.f;
          if constexpr (GATE) g = acc2[i][4 * j + e];
          v[e] = epilogue<float>(acc[i][4 * j + e], g, bias, res, col + e, o + e, act, GATE);
        }
        *reinterpret_cast<float4*>(c + o) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

constexpr int ENCODE_FAILED = 1000;  // + the CUresult

// batch > 0: the batched launch (rank-3 maps, grid.z the member; B a stack
// of `batch` if b_batched, else of one); 0: the 2-D one
template <class C, bool BATCHED = false>
int run(const float* a, const float* b, const float* b2, const float* bias, const float* res,
        float* c, int M, int K, int N, int act, cudaStream_t s, int batch = 0,
        int b_batched = 0) {
  CUtensorMap ta, tb, tb2;
  memset(&tb2, 0, sizeof(tb2));  // unused without the gate
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  int err;
  if constexpr (BATCHED) {
    const long depth = b_batched ? batch : 1;
    err = encode3(fn, &ta, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, M, batch, BK, C::BM,
                  CU_TENSOR_MAP_SWIZZLE_128B, K);
    for (int j = 0; j < (C::GATE ? 2 : 1) && !err; ++j)
      err = encode3(fn, j ? &tb2 : &tb, j ? b2 : b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K,
                    depth, C::BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE, N);
  } else {
    err = encode(fn, &ta, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, M, BK, C::BM,
                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err) err = encode(fn, &tb, b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K, C::BN, BK,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err && C::GATE)
      err = encode(fn, &tb2, b2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K, C::BN, BK,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err) return ENCODE_FAILED + err;
  auto kernel = gemm_f32_kernel<C, BATCHED>;
  static bool sized = false;  // the opt-in above 48 KB, once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long tiles = (long)((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  const dim3 grid((unsigned)tiles, 1, BATCHED ? (unsigned)batch : 1u);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(ta, tb, tb2, bias, res, c, M, K, N, act, b_batched);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// C (M, N) = epi(A (M, K) @ B [, A @ B2]) in f32 on the CUDA cores.  b2,
// bias and res may be NULL.  (bm, bn): 128 x 128, 128 x 64 or 64 x 64 (the
// gate: 128 x 64 or 64 x 64).  K and N must be multiples of 4 and a, b, b2
// and c 16-byte aligned.  Returns cudaErrorInvalidValue for what the kernel
// does not take, 1000 + a CUresult if a TMA descriptor is refused, else
// cudaGetLastError() after the launch.
extern "C" int gemm_f32_launch(const void* a, const void* b, const void* b2, const void* bias,
                               const void* res, void* c, int M, int K, int N, int act, int bm,
                               int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
  const float* b2t = static_cast<const float*>(b2);
  const float* biast = static_cast<const float*>(bias);
  const float* rest = static_cast<const float*>(res);
  float* ct = static_cast<float*>(c);
  const bool aligned = aligned16(at) && aligned16(bt) && aligned16(b2t) && aligned16(ct);
  if (M < 1 || K < 1 || N < 1 || K % 4 || N % 4 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = bm * 1000 + bn;
#define F32_ARGS at, bt, b2t, biast, rest, ct, M, K, N, act, s
  if (b2) {
    if (tile == 128064) return run<Cfg<128, 64, 8, 4, true>>(F32_ARGS);
    if (tile == 64064) return run<Cfg<64, 64, 4, 4, true>>(F32_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 128128) return run<Cfg<128, 128, 8, 8, false>>(F32_ARGS);
  if (tile == 128064) return run<Cfg<128, 64, 8, 4, false>>(F32_ARGS);
  if (tile == 64064) return run<Cfg<64, 64, 4, 4, false>>(F32_ARGS);
#undef F32_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// C[z] (M, N) = epi(A[z] (M, K) @ B[z] [, A[z] @ B2[z]]) in f32 for z < batch
// in one launch: A (batch, M, K), C and res (batch, M, N) contiguous; B and
// B2 (batch, K, N) if b_batched, else one (K, N) shared by every member.
// b2, bias and res may be NULL.  (bm, bn) as gemm_f32_launch's, or 32 x 64
// (4 warps of 16 x 32: the MoE experts' 32 rows a member, with or without
// the gate); K, N and the alignments as gemm_f32_launch's.  Returns
// cudaErrorInvalidValue for what the kernel does not take, 1000 + a CUresult
// if a TMA descriptor is refused, else cudaGetLastError() after the launch.
extern "C" int gemm_f32_batched_launch(const void* a, const void* b, const void* b2,
                                       const void* bias, const void* res, void* c, int batch,
                                       int b_batched, int M, int K, int N, int act, int bm,
                                       int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
  const float* b2t = static_cast<const float*>(b2);
  const float* biast = static_cast<const float*>(bias);
  const float* rest = static_cast<const float*>(res);
  float* ct = static_cast<float*>(c);
  const bool aligned = aligned16(at) && aligned16(bt) && aligned16(b2t) && aligned16(ct);
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || K % 4 || N % 4 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = bm * 1000 + bn;
  const int bb = b_batched ? 1 : 0;
#define F32_ARGS at, bt, b2t, biast, rest, ct, M, K, N, act, s, batch, bb
  if (b2) {
    if (tile == 128064) return run<Cfg<128, 64, 8, 4, true>, true>(F32_ARGS);
    if (tile == 64064) return run<Cfg<64, 64, 4, 4, true>, true>(F32_ARGS);
    if (tile == 32064) return run<Cfg<32, 64, 4, 4, true>, true>(F32_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 128128) return run<Cfg<128, 128, 8, 8, false>, true>(F32_ARGS);
  if (tile == 128064) return run<Cfg<128, 64, 8, 4, false>, true>(F32_ARGS);
  if (tile == 64064) return run<Cfg<64, 64, 4, 4, false>, true>(F32_ARGS);
  if (tile == 32064) return run<Cfg<32, 64, 4, 4, false>, true>(F32_ARGS);
#undef F32_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
