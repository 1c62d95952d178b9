// The f32 GEMM on the H100's CUDA cores, fed through a shared-memory ring:
// the parts its sources share.  csrc/gemm_f32.cu feeds the ring by TMA of
// f32 rows (any row stride a multiple of 4 floats, so a staged operand's
// padded rows too) and holds the design notes; csrc/gemm_f32_odd.cu holds
// the instantiations that write C one element at a time (N % 4 != 0, C off
// 16 bytes); csrc/gemm_f32_q8.cu feeds the ring by TMA of int8 B,
// dequantized into the stage's f32 B tile.  Here: the tile configurations,
// the grouped raster, the consumers' multiply of one stage and epilogue
// (both kernels'), and the TMA kernel and its launch.
#pragma once

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
constexpr int ENCODE_FAILED = 1000;  // a launch's return for a refused TMA map: + the CUresult

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

// The origin (m0, n0) of tile `tile` in the grouped raster: GROUP tile rows
// sweep the tile columns together (per_group = GROUP * the tile columns), so
// blocks that run together share their A and B panels in L2.
template <class C>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int per_group, int& m0,
                                            int& n0) {
  const int first = tile / per_group * GROUP;
  const int rows_here = min(tiles_m - first, GROUP);
  const int in_group = tile % per_group;
  m0 = (first + in_group % rows_here) * C::BM;
  n0 = (in_group / rows_here) * C::BN;
}

// acc (and acc2) += the stage at As: A (BM rows of BK k, 128-byte swizzled),
// then B (BK k-rows of BN) and B2.  A thread's rows are a_row (byte offsets),
// its A chunks swizzled by a_sw, its first B column group at byte b_col:
// rows wm + ty + 4i, columns wn + 4tx + 32j + e.  Each 16-byte A load feeds
// 4 TN FFMAs and each B load 4 TM; the next group of 4 k-steps' A values and
// the next k-step's B values load while these multiply, and a stage's 32
// k-steps are unrolled.
template <class C>
__device__ __forceinline__ void multiply_stage(const uint8_t* As, const uint32_t (&a_row)[C::TM],
                                               int a_sw, uint32_t b_col,
                                               float (&acc)[C::TM][C::TN],
                                               float (&acc2)[C::GATE ? C::TM : 1]
                                                            [C::GATE ? C::TN : 1]) {
  constexpr int BN = C::BN, TM = C::TM, TN = C::TN, NJ = TN / 4;
  constexpr bool GATE = C::GATE;
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
        const float x = kk == 0 ? cur[i].x : kk == 1 ? cur[i].y : kk == 2 ? cur[i].z : cur[i].w;
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
}

// C's tile from the registers: rows r0 + 4i, columns c0 + 32j + e (a
// thread's), through the epilogue (common.cuh) unless it is the plain
// product (a short path of stores alone: the general path's code, fetched
// once a block, weighs on short-K products such as the LoRA merge's K =
// 128).  vec: 4 columns a 16-byte store (N % 4 == 0, C on 16 bytes); else
// one store an element, none past N.
template <class C>
__device__ __forceinline__ void store_tile(const float (&acc)[C::TM][C::TN],
                                           const float (&acc2)[C::GATE ? C::TM : 1]
                                                              [C::GATE ? C::TN : 1],
                                           const float* __restrict__ bias,
                                           const float* __restrict__ res, float* __restrict__ c,
                                           int r0, int c0, int M, int N, int act, bool vec) {
  constexpr int TM = C::TM, NJ = C::TN / 4;
  constexpr bool GATE = C::GATE;
  if (!GATE && !bias && !res && act == ACT_NONE) {  // C = A B: the short path
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = r0 + 4 * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = c0 + 32 * j;
        const long o = (long)row * N + col;
        if (vec) {
          if (col < N)
            *reinterpret_cast<float4*>(c + o) = make_float4(
                acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < N) c[o + e] = acc[i][4 * j + e];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + 4 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = c0 + 32 * j;
      if (col >= N) continue;  // vec (N % 4 == 0): col + 3 < N too
      const long o = (long)row * N + col;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float g = 0.f;
        if constexpr (GATE) g = acc2[i][4 * j + e];
        // past N (element stores only): neither bias nor the residual read
        v[e] = vec || col + e < N
                   ? epilogue<float>(acc[i][4 * j + e], g, bias, res, col + e, o + e, act, GATE)
                   : 0.f;
      }
      if (vec) {
        *reinterpret_cast<float4*>(c + o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) c[o + e] = v[e];
      }
    }
  }
}

// ---- TMA of f32 rows (csrc/gemm_f32.cu, csrc/gemm_f32_odd.cu) -----------

// One C tile.  ta (A, boxes of BK x BM, 128-byte swizzle), tb and tb2 (B,
// B2, boxes of BN x BK) feed the ring.  BATCHED: of batch member blockIdx.z,
// through rank-3 maps (B's member z if b_batched, else its only one).  ODD
// (N % 4 != 0 or C off 16 bytes): one store an element, else 16-byte
// stores.  A template flag, not a branch on N and C: with the branch the
// 128 x 128 tile spilled and ran 8192^3 11% slower (PERF.md), so the ODD
// instantiations sit in a source of their own (gemm_f32_odd.cu).
template <class C, bool BATCHED = false, bool ODD = false>
__global__ void __launch_bounds__(C::THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tb2, const float* __restrict__ bias,
                const float* __restrict__ res, float* __restrict__ c, int M, int K, int N,
                int act, int b_batched) {
  constexpr int BM = C::BM, BN = C::BN, TM = C::TM, TN = C::TN;
  constexpr bool GATE = C::GATE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((SW - (smem_u32(smem_raw) & (SW - 1))) & (SW - 1));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + STAGES * C::STAGE, empty0 = full0 + STAGES * 8;

  // a block walks tiles blockIdx.x, + gridDim.x, ... in the grouped raster;
  // the launch gives each block one tile, so the walk is one trip.  It
  // stays: without it ptxas schedules the main loop otherwise, and 128 x
  // 128 ran 11% slower at 8192^3 (25.36 against 22.88 ms, PERF.md)
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n, per_group = GROUP * tiles_n;
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
        tile_origin<C>(tile, tiles_m, per_group, m0, n0);
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
    tile_origin<C>(tile, tiles_m, per_group, m0, n0);
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
      multiply_stage<C>(smem + s * C::STAGE, a_row, a_sw, b_col, acc, acc2);
      __syncwarp();  // every lane's reads of stage s are done ...
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // ... so the producer may refill it
    }
    store_tile<C>(acc, acc2, bias, res, c, m0 + wm + ty, n0 + wn + 4 * tx, M, N, act, !ODD);
  }
}

// batch > 0: the batched launch (rank-3 maps, grid.z the member; B a stack
// of `batch` if b_batched, else of one); 0: the 2-D one.  A's rows are lda
// floats apart, B's and B2's ldb (multiples of 4: a staged operand's padded
// rows, whose tail past K or N TMA loads as zeros)
template <class C, bool BATCHED = false, bool ODD = false>
int run(const float* a, const float* b, const float* b2, const float* bias, const float* res,
        float* c, int M, int K, int N, int lda, int ldb, int act, cudaStream_t s,
        int batch = 0, int b_batched = 0) {
  CUtensorMap ta, tb, tb2;
  memset(&tb2, 0, sizeof(tb2));  // unused without the gate
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  int err;
  if constexpr (BATCHED) {
    const long depth = b_batched ? batch : 1;
    err = encode3(fn, &ta, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, M, batch, BK, C::BM,
                  CU_TENSOR_MAP_SWIZZLE_128B, lda);
    for (int j = 0; j < (C::GATE ? 2 : 1) && !err; ++j)
      err = encode3(fn, j ? &tb2 : &tb, j ? b2 : b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K,
                    depth, C::BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE, ldb);
  } else {
    err = encode(fn, &ta, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, M, BK, C::BM,
                 CU_TENSOR_MAP_SWIZZLE_128B, lda);
    if (!err) err = encode(fn, &tb, b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K, C::BN, BK,
                           CU_TENSOR_MAP_SWIZZLE_NONE, ldb);
    if (!err && C::GATE)
      err = encode(fn, &tb2, b2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, K, C::BN, BK,
                   CU_TENSOR_MAP_SWIZZLE_NONE, ldb);
  }
  if (err) return ENCODE_FAILED + err;
  auto kernel = gemm_f32_kernel<C, BATCHED, ODD>;
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

bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// The ODD instantiations' launch (csrc/gemm_f32_odd.cu): run<C, batch > 0,
// true> at tile (bm, bn), cudaErrorInvalidValue for another tile.
int f32_ring_odd(const float* a, const float* b, const float* b2, const float* bias,
                 const float* res, float* c, int M, int K, int N, int lda, int ldb, int act,
                 int bm, int bn, cudaStream_t s, int batch, int b_batched);
