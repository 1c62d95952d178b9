// Tensor-core GEMM with a fused epilogue for Hopper (sm_90a): bf16 operands,
// f32 accumulators, bf16 or f32 output.  wgmma fed by TMA.
//
// Replaces, for bf16 operands, two Pallas kernels with one body:
//  - `repro/kernels/gemm.py` (`_gemm_kernel`, pallas_call at :184), dense
//    "kn": C = epi(A @ B [, A @ B2]), A (M, K) and B, B2 (K, N) row-major;
//  - `repro/kernels/bgemm.py` (`_bgemm_kernel`, pallas_call at :217) in the
//    broadcast-B form of every prefill projection: C[b] = epi(A[b] @ B
//    [, A[b] @ B2]) with A (batch, M, K) contiguous, the same GEMM over its
//    batch * M rows;
//  - the same Pallas kernel in its batched-B form (`bgemm.py:180-182`, every
//    MoE expert launch): C[z] = epi(A[z] @ B[z] [, A[z] @ B2[z]]) with A
//    (batch, M, K), B and B2 (batch, K, N) and C (batch, M, N), one launch
//    for the whole batch (grid.z = batch), in bf16 out or f32 out (the
//    expert down projection's `out_dtype=float32`, an instantiation of its
//    own: a runtime branch in the epilogue slowed the aligned shapes 3-15%);
//  - and the int8 body of both (`gemm.py:63-76`, `bgemm.py:80-90`) in the
//    output-major "nk" layout of `serve --quantize int8`: B and B2 stored
//    (N, K) int8 with one f32 scale for every `qa` output columns across all
//    of K (`QuantSpec(block_m=64, block_n=None, transpose=True)`);
//  - that int8 body in the "kn" layout, stored (K, N) with one f32 scale
//    per (qa, qb) block, qa a multiple of BK, applied to each k-step's
//    partial as it is promoted: the 2-D GEMM (`quantize(w)`'s default
//    layout, a BLAS call) and the batched-B form, the packed expert stacks
//    of a `--quantize int8` MoE (B and B2 (batch, K, N), a member's scales
//    its own).
// bias (N,) and residual (M, N) are bf16, C (M, N) bf16 or f32.  The
// epilogue is common.cuh's `epilogue<T>` on the f32 accumulator (bias, then
// silu, gelu or relu, then the gate multiply, then the residual), rounded
// once to C's type;
// an int8 column's scale multiplies its accumulator first (the reference
// dequantizes B in the f32 accumulator: the two differ at f32 rounding).
// Dense bf16 that TMA cannot address in place (K or N not a multiple of 8,
// a base off 16 bytes) runs here too, on copies of A and B whose rows the
// wrapper pads to 16 bytes (`kernels/gemm.py::tma_rows`), the batched form
// too (N % 8 == 0 there); f32 and f64 have kernels of their own; int8 "kn"
// whose scale block ends inside a k-step or whose rows TMA cannot address,
// "nk" with scales that vary along K, and batched "nk" stay on the
// CUDA-core loop (gemm.cu, gemm_batched*.cu).
// `kernels/gemm.py::plan` picks the route, the tile and the K split from
// the shape alone.
//
// Bound: operations at most served shapes (512 prefill rows: 340-440 flops
// a byte against the card's ridge of ~295; 8192^3: ~2700), bytes at rwkv's
// decay LoRA (2048 -> 64 -> 2048) and, by a hair, at wo with its residual.
// The tensor cores give 989 TFLOP/s in bf16, 15x the CUDA cores' f32 FMA
// rate that gemm.cu runs at.
//
// Design against that bound:
//  - a block owns a BM x BN tile of C: 128 x 128, 128 x 64 or 64 x 64 (the
//    gate's two products take the last two).  One or two consumer
//    warpgroups each own 64 of its rows in f32 registers; one producer
//    thread keeps TMA loads in flight.  (256-wide tiles and the 128 x 128
//    gate tile ran slower at every served shape and at 8192^3, PERF.md);
//  - a k-step's four wgmma.m64nBNk16 of each B operand accumulate in the
//    tensor core into a partial that is then added to the f32 registers
//    with round-to-nearest.  The tensor core's own f32 accumulation is less
//    exact than an FMA chain: left to run over all of K it rounded 5-7x more
//    outputs away from the exact product than FFMA does (0.41% against 0.06%
//    at K = 7168, PERF.md); promoted every 64 k it does better than FFMA;
//  - the K sweep runs in steps of BK = 64 (one 128-byte row of bf16) through
//    a ring of 3-4 shared-memory stages, 128-byte swizzled as wgmma reads
//    them, each guarded by a full and an empty mbarrier.  A consumer waits on
//    a k-step's products before it releases the stage; with two consumer
//    warpgroups one issues while the other drains;
//  - A is K-major (wgmma's native layout); the dense B (K, N) is N-major and
//    enters through wgmma's transpose bit, in 64-column TMA boxes; the int8
//    "nk" B (N, K) is K-major: TMA brings it into a staging buffer and the
//    consumers convert it to bf16 (exact: |v| <= 127) into the swizzled
//    layout, so the same wgmma reads both; the int8 "kn" B (K, N) is
//    N-major: its staging tile (BK k-rows of BN bytes) is converted into the
//    dense B's swizzled N-major boxes, read through the transpose bit as
//    the dense B is, and each k-step's partial is multiplied by its scale
//    row (qa % BK == 0: one per k-step) as it is added to the accumulator.
//    There a warpgroup of its own converts (exact, by byte permutes and an
//    f32 subtraction; I2F runs at a quarter rate) into a ring of bf16
//    stages a stage ahead of the consumers, who only multiply (KnLayout):
//    at BM = 64, 2 or 3 blocks share an SM (the first design, converted in
//    line by the consumers as the "nk" body does, one block an SM, ran
//    moonshot's decode gate+up in 603 us, against 276 now, PERF.md); at BM
//    = 128 (2-D only) one block of two consumer warpgroups, registers moved
//    to them by setmaxnreg, a whole k-step's partial each.  "kn" never
//    splits K: every output is summed over all of K in one order;
//  - TMA fills out-of-bounds rows and columns with zeros, so ragged M, N and
//    K need no padding; the stores skip the fringe.  The batched form
//    (BATCHED, instantiations of their own: made the one body, rank-3 maps
//    slowed the 2-D 128 x 128 tile 14% at 8192^3, measured on one H100)
//    reads rank-3 maps (batch outermost): a tile past the last row or
//    column of member z loads zeros, not member z + 1's first rows; a
//    broadcast B is a stack of one, read at z = 0 by every member.  TMA needs 16-byte row
//    strides and base addresses, so A and B carry row strides of their own
//    (lda, ldb: multiples of 8 elements) and a padded row's tail, past K or
//    N, loads as zeros.  C takes any N and any bf16 address: column pairs
//    are one 4-byte store where N is even and C starts on 4 bytes, else (an
//    instantiation of its own, ODD, so the even path carries no branch for
//    it) two 2-byte ones;
//  - narrow 2-D outputs split K (`splits` slices of whole k-steps, grid.y;
//    never with a batch, whose grid has batch x tiles blocks already): each
//    slice writes f32 partials to a workspace and a second pass sums the
//    slices in a fixed order and applies the epilogue, so two launches on
//    the same inputs give the same bits (no atomics), as bgemv.cu does;
//  - tiles are visited in groups of 8 tile rows, so blocks that run together
//    share their B panel in L2.
// Later work (not here): a persistent, warp-specialized loop that overlaps
// one tile's epilogue with the next tile's loads; TMA stores.
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

using namespace rt;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;             // k per stage: one 128-byte swizzled row of bf16
constexpr int GROUP = 8;           // tile rows of the grouped raster
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use (227 KB)
constexpr int SW = 1024;           // the 128-byte swizzle repeats every 8 rows

// B's form: bf16 (K, N), or int8 stored (N, K) ("nk") or (K, N) ("kn")
enum { DENSE = 0, INT8_NK = 1, INT8_KN = 2 };

template <int BM_, int BN_, bool GATE_, int Q_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr bool GATE = GATE_;
  static constexpr int Q = Q_;  // DENSE, INT8_NK or INT8_KN
  static constexpr int NC = BM / 64;                  // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);      // + the producer warpgroup
  static constexpr int NB = GATE ? 2 : 1;             // B operands
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;         // one bf16 B tile
  static constexpr int Q_BYTES = Q ? BN * BK : 0;     // one int8 staging tile
  static constexpr int STAGE = A_BYTES + NB * (B_BYTES + Q_BYTES);
  static constexpr int TX = A_BYTES + NB * (Q ? Q_BYTES : B_BYTES);  // bytes TMA brings
  static constexpr int STAGES = (SMEM_MAX - 2 * SW) / STAGE < 4 ? (SMEM_MAX - 2 * SW) / STAGE : 4;
  static constexpr int SMEM = STAGES * STAGE + SW + 2 * STAGES * 8;
  // two at least: with int8 B a warpgroup converts into stage s while the
  // other may still be one step behind, multiplying from the stage before
  static_assert(STAGES >= 2, "tile too large for the shared-memory ring");
  static_assert(STAGE % SW == 0, "every bf16 tile must start on a swizzle period");
};

// The int8 "kn" form's shared memory: STAGES staging stages (A | int8 B |
// int8 B2, filled by TMA), then BUFS bf16 stages (B | B2, filled by the
// converter warpgroup from the staging stages), then the barriers (full
// and empty a staging stage, conv and free a bf16 stage) and each bf16
// stage's column scales [BUFS][NB][BN].  BM = 64 (one consumer warpgroup,
// the batched form's tile): BLOCKS blocks share an SM (98 KB of shared
// memory with the gate, 66 KB without), so that one block's loads,
// conversion and wgmma overlap another's; 6 staging stages, which leave
// room for fewer, ran slower (`scripts/torch_gemm_study.py packed`).  BM =
// 128 (WIDE: two consumer warpgroups, 2-D only): one block an SM, whose two
// consumer warpgroups overlap each other's promotion, two converter
// warpgroups (one could not convert a 64 x 128 stage as fast as the
// consumers multiply it: PERF.md) and 6 staging stages (the loads are
// issued by a converter thread, 4 steps ahead of it).
template <class C>
struct KnLayout {
  static constexpr bool WIDE = C::NC == 2;
  static constexpr int STAGES = WIDE ? 6 : 4, BUFS = 2;  // a bf16 stage is staging stage s % BUFS's
  static_assert(STAGES % BUFS == 0, "bf16 stage of a staging stage");
  static constexpr int BLOCKS = WIDE ? 1 : C::GATE ? 2 : 3;
  static constexpr int CONVERTERS = (WIDE ? 2 : 1) * 128;  // converter threads
  static constexpr int THREADS = C::NC * 128 + CONVERTERS;
  // BM = 64 without the gate (80 registers a thread at 3 blocks): the
  // consumers take 104 and the converters 56 (setmaxnreg): the down launch
  // ran slower in 80 each (`scripts/torch_gemm_study.py packed`).  The
  // gate's warpgroups keep the 128 of 2 blocks (its consumers hold two
  // accumulators and half a partial; with the registers moved, ptxas
  // spilled one in the converters, whatever their share).  WIDE: 128 a
  // thread at one block of 512 threads; each consumer holds a 64 x BN
  // accumulator (two with the gate) and a partial of 64 columns
  static constexpr bool SPLIT_REGS = WIDE || !C::GATE;
  static constexpr int CONVERTER_REGS = WIDE ? 72 : 56, CONSUMER_REGS = WIDE ? 184 : 104;
  static_assert(!SPLIT_REGS ||
                    (CONVERTERS * CONVERTER_REGS + C::NC * 128 * CONSUMER_REGS) * BLOCKS <= 65536,
                "register file");
  // a k-step's partial covers BN / HALVES columns, one wgmma group each: 32
  // at BM = 64 (the registers of 2 or 3 blocks an SM), 64 at BM = 128 (half
  // of a 128-column tile ran faster than all of it, PERF.md)
  static constexpr int HALVES = WIDE ? C::BN / 64 : 2;
  static constexpr int STAGE = C::A_BYTES + C::NB * C::Q_BYTES;
  static constexpr int BUF = C::NB * C::B_BYTES;
  static constexpr int BARRIERS = STAGES * STAGE + BUFS * BUF;
  static constexpr int SCALES = BARRIERS + 2 * (STAGES + BUFS) * 8;
  static constexpr int SMEM = SCALES + BUFS * C::NB * C::BN * 4 + SW;
  static_assert(STAGE % SW == 0 && BUF % SW == 0, "tiles must start on a swizzle period");
};

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1): start
// address, leading and stride byte offsets, each >> 4.  K-major tiles (A, and
// the converted int8 B) are rows of 128 bytes: 8-row groups 1024 bytes apart
// (stride), the leading offset unused (1); a k16 step advances the start by
// 32 bytes inside the swizzled row.  The N-major dense B is 64-column boxes
// of 64 k-rows: 8-k-row groups 1024 bytes apart (stride), boxes BK * 128
// bytes apart along N (leading); a k16 step advances 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// The accumulators are written by asynchronous wgmma: this keeps the
// compiler from moving their reads across a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) = A (64 x 16, K-major) * B (16 x N) [+ D if acc]; TB = 1:
// B N-major.
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_n32<TB>(d, da, db, acc);
  else if constexpr (N == 64) wgmma_n64<TB>(d, da, db, acc);
  else wgmma_n128<TB>(d, da, db, acc);
}

// int8 staging tile (BN rows of 64 k-bytes, as TMA wrote it) -> bf16 in the
// K-major swizzled layout: 16 values a thread a step, two 16-byte chunks.
template <int BN, int THREADS>
__device__ __forceinline__ void convert_int8(const int8_t* __restrict__ src, uint8_t* dst,
                                             int tid) {
#pragma unroll
  for (int u = tid; u < BN * 4; u += THREADS) {
    const int n = u >> 2, kc = u & 3;
    const int4 raw = *reinterpret_cast<const int4*>(src + n * BK + kc * 16);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    uint32_t packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(static_cast<float>(v[2 * e]),
                                                     static_cast<float>(v[2 * e + 1]));
      packed[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int chunk = (kc * 2 + h) ^ (n & 7);
      *reinterpret_cast<int4*>(dst + n * 128 + chunk * 16) =
          make_int4(packed[4 * h], packed[4 * h + 1], packed[4 * h + 2], packed[4 * h + 3]);
    }
  }
}

// Four int8 (one word) -> two bf16x2 words, exactly, on the full-rate ALUs
// (I2F runs at a quarter rate): byte b becomes the f32 2^23 + (b ^ 0x80)
// (a PRMT into 0x4B000000), minus 2^23 + 128 is b as an f32 integer of at
// most 8 bits, whose bf16 is its upper half (a PRMT of two).
__device__ __forceinline__ uint2 int8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) -
                           8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// NB int8 "kn" staging tiles (BK k-rows of BN bytes each, as TMA wrote them,
// SRC_STRIDE bytes apart) -> bf16 in the dense B's N-major layout (DST_STRIDE
// bytes apart): 64-column boxes of BK k-rows of 128 bytes, 16-byte chunk c
// of k-row r at c ^ (r % 8) (the 128-byte swizzle).  8 values a thread a
// step, THREADS threads from `tid`, unrolled so that a thread's loads fly
// together (one converter warp a scheduler hides no latency of its own).
template <int BN, int NB, int SRC_STRIDE, int DST_STRIDE, int THREADS>
__device__ __forceinline__ void convert_kn(const int8_t* __restrict__ src, uint8_t* dst,
                                           int tid) {
  constexpr int UNITS = BK * BN / 8, STEPS = (NB * UNITS + THREADS - 1) / THREADS;
  uint2 raw[STEPS];
#pragma unroll
  for (int t = 0; t < STEPS; ++t) {
    const int u = tid + t * THREADS, j = u / UNITS, r = u % UNITS / (BN / 8), c8 = u % (BN / 8);
    if (u < NB * UNITS)
      raw[t] = *reinterpret_cast<const uint2*>(src + j * SRC_STRIDE + r * BN + c8 * 8);
  }
#pragma unroll
  for (int t = 0; t < STEPS; ++t) {
    const int u = tid + t * THREADS, j = u / UNITS, r = u % UNITS / (BN / 8), c8 = u % (BN / 8);
    if (u < NB * UNITS) {
      const uint2 lo = int8x4_to_bf16x4(raw[t].x), hi = int8x4_to_bf16x4(raw[t].y);
      const int chunk = (c8 & 7) ^ (r & 7);
      *reinterpret_cast<uint4*>(dst + j * DST_STRIDE + (c8 >> 3) * BK * 128 + r * 128 +
                                chunk * 16) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// Two adjacent outputs, rounded once to C's type: one 4-byte (bf16) or
// 8-byte (f32) store.
template <typename TO>
__device__ __forceinline__ void store_pair(TO* c, float h0, float h1) {
  if constexpr (std::is_same_v<TO, float>)
    *reinterpret_cast<float2*>(c) = make_float2(h0, h1);
  else
    *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(h0, h1);
}

// One C tile, or one K slice of it (grid.y = split); BATCHED: of batch
// member blockIdx.z (B's member z if b_batched, else its only one), one K
// slice, rank-3 maps.  Q == INT8_NK: B, B2 int8 "nk" through tb/tb2 with
// scales bs/b2s (column n's is bs[n / qa]); Q == INT8_KN: int8 "kn" (K, N)
// (a member), scales (K / qa, N / qb) (BATCHED: member z's, starting z *
// (K / qa) * (N / qb) on if b_batched), the scale of (k, n) at [k / qa][n /
// qb], one K slice; DENSE: bf16 (K, N).  splits > 1: f32 partials to ws
// [(GATE ? 2 : 1) * splits][M][N] (the gate's after B's) and
// splitk_epilogue finishes.  ODD: N is odd or C
// is off 4 bytes (dense B only, one K slice; int8 B is never ODD).  TO: C's
// type, bf16 or float (float: BATCHED only).
template <int BM, int BN, bool GATE, int Q, bool ODD, bool BATCHED, typename TO>
__global__ void __launch_bounds__(Q == INT8_KN ? KnLayout<Cfg<BM, BN, GATE, Q>>::THREADS
                                               : Cfg<BM, BN, GATE, Q>::THREADS,
                                  Q == INT8_KN ? KnLayout<Cfg<BM, BN, GATE, Q>>::BLOCKS : 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tb2, const float* __restrict__ bs,
               const float* __restrict__ b2s, int qa, int qb, const bf16* __restrict__ bias,
               const bf16* __restrict__ res, TO* __restrict__ c, float* __restrict__ ws,
               int b_batched, int M, int K, int N, int act, int splits) {
  using C = Cfg<BM, BN, GATE, Q>;
  // KN: int8 stored (K, N), scaled each k-step, on KnLayout's two rings:
  // the last warpgroup converts each staging stage's int8 into a bf16
  // stage (and writes its column scales) and arrives on its `conv` barrier,
  // so the consumers only multiply while the next stages convert.  Each
  // consumer warpgroup frees a bf16 stage (and with it its staging stage)
  // on its own; with one, its first thread loads the next step into the
  // staging stage, with two, the first converter thread does once both
  // have freed it
  constexpr bool KN = Q == INT8_KN;
  using L = KnLayout<C>;
  constexpr int NC = C::NC, STAGES = KN ? L::STAGES : C::STAGES;
  constexpr int STAGE = KN ? L::STAGE : C::STAGE;
  constexpr int CONVERTERS = KN ? L::CONVERTERS : 128;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((SW - (smem_u32(smem_raw) & (SW - 1))) & (SW - 1));
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + (KN ? L::BARRIERS : STAGES * C::STAGE), empty0 = full0 + STAGES * 8;
  const uint32_t conv0 = empty0 + STAGES * 8, free0 = conv0 + L::BUFS * 8;  // KN
  float* sc = reinterpret_cast<float*>(smem + L::SCALES);                    // KN
  // stage s: A | B | B2 | int8 staging of B | of B2 (KN: A | int8 B | int8 B2)
  auto a_at = [&](int s) { return base + s * STAGE; };
  auto b_at = [&](int s, int j) { return a_at(s) + C::A_BYTES + j * C::B_BYTES; };
  auto q_at = [&](int s, int j) {
    return (KN ? a_at(s) + C::A_BYTES : b_at(s, C::NB)) + j * C::Q_BYTES;
  };
  // KN: bf16 stage t's B (j = 0) or B2 (j = 1)
  auto kb_at = [&](int t, int j) { return base + STAGES * STAGE + t * L::BUF + j * C::B_BYTES; };

  // grouped raster: GROUP tile rows sweep the tile columns together
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP * tiles_n;
  const int first = blockIdx.x / per_group * GROUP;
  const int rows_here = min(tiles_m - first, GROUP);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows_here) * BM;
  const int n0 = (in_group / rows_here) * BN;
  // this block's K slice: whole k-steps [kt0, kt1)
  const int split = blockIdx.y, kts = (K + BK - 1) / BK;
  const int kt0 = KN ? 0 : static_cast<int>(static_cast<long>(split) * kts / splits);
  const int kt1 = KN ? kts : static_cast<int>(static_cast<long>(split + 1) * kts / splits);
  // this block's batch member: A's and C's z, and B's where B has a batch axis
  const int z = BATCHED ? blockIdx.z : 0, bz = b_batched ? z : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC);
    }
    if constexpr (KN) {
#pragma unroll
      for (int t = 0; t < L::BUFS; ++t) {
        mbar_init(conv0 + 8 * t, CONVERTERS);
        mbar_init(free0 + 8 * t, NC);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  // KN: step kt's loads into staging stage s
  auto kn_load = [&](int kt, int s) {
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, C::TX);
    if constexpr (BATCHED) {
      tma_load3(a_at(s), &ta, full, kt * BK, m0, z);
      tma_load3(q_at(s, 0), &tb, full, n0, kt * BK, bz);
      if constexpr (GATE) tma_load3(q_at(s, 1), &tb2, full, n0, kt * BK, bz);
    } else {
      tma_load(a_at(s), &ta, full, kt * BK, m0);
      tma_load(q_at(s, 0), &tb, full, n0, kt * BK);
      if constexpr (GATE) tma_load(q_at(s, 1), &tb2, full, n0, kt * BK);
    }
  };
  const int wg = threadIdx.x / 128;
  if (wg >= NC) {
    // ---- producer: one thread keeps the ring full (KN: converters) ----
    if constexpr (KN) {
      if constexpr (L::SPLIT_REGS)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(L::CONVERTER_REGS));
    } else if constexpr (NC == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    }
    if (!KN && threadIdx.x == NC * 128) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % STAGES;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, C::TX);
        const int k0 = kt * BK;
        if constexpr (BATCHED) {
          tma_load3(a_at(s), &ta, full, k0, m0, z);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load3(b_at(s, 0) + j * BK * 128, &tb, full, n0 + 64 * j, k0, bz);
            if constexpr (GATE)
              tma_load3(b_at(s, 1) + j * BK * 128, &tb2, full, n0 + 64 * j, k0, bz);
          }
        } else {
          tma_load(a_at(s), &ta, full, k0, m0);
          if constexpr (Q == INT8_NK) {
            tma_load(q_at(s, 0), &tb, full, k0, n0);
            if constexpr (GATE) tma_load(q_at(s, 1), &tb2, full, k0, n0);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) {
              tma_load(b_at(s, 0) + j * BK * 128, &tb, full, n0 + 64 * j, k0);
              if constexpr (GATE)
                tma_load(b_at(s, 1) + j * BK * 128, &tb2, full, n0 + 64 * j, k0);
            }
          }
        }
      }
    } else if (KN) {
      // ---- converters (KN): the warpgroups past the consumers ----
      const int ct = threadIdx.x - NC * 128;
      // this converter's column scales (u < NB * BN: B's column u, or B2's
      // u - BN; a column clamped at N - 1, whose products are 0), member z's,
      // each k-step's loaded a step ahead (a load's latency exceeds a step)
      static_assert(C::NB * BN <= 2 * CONVERTERS, "two scales a converter");
      const float* sz[2];
      long col[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = ct + h * CONVERTERS;
        sz[h] = (u < BN ? bs : b2s) + static_cast<long>(bz) * (K / qa) * (N / qb);
        col[h] = u < C::NB * BN ? min(n0 + u % BN, N - 1) / qb : -1;
      }
      auto scales = [&](int kt, float (&v)[2]) {
        const long row = static_cast<long>(kt * BK / qa) * (N / qb);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (col[h] >= 0 && kt < kt1) v[h] = sz[h][row + col[h]];
      };
      float sv[2], next[2];
      scales(kt0, sv);
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % STAGES, t = s % L::BUFS;
        scales(kt + 1, next);
        mbar_wait(free0 + 8 * t, ((i / L::BUFS) & 1) ^ 1);  // bf16 stage free: step i - BUFS done
        // two consumer warpgroups: step i - BUFS's staging stage takes the
        // step STAGES on
        if (NC == 2 && ct == 0 && i >= L::BUFS && kt - L::BUFS + STAGES < kt1)
          kn_load(kt - L::BUFS + STAGES, (s + STAGES - L::BUFS) % STAGES);
        mbar_wait(full0 + 8 * s, (i / STAGES) & 1);  // int8 landed
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = ct + h * CONVERTERS;
          if (col[h] >= 0) sc[(t * C::NB + u / BN) * BN + u % BN] = sv[h];
          sv[h] = next[h];
        }
        convert_kn<BN, C::NB, C::Q_BYTES, C::B_BYTES, CONVERTERS>(
            reinterpret_cast<const int8_t*>(smem + (q_at(s, 0) - base)),
            smem + (kb_at(t, 0) - base), ct);
        // generic-proxy writes, read next by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(conv0 + 8 * t);
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies rows wg*64 .. wg*64+63 ----
    if constexpr (KN) {
      if constexpr (L::SPLIT_REGS)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(L::CONSUMER_REGS));
    } else if constexpr (NC == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    }
    // A k-step's four k16 products of each B operand accumulate in the tensor
    // core into `part` (`part2`), which is then added to the f32 accumulator
    // with round-to-nearest (promotion): the tensor core's own f32
    // accumulation is less exact than an FMA chain, and over a long K it left
    // 5-7x more outputs off the correctly rounded product than the CUDA cores
    // do (PERF.md).
    constexpr int R = BN / 2;  // accumulators a thread
    // KN: a partial of BN / HALVES columns (at BM = 64 half the tile's: the
    // gate's consumers keep to the registers that let two blocks share an SM)
    constexpr int W = KN ? BN / L::HALVES : BN;
    float acc[R], acc2[GATE ? R : 1], part[W / 2], part2[GATE && !KN ? R : 1];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i] = 0.f;
      if constexpr (GATE) acc2[i] = 0.f;
    }
    constexpr bool NK = Q == INT8_NK;  // int8 stored (N, K): read K-major
    constexpr int TB = NK ? 0 : 1;
    constexpr uint32_t B_LEAD = NK ? 16 : BK * 128;
    if (KN && threadIdx.x == 0)
      for (int kt = kt0; kt < min(kt1, kt0 + STAGES); ++kt) kn_load(kt, (kt - kt0) % STAGES);
    for (int kt = kt0; kt < kt1; ++kt) {
      const int i = kt - kt0, s = i % STAGES, t = KN ? s % L::BUFS : s;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      if constexpr (KN) mbar_wait(conv0 + 8 * t, (i / L::BUFS) & 1);  // B converted
      if constexpr (NK) {
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
          convert_int8<BN, NC * 128>(reinterpret_cast<const int8_t*>(smem + (q_at(s, j) - base)),
                                     smem + (b_at(s, j) - base), threadIdx.x);
        // generic-proxy writes, read next by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" ::"n"(NC * 128) : "memory");
      }
      if constexpr (KN) {
        // B's k-step (j = 0), then B2's, each in HALVES parts of W columns
        // (h) through one partial, added as acc += s[k / qa][n / qb] * partial
        auto multiply = [&](float (&d)[R], int j) {
#pragma unroll
          for (int h = 0; h < L::HALVES; ++h) {
            fence_acc(part);
            wg_fence();
            // columns W h..: in 64-column box W h / 64, 2 (W h % 64) bytes on in its rows
            const uint32_t hb = (h * W / 64) * BK * 128 + (h * W % 64) * 2;
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              wgmma<W, 1>(part, sw128_desc(a_at(s) + wg * 64 * 128 + kk * 32, 16, SW),
                          sw128_desc(kb_at(t, j) + kk * 16 * 128 + hb, BK * 128, SW), kk > 0);
            wg_commit();
            wg_wait<0>();
            fence_acc(part);
            const float* row = sc + (t * C::NB + j) * BN + h * W + (threadIdx.x & 3) * 2;
#pragma unroll
            for (int c = 0; c < W / 2; c += 4) {  // columns W h + 8 (c / 4) + 2 (lane % 4) + {0, 1}
              const float2 v = *reinterpret_cast<const float2*>(row + (c >> 2) * 8);
              float* o = d + h * (W / 2) + c;
              o[0] = fmaf(v.x, part[c], o[0]);
              o[1] = fmaf(v.y, part[c + 1], o[1]);
              o[2] = fmaf(v.x, part[c + 2], o[2]);
              o[3] = fmaf(v.y, part[c + 3], o[3]);
            }
          }
        };
        multiply(acc, 0);
        if constexpr (GATE) multiply(acc2, 1);
      } else {
        fence_acc(part);
        if constexpr (GATE) fence_acc(part2);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = sw128_desc(a_at(s) + wg * 64 * 128 + kk * 32, 16, SW);
          const uint32_t koff = NK ? kk * 32 : kk * 16 * 128;
          wgmma<BN, TB>(part, da, sw128_desc(b_at(s, 0) + koff, B_LEAD, SW), kk > 0);
          if constexpr (GATE)
            wgmma<BN, TB>(part2, da, sw128_desc(b_at(s, 1) + koff, B_LEAD, SW), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_acc(part);
        if constexpr (GATE) fence_acc(part2);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          acc[j] += part[j];
          if constexpr (GATE) acc2[j] += part2[j];
        }
      }
      // this step's products are done: free its stage.  (Keeping a group in
      // flight across the loop's back edge, where the compiler may move
      // registers, makes ptxas serialize every wgmma, C7515.)  KN: once every
      // warp of this consumer warpgroup has read the stage's A, B and
      // scales, free its bf16 stage (and its staging stage) and, one
      // consumer warpgroup, load the step STAGES on into its staging stage
      if constexpr (KN) {
        if (wg == 0)  // named barriers 1 and 2 (an immediate id: a register one reserves all 16)
          asm volatile("bar.sync 1, 128;" ::: "memory");
        else
          asm volatile("bar.sync 2, 128;" ::: "memory");
        if (threadIdx.x % 128 == 0) {
          mbar_arrive(free0 + 8 * t);
          if (NC == 1 && kt + STAGES < kt1) kn_load(kt + STAGES, s);
        }
      } else if (threadIdx.x % 128 == 0) {
        mbar_arrive(empty0 + 8 * s);
      }
    }

    // ---- epilogue from the registers: thread (warp w, lane l) holds rows
    // 16w + l/4 (+8) and column pairs 8j + 2(l%4) of its warpgroup's 64 rows
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const long plane = static_cast<long>(M) * N;
    if constexpr (BATCHED) {  // batch member z's C and residual
      c += z * plane;
      if (res) res += z * plane;
    }
    // a column pair is one 4-byte store, or with ODD two element stores and
    // a column at N neither computed nor read (bias, residual)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      const bool two = !ODD || col + 1 < N;  // N is even without ODD
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        const long o = static_cast<long>(row) * N + col;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        float g0 = 0.f, g1 = 0.f;
        if constexpr (GATE) {
          g0 = acc2[4 * j + 2 * h];
          g1 = acc2[4 * j + 2 * h + 1];
        }
        if (splits > 1) {
          *reinterpret_cast<float2*>(ws + split * plane + o) = make_float2(v0, v1);
          if constexpr (GATE)
            *reinterpret_cast<float2*>(ws + (splits + split) * plane + o) = make_float2(g0, g1);
          continue;
        }
        float s0 = 1.f, s1 = 1.f, t0 = 1.f, t1 = 1.f;
        if constexpr (NK) {
          s0 = bs[col / qa];
          s1 = bs[(col + 1) / qa];
          if constexpr (GATE) {
            t0 = b2s[col / qa];
            t1 = b2s[(col + 1) / qa];
          }
        }
        const float h0 = epilogue<bf16>(v0 * s0, g0 * t0, bias, res, col, o, act, GATE);
        const float h1 =
            two ? epilogue<bf16>(v1 * s1, g1 * t1, bias, res, col + 1, o + 1, act, GATE) : 0.f;
        if constexpr (ODD) {
          c[o] = from_f<TO>(h0);
          if (two) c[o + 1] = from_f<TO>(h1);
        } else {
          store_pair(c + o, h0, h1);
        }
      }
    }
  }
}

// The split-K second pass: each thread sums one column pair over the slices
// in slice order (deterministic), scales (int8), applies the epilogue.
template <bool GATE, bool Q>
__global__ void __launch_bounds__(256)
splitk_epilogue(const float* __restrict__ ws, int splits, const float* __restrict__ bs,
                const float* __restrict__ b2s, int qa, const bf16* __restrict__ bias,
                const bf16* __restrict__ res, bf16* __restrict__ c, int M, int N, int act) {
  const long plane = static_cast<long>(M) * N;
  const long o = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (o >= plane) return;
  const int col = static_cast<int>(o % N);
  float v0 = 0.f, v1 = 0.f, g0 = 0.f, g1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(ws + s * plane + o);
    v0 += p.x;
    v1 += p.y;
    if constexpr (GATE) {
      const float2 q = *reinterpret_cast<const float2*>(ws + (splits + s) * plane + o);
      g0 += q.x;
      g1 += q.y;
    }
  }
  if constexpr (Q) {
    v0 *= bs[col / qa];
    v1 *= bs[(col + 1) / qa];
    if constexpr (GATE) {
      g0 *= b2s[col / qa];
      g1 *= b2s[(col + 1) / qa];
    }
  }
  const float h0 = epilogue<bf16>(v0, g0, bias, res, col, o, act, GATE);
  const float h1 = epilogue<bf16>(v1, g1, bias, res, col + 1, o + 1, act, GATE);
  *reinterpret_cast<__nv_bfloat162*>(c + o) = __floats2bfloat162_rn(h0, h1);
}

// ---- host side -------------------------------------------------------------

struct Args {
  const void *a, *b, *b2;
  const float *bs, *b2s;
  int qa, qb;
  const bf16 *bias, *res;
  void* c;
  float* ws;
  int batch, b_batched, M, K, N, lda, ldb, act, splits;
  cudaStream_t stream;
};

constexpr int ENCODE_FAILED = 1000;  // + the CUresult

template <class C, bool ODD, bool BATCHED, typename TO>
int launch_tiles(const Args& g, const CUtensorMap& ta, const CUtensorMap& tb,
                 const CUtensorMap& tb2) {
  auto kernel = gemm_tc_kernel<C::BM, C::BN, C::GATE, C::Q, ODD, BATCHED, TO>;
  constexpr int SMEM = C::Q == INT8_KN ? KnLayout<C>::SMEM : C::SMEM;
  constexpr int THREADS = C::Q == INT8_KN ? KnLayout<C>::THREADS : C::THREADS;
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long tiles = static_cast<long>((g.M + C::BM - 1) / C::BM) * ((g.N + C::BN - 1) / C::BN);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(g.splits),
                  static_cast<unsigned>(g.batch));
  kernel<<<grid, THREADS, SMEM, g.stream>>>(ta, tb, tb2, g.bs, g.b2s, g.qa, g.qb, g.bias,
                                                  g.res, static_cast<TO*>(g.c), g.ws,
                                                  g.b_batched, g.M, g.K, g.N, g.act, g.splits);
  return static_cast<int>(cudaGetLastError());
}

// The 2-D launch: rank-2 maps, C bf16, K split in `splits` slices (not
// with int8 "kn" B, stored (K, N) in boxes of BN bytes).
template <class C>
int run(const Args& g) {
  constexpr int BM = C::BM, BN = C::BN, Q = C::Q;
  constexpr bool GATE = C::GATE;
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb, tb2;
  memset(&tb2, 0, sizeof(tb2));
  int err = encode(fn, &ta, g.a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.K, g.M, BK, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B, g.lda);
  for (int j = 0; j < (GATE ? 2 : 1) && !err; ++j) {
    CUtensorMap* map = j ? &tb2 : &tb;
    const void* ptr = j ? g.b2 : g.b;
    err = Q == INT8_NK ? encode(fn, map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.K, g.N, BK, BN,
                                CU_TENSOR_MAP_SWIZZLE_NONE)
        : Q == INT8_KN ? encode(fn, map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.N, g.K, BN, BK,
                                CU_TENSOR_MAP_SWIZZLE_NONE)
                       : encode(fn, map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.N, g.K, 64,
                                BK, CU_TENSOR_MAP_SWIZZLE_128B, g.ldb);
  }
  if (err) return ENCODE_FAILED + err;
  int e;
  if constexpr (Q) {
    e = launch_tiles<C, false, false, bf16>(g, ta, tb, tb2);
  } else {
    const bool odd = g.N % 2 || (reinterpret_cast<uintptr_t>(g.c) & 3);
    e = odd ? launch_tiles<C, true, false, bf16>(g, ta, tb, tb2)
            : launch_tiles<C, false, false, bf16>(g, ta, tb, tb2);
  }
  if (e != cudaSuccess || g.splits == 1 || Q == INT8_KN) return e;
  const long pairs = static_cast<long>(g.M) * g.N / 2;
  splitk_epilogue<GATE, Q == INT8_NK><<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, g.stream>>>(
      g.ws, g.splits, g.bs, g.b2s, g.qa, g.bias, g.res, static_cast<bf16*>(g.c), g.M, g.N, g.act);
  return static_cast<int>(cudaGetLastError());
}

// The batched launch: rank-3 maps over the batch, one K slice, C in TO; B
// bf16 in 64-column boxes, or (C::Q) int8 "kn" in boxes of BN bytes.
template <class C, typename TO>
int run_batched(const Args& g) {
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb, tb2;
  memset(&tb2, 0, sizeof(tb2));
  const long b_depth = g.b_batched ? g.batch : 1;
  int err = encode3(fn, &ta, g.a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.K, g.M, g.batch, BK,
                    C::BM, CU_TENSOR_MAP_SWIZZLE_128B, g.lda);
  for (int j = 0; j < (C::GATE ? 2 : 1) && !err; ++j)
    err = C::Q ? encode3(fn, j ? &tb2 : &tb, j ? g.b2 : g.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         g.N, g.K, b_depth, C::BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE, g.ldb)
               : encode3(fn, j ? &tb2 : &tb, j ? g.b2 : g.b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         g.N, g.K, b_depth, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B, g.ldb);
  if (err) return ENCODE_FAILED + err;
  return launch_tiles<C, false, true, TO>(g, ta, tb, tb2);
}

// f(Cfg<...>{}) for the instantiated configuration, or -1 if there is none
// (int8 "kn" without the gate: no 128 x 64, which lost to 64 x 64)
template <bool GATE, int Q, class F>
int by_tile(int bm, int bn, F f) {
  if constexpr (GATE || Q != INT8_KN) {
    if (bm == 128 && bn == 64) return f(Cfg<128, 64, GATE, Q>{});
  }
  if (bm == 64 && bn == 64) return f(Cfg<64, 64, GATE, Q>{});
  if constexpr (!GATE) {  // the gate's four register tiles stop at BN = 64
    if (bm == 128 && bn == 128) return f(Cfg<128, 128, GATE, Q>{});
  }
  return -1;
}

// The batched launch's tiles: BN = 64 (the MoE experts' 32 or 64 rows a
// member take BM = 64), B bf16 or int8 "kn" (BM = 64 only: 2 or 3 blocks an
// SM, whose converters and consumers overlap)
template <bool GATE, int Q, class F>
int by_batched_tile(int bm, int bn, F f) {
  if constexpr (Q == DENSE) {
    if (bm == 128 && bn == 64) return f(Cfg<128, 64, GATE, Q>{});
  }
  if (bm == 64 && bn == 64) return f(Cfg<64, 64, GATE, Q>{});
  return -1;
}

template <class F>
int by_config(int bm, int bn, bool gate, int q, F f) {
  if (q == INT8_NK)
    return gate ? by_tile<true, INT8_NK>(bm, bn, f) : by_tile<false, INT8_NK>(bm, bn, f);
  if (q == INT8_KN)
    return gate ? by_tile<true, INT8_KN>(bm, bn, f) : by_tile<false, INT8_KN>(bm, bn, f);
  return gate ? by_tile<true, DENSE>(bm, bn, f) : by_tile<false, DENSE>(bm, bn, f);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// C[z] (M, N) = epi(A[z] (M, K) @ B[z] [, A[z] @ B2[z]]) for z < batch in
// one launch on the tensor cores, over a bm x bn tile grid a member with K
// cut into `splits` slices (batch 1 only; ws: (b2 ? 2 : 1) * splits * M * N
// f32 when splits > 1, else unused).  A is `batch` matrices of M rows, each
// row lda elements apart (a multiple of 8, >= K; its base on 16 bytes).
// bs == NULL: B, B2 bf16 (K, N), rows ldb elements apart (a multiple of 8,
// >= N; bases on 16 bytes), `batch` of them if b_batched, else one shared
// by every member.  Else, with qb == 0 (batch 1), B, B2 int8 stored (N, K)
// with f32 scales bs, b2s, one for every qa columns (K % 16 == 0, lda == K,
// ldb unused); with qb >= 1, B, B2 int8 stored (K, N) ("kn", ldb == N, N %
// 16 == 0, one K slice), `batch` of them if b_batched, with f32 scales (K /
// qa, N / qb) a member (qa % 64 == 0, K % qa == 0, N % qb == 0).  out_f32 =
// 0: C bf16 (batch, M, N), contiguous, on any bf16; K splits and int8 B
// need an even N and C on 4 bytes.  out_f32 = 1 (one K slice): C f32, N
// even, C on 8 bytes.  batch > 1 or out_f32 is the batched launch (rank-3
// maps): dense or "kn" B, N % 8 == 0, C on 16 bytes, one K slice, BN = 64
// tiles (BM = 64 with "kn" B); else the 2-D launch (rank-2 maps: 128 x 128,
// 128 x 64, 64 x 64 tiles, the gate's the last two, "kn" B too).  bias (N,)
// and res (batch, M, N) are bf16; b2/b2s, bias and res
// may be NULL.  Returns cudaErrorInvalidValue
// for a shape, tile or address the kernel does not take, 1000 + a CUresult
// if a TMA descriptor is refused, else cudaGetLastError() after the
// launches.
extern "C" int gemm_tc_launch(const void* a, const void* b, const void* b2, const void* bs,
                              const void* b2s, int qa, int qb, const void* bias, const void* res,
                              void* c, void* ws, int batch, int b_batched, int M, int K, int N,
                              int lda, int ldb, int act, int out_f32, int bm, int bn, int splits,
                              void* stream) {
  const bool q = bs != nullptr, gate = b2 != nullptr;
  const int kts = (K + BK - 1) / BK;
  const uintptr_t ca = reinterpret_cast<uintptr_t>(c);
  const bool pairs = N % 2 == 0 && (ca & 3) == 0;
  const bool kn = q && qb >= 1;
  const bool batched = batch > 1 || out_f32;
  const bool ok = batch >= 1 && batch <= 65535 && M > 0 && N > 0 && K > 0 && lda >= K &&
                  lda % 8 == 0 && aligned16(a) && aligned16(b) && (!gate || aligned16(b2)) &&
                  (ca & 1) == 0 && splits >= 1 && splits <= kts &&
                  (splits == 1 || (ws != nullptr && pairs && !batched && !kn)) &&
                  (!batched || ((!q || kn) && N % 8 == 0 && (ca & 15) == 0)) &&
                  (kn   ? qa % BK == 0 && K % qa == 0 && N % qb == 0 && N % 16 == 0 &&
                              ldb == N && pairs && (!gate || b2s != nullptr)
                   : q  ? K % 16 == 0 && lda == K && N % 8 == 0 && pairs && qa >= 1 &&
                              N % qa == 0 && (!gate || b2s != nullptr)
                        : ldb >= N && ldb % 8 == 0);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args g{a, b, b2, static_cast<const float*>(bs), static_cast<const float*>(b2s), qa, qb,
               static_cast<const bf16*>(bias), static_cast<const bf16*>(res), c,
               static_cast<float*>(ws), batch, b_batched ? 1 : 0, M, K, N, lda, ldb, act, splits,
               static_cast<cudaStream_t>(stream)};
  int err;
  if (batched) {
    auto launch = [&](auto cfg) {
      return out_f32 ? run_batched<decltype(cfg), float>(g) : run_batched<decltype(cfg), bf16>(g);
    };
    if (kn)
      err = gate ? by_batched_tile<true, INT8_KN>(bm, bn, launch)
                 : by_batched_tile<false, INT8_KN>(bm, bn, launch);
    else
      err = gate ? by_batched_tile<true, DENSE>(bm, bn, launch)
                 : by_batched_tile<false, DENSE>(bm, bn, launch);
  } else {
    err = by_config(bm, bn, gate, !q ? DENSE : kn ? INT8_KN : INT8_NK,
                    [&](auto cfg) { return run<decltype(cfg)>(g); });
  }
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

// Dynamic shared memory a block of that configuration (q: 0 bf16 B, 1 int8
// "nk", 2 int8 "kn") takes (its rings of stages), or -1 if it is not
// instantiated.
extern "C" int gemm_tc_smem_bytes(int bm, int bn, int gate, int q) {
  return by_config(bm, bn, gate, q, [](auto cfg) {
    using C = decltype(cfg);
    if constexpr (C::Q == INT8_KN) return KnLayout<C>::SMEM;
    else return C::SMEM;
  });
}
