// f64 GEMM with a packed int8 B and a fused epilogue on the H100's f64
// tensor cores (DMMA, mma.sync .f64), the int8 dequantized into the f64 B
// tile of the dense kernel.
//
// Replaces, for f64 A against a packed B (`kernels/gemm.py::plan` and
// `::plan_batched` route every such call with K > 0, f64 out, to "dmma"),
// the packed bodies of `repro/kernels/gemm.py` (`_gemm_kernel`,
// pallas_call at :184, int8 body `:63-76`) and `repro/kernels/bgemm.py`
// (`_bgemm_kernel`, pallas_call at :217, int8 body `:80-90`, batched B
// `:180-182`): C[z] = epi(A[z] @ deq(B[z]) [, A[z] @ deq(B2[z])]) with B
// block-scaled int8 (core/quant.py) stored (K, N) ("kn") or (N, K) ("nk",
// its scales along K or not), f32 scales one per (qa, qb) block of the
// stored layout; f64 A, bias, residual and C; the 2-D GEMM is batch 1.
//
// Bound: operations (8192^3: 1.1e12 flops on 0.6 GB; moonshot's decode down
// under f64 A, (64,32,1408) @ (64,1408,2048): 11.8 GFLOP on 0.2 GB).  The
// first design (csrc/gemm.cu, csrc/gemm_batched_f64_q8.cu) runs on DFMA,
// half the f64 tensor cores' 67 TFLOP/s, so it cannot pass half the bound.
//
// Design: csrc/gemm_f64.cu's DMMA warps with B's feed replaced.
//  - The dense kernel's tiles, warp layout, mma shape (m16n8k4), BK = 16
//    and epilogue (gemm_f64.cuh; its f64 epilogue rounds every operation
//    on its own, no FMA contraction, so both kernels round an output the
//    same way): every element of deq(B) is v * s in f64, exact (an int8
//    times an f32 fits 53 bits), so it equals `dequantize_in(B,
//    float64)`'s, and every output is summed in the dense launch's order
//    (the order of one output's DMMAs does not depend on the tile): the
//    packed launch gives the dense launch's bits on the dequantized B
//    (outside the matrix B's tile holds +0, as the dense ring's zero fill
//    does).
//  - Every copy is a 16-byte cp.async: A's rows lda doubles apart (lda
//    even, A on 16 bytes) and the stored int8 rows ldq bytes apart (ldq a
//    multiple of 16, B on 16 bytes).  Where the operands are not laid out
//    so, `kernels/gemm.py` first copies them into rows padded to 16 bytes
//    (`Plan.stage`, `tma_rows`; A's padding zeroed, since a copy that ends
//    past K reads it), so one body takes every shape at the dense plan's
//    tiles (an earlier design compiled a body per copy width, down to one
//    byte a load: the one-byte body ran the BLAS odd case 1.6x slower than
//    gemm.cu, PERF.md).
//  - A converter warpgroup beside the 8 DMMA warps does every copy and the
//    conversion, so the DMMA warps hold only their accumulators and
//    fragments (with the conversion in their own code they spilled at 128
//    x 128 and ran 1.6x the dense launch at 8192^3, PERF.md); `setmaxnreg`
//    gives each its registers (ptxas compiles each warpgroup's code to its
//    count).  It copies A and the int8 rows into a 5-stage ring, and while
//    the DMMA warps multiply stage k it converts stage k + 1's landing tile
//    into the other f64 B buffer ("nk" transposed), every thread meeting at
//    one barrier a k-step.  A converter's two scales a step (where a block
//    is at least 8 values wide; a load a value below that) are loaded a
//    step before the conversion that takes them; each int8 becomes a
//    double exactly by placing it in a double's mantissa (vec.cuh's
//    unpack_i8x4, no I2F).  "kn" landing rows are 16 bytes apart from a
//    row's end, so a quarter-warp's reads of 8 rows meet no bank twice.
#include <string.h>

#include "gemm_f64.cuh"

namespace {

// gemm_f64_q8_kernel's arguments; batch member z = blockIdx.z
struct Q8Args {
  const double* a;
  const int8_t *b, *b2;
  const float *bs, *b2s;
  const double *bias, *res;
  double* c;
  long long sb, ss;  // a member's int8 values and scales (0: one B for every member)
  int M, K, N, act;
  int lda, ldq;  // A's rows (doubles, even) and the stored int8 rows (bytes, a multiple of 16)
  int qa, qb;    // the scale block over the stored layout
  int vec;       // C written 16 bytes at a time (N even, C on 16 bytes)
};

// the stored layout of the int8 B: (K, N) ("kn") or (N, K) ("nk")
enum Q8Layout { Q8_KN = 0, Q8_NK = 1 };

template <class T>
struct Q8Ring {
  static constexpr int STAGES = DEFAULT_STAGES + 1;
  // the dense kernel's 8 DMMA warps (THREADS), then a converter warpgroup
  static constexpr int CONVERTERS = 128, ALL = THREADS + CONVERTERS;
  // one block an SM, and each warpgroup's registers (setmaxnreg; ptxas
  // compiles each warpgroup's code to its count): at BM = 128 the DMMA
  // warps 192 and the converters 120; at BM = 64 128 and 248 (two blocks
  // an SM at BM = 64: PERF.md §7)
  static constexpr int BLOCKS = 1;
  static constexpr int CONSUMER_REGS = T::BM == 64 ? 128 : 192;
  static constexpr int CONVERTER_REGS = T::BM == 64 ? 248 : 120;
  static constexpr int LAUNCH_REGS = 65536 / (ALL * BLOCKS) / 8 * 8;  // each thread's at launch
  static_assert((2 * CONSUMER_REGS + CONVERTER_REGS) * 128 <= 3 * 128 * LAUNCH_REGS,
                "register file");
  static constexpr int Q_BYTES = T::BK * T::BN;    // one int8 tile's values
  static constexpr int EPT = Q_BYTES / CONVERTERS;  // a converter's values of one tile
  // a landing tile: BK rows of BN bytes a 16-byte pad apart ("kn": the
  // converters' 16-byte reads of eight rows meet no bank twice), or BN
  // rows of BK bytes ("nk")
  static constexpr int LAND_TILE = T::BK * (T::BN + 16);
  static constexpr int BUF = T::NB * T::B_ELEMS;    // one converted stage (doubles)
  // A's ring, then two converted stages (doubles), then the landing tiles
  static constexpr int LAND = (STAGES * T::A_ELEMS + 2 * BUF) * 8;
  static constexpr int SMEM = LAND + STAGES * T::NB * LAND_TILE;
  static_assert(EPT == 8 || EPT == 16, "a converter's share of an int8 tile");
};

// one landing row's values: BN columns of a k-row ("kn") or BK k of a
// stored row ("nk"); and its pitch in bytes
template <class T, int LAYOUT>
__host__ __device__ constexpr int land_row() {
  return LAYOUT == Q8_KN ? T::BN : T::BK;
}
template <class T, int LAYOUT>
__host__ __device__ constexpr int land_pitch() {
  return LAYOUT == Q8_KN ? T::BN + 16 : T::BK;
}

// Stage k0's int8 tile(s) into landing slot `land` by 16-byte cp.async
// (`rows` stored rows ldq bytes apart, ldq a multiple of 16), zero-filled
// past the last row and the padded row's end (what a copy brings from the
// padding past the stored row is never converted); converter ct's share
template <class T, int LAYOUT>
__device__ __forceinline__ void copy_q8(uint8_t* land, const int8_t* const (&b)[2], int k0,
                                        int n0, int rows, int ldq, int ct) {
  constexpr int QB = Q8Ring<T>::Q_BYTES, ROW = land_row<T, LAYOUT>();
  constexpr int CHUNKS = T::NB * QB / 16, NT = Q8Ring<T>::CONVERTERS;
  constexpr int LT = Q8Ring<T>::LAND_TILE, PITCH = land_pitch<T, LAYOUT>();
  const int r0 = LAYOUT == Q8_KN ? k0 : n0, c0 = LAYOUT == Q8_KN ? n0 : k0;
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int u = ct + i * NT;
    if (CHUNKS % NT == 0 || u < CHUNKS) {
      const int j = u / (QB / 16), v = u % (QB / 16), r = v / (ROW / 16), c = v % (ROW / 16) * 16;
      const bool live = r0 + r < rows && c0 + c < ldq;
      const int8_t* src = live ? b[j] + (long long)(r0 + r) * ldq + c0 + c : b[j];
      cp_async16(land + j * LT + r * PITCH + c, src, live);
    }
  }
}

// 8 bytes of a landing tile (on 8 bytes), exact as doubles (vec.cuh's
// unpack_i8x4: the byte in a double's mantissa, no I2F)
__device__ __forceinline__ void land_values(const uint8_t* p, double (&v)[8]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  double f[4];
  unpack_i8x4(x.x, f);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = f[e];
  unpack_i8x4(x.y, f);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[4 + e] = f[e];
}

// A converter's share of a stage's conversion (its EPT values of an
// operand): "kn" EPT columns of k-row r (16-byte stores; a quarter-warp's
// lanes on eight rows), "nk" EPT k of stored row r (a column of B's tile:
// lanes on consecutive n).  Its stored
// row (k0 + r, or n0 + r) and the index that runs along its values (n, or
// k), the first value's, and where their scale index steps: at most once
// across the EPT values where the block is at least EPT wide.
template <class T, int LAYOUT>
struct Q8Unit {
  static constexpr int EPT = Q8Ring<T>::EPT;
  int r, h, first, end, q0, cross;
  bool rows_in;
  long long srow;
  __device__ __forceinline__ Q8Unit(const Q8Args& p, int k0, int n0, int ct) {
    const int K = p.K, N = p.N;
    r = LAYOUT == Q8_KN ? ct % T::BK : ct % T::BN;
    h = LAYOUT == Q8_KN ? ct / T::BK : ct / T::BN;
    const int n = LAYOUT == Q8_KN ? n0 + h * EPT : n0 + r;
    const int kb = LAYOUT == Q8_KN ? k0 + r : k0 + h * EPT;
    rows_in = LAYOUT == Q8_KN ? kb < K : n < N;
    first = LAYOUT == Q8_KN ? n : kb;
    end = LAYOUT == Q8_KN ? N : K;
    srow = rows_in ? (long long)((LAYOUT == Q8_KN ? kb : n) / p.qa) * (end / p.qb) : 0;
    q0 = first / p.qb;
    cross = p.qb - first % p.qb;
  }
};

// The (at most two) scales of a converter's values of each operand at stage
// k0, loaded a stage before they are used: s0 before the step, s1 from it
template <class T, int LAYOUT>
__device__ __forceinline__ void load_scales(float (&s)[2][2], const float* const (&sc)[2],
                                            const Q8Args& p, int k0, int n0, int ct) {
  const Q8Unit<T, LAYOUT> u(p, k0, n0, ct);
#pragma unroll
  for (int j = 0; j < T::NB; ++j) {
    const float* srp = sc[j] + u.srow;
    s[j][0] = u.rows_in && u.first < u.end ? __ldg(srp + u.q0) : 0.f;
    s[j][1] = u.rows_in && u.cross < u.EPT && u.first + u.cross < u.end ? __ldg(srp + u.q0 + 1)
                                                                        : s[j][0];
  }
}

// Converter ct's share of converting landing slot `land` (stage k0) into
// the f64 B tile(s) at Bs, 8 values at a time: v * s in f64 (exact), +0
// outside the matrix (what the landing tile holds past the last column or
// row is never used); s the scales load_scales brought (a block narrower
// than EPT: a load a value).
template <class T, int LAYOUT>
__device__ __forceinline__ void convert_q8(const uint8_t* __restrict__ land, double* __restrict__ Bs,
                                           const float (&s)[2][2], const float* const (&sc)[2],
                                           const Q8Args& p, int k0, int n0, int ct) {
  constexpr int EPT = Q8Ring<T>::EPT, LT = Q8Ring<T>::LAND_TILE;
  const Q8Unit<T, LAYOUT> u(p, k0, n0, ct);
#pragma unroll
  for (int j = 0; j < T::NB; ++j) {
    const double s0 = s[j][0], s1 = s[j][1];
    double* dst = Bs + j * T::B_ELEMS;
#pragma unroll
    for (int c = 0; c < EPT; c += 8) {
      double v[8];
      land_values(land + j * LT + u.r * land_pitch<T, LAYOUT>() + u.h * EPT + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = u.rows_in && u.first + c + e < u.end;
        double se = c + e >= u.cross ? s1 : s0;
        if (p.qb < EPT && in) se = __ldg(sc[j] + u.srow + (u.first + c + e) / p.qb);
        v[e] = in ? v[e] * se : 0.0;
      }
      if constexpr (LAYOUT == Q8_KN) {
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          *reinterpret_cast<double2*>(dst + u.r * T::LDB + u.h * EPT + c + e) =
              make_double2(v[e], v[e + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[(u.h * EPT + c + e) * T::LDB + u.r] = v[e];
      }
    }
  }
}

// This warpgroup's registers from the launch's FROM to REGS (setmaxnreg:
// .dec gives registers back, .inc takes them)
template <int REGS, int FROM>
__device__ __forceinline__ void warpgroup_registers() {
  if constexpr (REGS < FROM)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
  else if constexpr (REGS > FROM)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
}

// One C tile of batch member blockIdx.z.  The converter warpgroup copies A
// and the int8 rows (16-byte cp.async) into a STAGES-deep ring and converts
// stage k + 1's int8 into the other f64 B buffer while the 8 DMMA warps
// multiply stage k (gemm_f64.cuh's products, warp layout and epilogue: the
// dense kernel's), every thread meeting at one barrier a k-step.
template <class T, int LAYOUT>
__global__ void __launch_bounds__(Q8Ring<T>::ALL, Q8Ring<T>::BLOCKS)
gemm_f64_q8_kernel(const __grid_constant__ Q8Args p) {
  using R = Q8Ring<T>;
  constexpr int STAGES = R::STAGES, BK = T::BK, A_ELEMS = T::A_ELEMS, NT = R::CONVERTERS;
  extern __shared__ __align__(16) double smem[];
  double* const bbuf = smem + STAGES * A_ELEMS;  // the two converted stages
  uint8_t* const land0 = reinterpret_cast<uint8_t*>(smem) + R::LAND;
  auto land = [&](int s) { return land0 + s * T::NB * R::LAND_TILE; };
  const int M = p.M, K = p.K, N = p.N;
  int m0, n0;
  tile_origin<T>(blockIdx.x, M, N, m0, n0);
  const int tid = threadIdx.x;
  const long long z = blockIdx.z, mn = (long long)M * N;
  const int KT = (K + BK - 1) / BK;

  if (tid >= THREADS) {
    // ---- the converter warpgroup: copies, conversion ----
    warpgroup_registers<R::CONVERTER_REGS, R::LAUNCH_REGS>();
    const int ct = tid - THREADS;
    // member z's operands (64-bit offsets)
    const double* a = p.a + z * M * p.lda;
    const int8_t* const b[2] = {p.b + z * p.sb, T::GATE ? p.b2 + z * p.sb : p.b};
    const float* const sc[2] = {p.bs + z * p.ss, T::GATE ? p.b2s + z * p.ss : p.bs};
    // A's and the int8 rows' copies of stage k0 into slot s (A's columns up
    // to lda: its padding is zero)
    auto copy = [&](int s, int k0) {
      copy_a_tile<T, 2, NT>(smem + s * A_ELEMS, a, m0, k0, M, p.lda, ct);
      copy_q8<T, LAYOUT>(land(s), b, k0, n0, LAYOUT == Q8_KN ? K : N, p.ldq, ct);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) copy(s, s * BK);
      cp_async_commit();
    }
    float sv[2][2], sv_next[2][2] = {};  // stage kt + 1's scales, and stage kt + 2's in flight
    load_scales<T, LAYOUT>(sv, sc, p, 0, n0, ct);
    cp_async_wait<STAGES - 2>();                              // stage 0 landed ...
    asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");   // ... for every converter
    convert_q8<T, LAYOUT>(land(0), bbuf, sv, sc, p, 0, n0, ct);
    if (KT > 1) load_scales<T, LAYOUT>(sv, sc, p, BK, n0, ct);
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 3>();  // stage kt + 1's copies have landed ...
      __syncthreads();  // ... for every thread; stage kt converted, slot kt - 1 and the other buffer free
      const int next = kt + STAGES - 1;
      if (next < KT) copy(next % STAGES, next * BK);
      cp_async_commit();
      if (kt + 2 < KT) load_scales<T, LAYOUT>(sv_next, sc, p, (kt + 2) * BK, n0, ct);
      if (kt + 1 < KT)
        convert_q8<T, LAYOUT>(land((kt + 1) % STAGES), bbuf + ((kt + 1) & 1) * R::BUF, sv, sc,
                              p, (kt + 1) * BK, n0, ct);
#pragma unroll
      for (int j = 0; j < T::NB; ++j) {
        sv[j][0] = sv_next[j][0];
        sv[j][1] = sv_next[j][1];
      }
    }
    cp_async_wait<0>();  // only empty groups remain; drained before exit
    return;
  }

  // ---- the DMMA warps: the dense kernel's products and epilogue ----
  warpgroup_registers<R::CONSUMER_REGS, R::LAUNCH_REGS>();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * T::WM, wn = (warp % WARPS_N) * T::WN;
  typename T::Acc acc;
  typename T::Acc2 acc2;
  zero<T>(acc, acc2);
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // stage kt's A landed and its B converted
    multiply_stage<T>(smem + (kt % STAGES) * A_ELEMS, bbuf + (kt & 1) * R::BUF, acc, acc2, wm,
                      wn, g, t);
  }
  double* c = p.c + z * mn;
  const double* res = p.res ? p.res + z * mn : nullptr;
  if (p.vec)
    store_tile<T, 2>(acc, acc2, p.bias, res, c, m0 + wm + g, n0 + wn + 2 * t, M, N, p.act);
  else
    store_tile<T, 1>(acc, acc2, p.bias, res, c, m0 + wm + g, n0 + wn + 2 * t, M, N, p.act);
}

template <class T, int LAYOUT>
int run_q8(const Q8Args& g, int batch, cudaStream_t s) {
  using R = Q8Ring<T>;
  auto kernel = gemm_f64_q8_kernel<T, LAYOUT>;
  static bool sized = false;  // the opt-in above 48 KB, once per instantiation
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long long tiles = (long long)((g.M + T::BM - 1) / T::BM) * ((g.N + T::BN - 1) / T::BN);
  kernel<<<dim3((unsigned)tiles, 1, (unsigned)batch), R::ALL, R::SMEM, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// the launch at tile (bm, bn): 128 x 128 or 64 x 64, the dense plan's, and
// with the gate 64 x 64 (at 128 x 64 ptxas spilled 12 bytes in the "kn"
// form at every register split tried, PERF.md); -1 for a tile not
// instantiated
int run_tile(const Q8Args& g, int batch, cudaStream_t s, int bm, int bn, bool gate, bool nk) {
#define F64_Q8_RUN(BM, BN, GATE)                                                              \
  if (bm == BM && bn == BN && gate == GATE) {                                                 \
    using T = Tile<BM, BN, DEFAULT_BK, DEFAULT_MI, DEFAULT_KI, GATE>;                         \
    return nk ? run_q8<T, Q8_NK>(g, batch, s) : run_q8<T, Q8_KN>(g, batch, s);                \
  }
  F64_Q8_RUN(64, 64, true)
  F64_Q8_RUN(128, 128, false)
  F64_Q8_RUN(64, 64, false)
#undef F64_Q8_RUN
  return -1;
}

bool on(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// C[z] (M, N) = epi(A[z] (M, K) @ deq(B[z]) [, A[z] @ deq(B2[z])]) in f64
// for z < batch, one launch: A (batch, M, K) in rows lda doubles apart (lda
// even and at least K, A on 16 bytes, its columns K..lda zero), C and res
// (batch, M, N) contiguous f64; B, B2 int8 stored (K, N) (nk = 0) or (N, K)
// (nk = 1) in rows ldq bytes apart (ldq a multiple of 16 and at least the
// stored row, b and b2 on 16 bytes), one a member (b_batched) or one for
// every member, with f32 scales (stored rows / qa, stored cols / qb) a
// member; the 2-D GEMM is batch 1.  b2/b2s, bias and res may be NULL.
// (bm, bn): 128 x 128 or 64 x 64 (the gate: 64 x 64), as
// `kernels/gemm.py::plan` names them.  Returns cudaErrorInvalidValue for what the
// kernel does not take, else cudaGetLastError() after the launch.
extern "C" int gemm_f64_q8_launch(const void* a, const void* b, const void* bs, const void* b2,
                                  const void* b2s, int qa, int qb, int nk, const void* bias,
                                  const void* res, void* c, int batch, int b_batched, int M,
                                  int K, int N, int lda, int ldq, int act, int bm, int bn,
                                  void* stream) {
  const int rows = nk ? N : K, cols = nk ? K : N;
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || qa < 1 || qb < 1 ||
      rows % qa || cols % qb || lda < K || lda % 2 || ldq < cols || ldq % 16 || !on(a, 16) ||
      !on(b, 16) || !on(b2, 16) || !on(bias, 8) || !on(res, 8) || !on(c, 8) || (b2 && !b2s))
    return static_cast<int>(cudaErrorInvalidValue);
  Q8Args g;
  memset(&g, 0, sizeof(g));
  g.a = static_cast<const double*>(a);
  g.b = static_cast<const int8_t*>(b);
  g.b2 = static_cast<const int8_t*>(b2);
  g.bs = static_cast<const float*>(bs);
  g.b2s = static_cast<const float*>(b2s);
  g.bias = static_cast<const double*>(bias);
  g.res = static_cast<const double*>(res);
  g.c = static_cast<double*>(c);
  g.sb = b_batched ? (long long)rows * ldq : 0;
  g.ss = b_batched ? (long long)(rows / qa) * (cols / qb) : 0;
  g.M = M;
  g.K = K;
  g.N = N;
  g.act = act;
  g.lda = lda;
  g.ldq = ldq;
  g.qa = qa;
  g.qb = qb;
  g.vec = N % 2 == 0 && on(c, 16);
  const int err = run_tile(g, batch, static_cast<cudaStream_t>(stream), bm, bn, b2 != nullptr,
                           nk != 0);
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}
