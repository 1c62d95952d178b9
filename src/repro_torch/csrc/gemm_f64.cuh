// The f64 tensor-core GEMM (DMMA, mma.sync .f64): the parts its sources
// share.  csrc/gemm_f64.cu feeds a dense B through its cp.async ring and
// holds the design notes; csrc/gemm_f64_q8.cu feeds a packed int8 B,
// dequantized into the same padded f64 B tile.  Here: the mma shapes, the
// warp layout, the grouped raster, one stage's products and the epilogue,
// so that both kernels multiply and round every output in the same order.
#pragma once

#include "mma.cuh"
#include "vec.cuh"

using namespace rt;

namespace {

constexpr int THREADS = 256, GROUP = 8, PAD = 4;
constexpr int WARPS_M = 2, WARPS_N = 4;

// VEC doubles (16 or 8 bytes) global -> shared; zero-filled (and src not
// read) unless live
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool live) {
  if constexpr (VEC == 2)
    cp_async16(dst, src, live);
  else
    cp_async8(dst, src, live);
}

// One f64 mma.sync shape, MI x 8 x KI, C += A B.  Fragments (PTX ISA, the
// f64 mma shapes; CuTe's mma_traits_sm80/sm90 layouts), g = lane / 4,
// t = lane % 4:  A[i] at (row g + 8 (i % (MI / 8)), col t + 4 (i / (MI / 8))),
// B[i] at (k t + 4 i, col g), C[i] at (row g + 8 (i / 2), col 2 t + i % 2).
template <int MI, int KI> struct Mma;

template <> struct Mma<8, 4> {
  static constexpr int A = 1, B = 1, C = 2;
  __device__ __forceinline__ static void run(double (&c)[C], const double (&a)[A],
                                             const double (&b)[B]) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
                 "{%0, %1};\n"
                 : "+d"(c[0]), "+d"(c[1])
                 : "d"(a[0]), "d"(b[0]));
  }
};

template <> struct Mma<16, 4> {
  static constexpr int A = 2, B = 1, C = 4;
  __device__ __forceinline__ static void run(double (&c)[C], const double (&a)[A],
                                             const double (&b)[B]) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                 "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};

template <> struct Mma<16, 8> {
  static constexpr int A = 4, B = 2, C = 4;
  __device__ __forceinline__ static void run(double (&c)[C], const double (&a)[A],
                                             const double (&b)[B]) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

template <> struct Mma<16, 16> {
  static constexpr int A = 8, B = 4, C = 4;
  __device__ __forceinline__ static void run(double (&c)[C], const double (&a)[A],
                                             const double (&b)[B]) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
                 "{%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                   "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// what the plan's launches take (the sweep's fastest): the mma shape, k per
// stage and the ring's depth
constexpr int DEFAULT_MI = 16, DEFAULT_KI = 4, DEFAULT_BK = 16, DEFAULT_STAGES = 4;

// A block's BM x BN tile of C in f64 registers: 8 warps (2 x 4), each a
// (BM/2) x (BN/4) sub-tile of MI x 8 mma tiles; operand tiles of BK k in
// shared memory, rows padded by PAD doubles (32 bytes), so each half-warp's
// 8-byte fragment loads (A: row g, column t; B: row t, column g) fall on
// 16 distinct 8-byte bank pairs.  A stage's B2 follows its B (B_ELEMS on).
template <int BM_, int BN_, int BK_, int MI_, int KI_, bool GATE_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, MI = MI_, KI = KI_;
  static constexpr bool GATE = GATE_;
  using MMA = Mma<MI, KI>;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / MI, NT = WN / 8, RB = MI / 8;  // RB: 8-row halves of an mma tile
  static constexpr int LDA = BK + PAD, LDB = BN + PAD;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int NB = GATE ? 2 : 1;  // B operands
  static_assert(WM % MI == 0 && WN % 8 == 0 && BK % KI == 0, "tile / mma shape mismatch");
  using Acc = double[MT][NT][MMA::C];
  using Acc2 = double[GATE ? MT : 1][GATE ? NT : 1][MMA::C];
};

// The origin (m0, n0) of tile `tile` in the grouped raster: GROUP tile rows
// sweep the tile columns together, so blocks that run together share their
// A and B panels in L2.
template <class T>
__device__ __forceinline__ void tile_origin(int tile, int M, int N, int& m0, int& n0) {
  const int tiles_m = (M + T::BM - 1) / T::BM, tiles_n = (N + T::BN - 1) / T::BN;
  const int per_group = GROUP * tiles_n;
  const int first = tile / per_group * GROUP;
  const int rows_here = min(tiles_m - first, GROUP);
  const int in_group = tile % per_group;
  m0 = (first + in_group % rows_here) * T::BM;
  n0 = (in_group / rows_here) * T::BN;
}

// A's k-step tile (BM rows of BK k from (m0, k0)) into As by cp.async of VEC
// doubles (VEC = 2: K is even, so a copy is all in or all out of the
// matrix), zero-filled outside it; NT threads share it
template <class T, int VEC, int NT = THREADS>
__device__ __forceinline__ void copy_a_tile(double* As, const double* __restrict__ a, int m0,
                                            int k0, int M, int K, int tid) {
  constexpr int CH = T::BM * T::BK / VEC / NT;  // copies a thread
  static_assert(CH * NT * VEC == T::BM * T::BK, "copy split");
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int e = tid + j * NT, r = e / (T::BK / VEC), ch = e % (T::BK / VEC);
    const int gm = m0 + r, gk = k0 + VEC * ch;
    const bool live = gm < M && gk < K;
    cp_async<VEC>(As + r * T::LDA + VEC * ch, live ? a + (long long)gm * K + gk : a, live);
  }
}

template <class T>
__device__ __forceinline__ void zero(typename T::Acc& acc, typename T::Acc2& acc2) {
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int n = 0; n < T::NT; ++n)
#pragma unroll
      for (int i = 0; i < T::MMA::C; ++i) {
        acc[m][n][i] = 0.0;
        if constexpr (T::GATE) acc2[m][n][i] = 0.0;
      }
}

// acc (acc2) += one stage's products: A's BM x BK tile at As (rows LDA
// apart) times the BK x BN tile of B at Bs (of B2 at Bs + B_ELEMS; rows LDB
// apart), k in steps of KI; warp tile (wm, wn), lane (g, t)
template <class T>
__device__ __forceinline__ void multiply_stage(const double* As, const double* Bs,
                                               typename T::Acc& acc, typename T::Acc2& acc2,
                                               int wm, int wn, int g, int t) {
  using MMA = typename T::MMA;
  As += (wm + g) * T::LDA + t;
  Bs += t * T::LDB + wn + g;
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += T::KI) {
    double bf[T::NT][MMA::B], bf2[T::GATE ? T::NT : 1][MMA::B];
#pragma unroll
    for (int n = 0; n < T::NT; ++n)
#pragma unroll
      for (int i = 0; i < MMA::B; ++i) {
        bf[n][i] = Bs[(kk + 4 * i) * T::LDB + n * 8];
        if constexpr (T::GATE) bf2[n][i] = Bs[T::B_ELEMS + (kk + 4 * i) * T::LDB + n * 8];
      }
#pragma unroll
    for (int m = 0; m < T::MT; ++m) {
      double af[MMA::A];
#pragma unroll
      for (int i = 0; i < MMA::A; ++i)
        af[i] = As[(m * T::MI + 8 * (i % T::RB)) * T::LDA + kk + 4 * (i / T::RB)];
#pragma unroll
      for (int n = 0; n < T::NT; ++n) {
        MMA::run(acc[m][n], af, bf[n]);
        if constexpr (T::GATE) MMA::run(acc2[m][n], af, bf2[n]);
      }
    }
  }
}

// common.cuh's epilogue (bias -> activation -> gate -> residual) in f64,
// every operation rounded on its own (__dadd_rn and kin: no FMA
// contraction, which the compiler decides instantiation by instantiation),
// so every f64 GEMM kernel rounds an output the same way
__device__ __forceinline__ double epilogue_rn(double acc, double acc2,
                                              const double* __restrict__ bias,
                                              const double* __restrict__ res, int col,
                                              long long res_idx, int act, bool gate) {
  double h = acc;
  if (bias) h = __dadd_rn(h, bias[col]);
  if (act == ACT_SILU) {
    h = __ddiv_rn(h, __dadd_rn(1.0, exp(-h)));
  } else if (act == ACT_GELU) {  // the tanh form, as common.cuh's activate
    const double u = __dmul_rn(__dmul_rn(__dmul_rn(0.044715, h), h), h);
    const double t = tanh(__dmul_rn(0.7978845608028654, __dadd_rn(h, u)));
    h = __dmul_rn(__dmul_rn(0.5, h), __dadd_rn(1.0, t));
  } else if (act == ACT_RELU) {
    h = h > 0.0 ? h : 0.0;
  }
  if (gate) h = __dmul_rn(h, acc2);
  if (res) h = __dadd_rn(h, res[res_idx]);
  return h;
}

// The epilogue from the registers: C[i] and C[i + 1] are two adjacent
// columns (VEC = 2: col and N are even, both in range together, one 16-byte
// store on a C that starts on 16 bytes; VEC = 1: each checked and stored
// alone, and a column at N neither computed nor read: bias[N] and the
// residual's next element lie outside their operands)
template <class T, int VEC>
__device__ __forceinline__ void store_tile(const typename T::Acc& acc,
                                           const typename T::Acc2& acc2,
                                           const double* __restrict__ bias,
                                           const double* __restrict__ res, double* __restrict__ c,
                                           int row0, int col0, int M, int N, int act) {
#pragma unroll
  for (int m = 0; m < T::MT; ++m)
#pragma unroll
    for (int h = 0; h < T::RB; ++h) {
      const int row = row0 + m * T::MI + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int n = 0; n < T::NT; ++n) {
        const int col = col0 + n * 8;
        if (col >= N) continue;
        const long long o = (long long)row * N + col;
        double v[2] = {0.0, 0.0};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (VEC == 1 && col + j >= N) continue;
          double gv = 0.0;
          if constexpr (T::GATE) gv = acc2[m][n][2 * h + j];
          v[j] = epilogue_rn(acc[m][n][2 * h + j], gv, bias, res, col + j, o + j, act, T::GATE);
        }
        if constexpr (VEC == 2) {
          *reinterpret_cast<double2*>(c + o) = make_double2(v[0], v[1]);
        } else {
          c[o] = v[0];
          if (col + 1 < N) c[o + 1] = v[1];
        }
      }
    }
}

}  // namespace
