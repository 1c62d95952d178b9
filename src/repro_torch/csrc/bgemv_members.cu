// Batched GEMV over short members, both ops, with a fused epilogue, one
// launch a call, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/bgemv.py` (`_bgemv_kernel`,
// pallas_call at :230) in its per-member forms (one A a member, :144) where
// a member is short (kernels/bgemv.py::plan: at most MEMBER_MAX_BYTES of A a
// member; longer members run csrc/bgemv.cu and csrc/bgemv_rows.cu):
//
//     op = A^T (TRANS): y[b, j] = epi( sum_i x[b, i] A[b, i, j]  [, ... A2] ),  A (B, K, N)
//     op = A:           y[b, i] = epi( sum_j A[b, i, j] x[b, j]  [, ... A2] ),  A (B, M, N)
//
// with x (B, K | N), bias, residual (B, N | M); f32, bf16 and f64, summed in
// max(f32, dtype).  Below, a member's op(A) is R stored rows of N elements
// (R = K under op = A^T, M under op = A).
//
// Bound: bytes.  No member shares an A element, so every A byte is read
// once for 2 FLOPs: (4096, 32, 32) in f64 is 33.5 MB, 10.0 us at 3.35 TB/s.
//
// What held the first design back (a block of 8 warps a member in both
// bodies, PERF.md §6): at (32, 32) f64 a column body block issued one
// 16-byte load a lane around an x staging, two __syncthreads and an 8-warp
// reduction; a row body block left half of each warp idle on 256-byte rows;
// thousands of such blocks each waited out one DRAM round trip.
//
// Design against the bound:
//  - a warp owns whole members, one after another (`members` a block, 8 or
//    more, from the plan); no member is split, and nothing is staged in
//    shared memory: no block-wide barrier anywhere;
//  - its lanes walk the member as one flat stream of chunks of C elements
//    (16 bytes where a row is whole 16-byte chunks, else one element): a
//    row is G = N / C chunks, and a warp step (a unit) takes P = 32 / W rows
//    of W = min(G, 32) chunks, so one warp load covers P * W contiguous
//    chunks (512 bytes at 16-byte chunks where the row's bytes divide 512);
//    rows longer than 32 chunks take ceil(G / 32) windows of 32.  A base
//    off 16 bytes gathers the same chunks with element loads (the same sums,
//    slower);
//  - a unit's address is the lane's base plus the unit times a fixed stride,
//    and a lane keeps two batches of U units in flight, refilling each as
//    soon as it is used (`pipeline`): (32, 32) f64 is 16 units a lane;
//  - op = A^T: a lane keeps C column sums over the rows it visits, window
//    by window; the P lanes of a column meet by a fixed shuffle tree
//    (stride W) and the first writes C outputs.  x[row] is a scalar load
//    the lanes of a row share, riding with the unit;
//  - op = A over rows of at most 32 chunks: a lane takes J = 4 chunks of a
//    row a unit (2 under the gate), chunks g + Wj j of Wj = ceil(G / J)
//    lanes a row, so one tree of log2(Wj) shuffle levels meets a row's
//    lanes for every J loads (a 32-chunk row's tree has 5 levels a load,
//    (32, 32) bf16 rows none: a lane owns a row); x at the lane's J chunks
//    is loaded once a member.  Rows of more than 32 chunks (WIDE) take
//    windows of 32 chunks, a lane's sum carried across the row's windows and
//    the rows a batch finishes meeting a tree level at a time;
//  - the epilogue is applied in the accumulator type before the one write.
// A member's sums run in an order set by its shape, the op, the dtype and
// the gate alone, never by B, by where the member sits in the launch or in
// memory: a member's bits are the same alone and in any batch.  No atomics:
// two launches on the same inputs give the same bits.
#include <type_traits>

#include "vec.cuh"

using namespace rt;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_MEMBERS = 256;  // members a block at most (kernels/bgemv.py MEMBERS)

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// C elements of T a lane takes a unit: 16 bytes (VEC; one load where the
// base is on 16 bytes, else C element loads), or one element
template <typename T, bool VEC>
struct Chunk {
  using A = typename Acc<T>::type;
  using Raw = std::conditional_t<VEC, uint4, T>;
  static constexpr int C = VEC ? Vec<T>::N : 1;
  __device__ __forceinline__ static Raw load(const T* p, bool aligned) {
    if constexpr (VEC) {
      if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));
      union {
        uint4 v;
        T e[C];
      } u;
#pragma unroll
      for (int i = 0; i < C; ++i) u.e[i] = p[i];
      return u.v;
    } else {
      return *p;
    }
  }
  __device__ __forceinline__ static void unpack(const Raw& r, A (&f)[C]) {
    if constexpr (VEC) Vec<T>::unpack(r, f);
    else f[0] = to_f(r);
  }
};

// Runs n units through two batches of U in flight, each refilled as soon as
// it is used: fill(t, batch, u) loads unit t (t >= n: zeros) into slot u,
// use(t0, batch) consumes units t0 .. t0 + U - 1 (those below n).
template <int U, typename Batch, typename Fill, typename Use>
__device__ __forceinline__ void pipeline(int n, Fill fill, Use use) {
  Batch ra, rb;
  auto load = [&](int t0, Batch& r) {
#pragma unroll
    for (int u = 0; u < U; ++u) fill(t0 + u, r, u);
  };
  load(0, ra);
  load(U, rb);
  for (int t0 = 0; t0 < n; t0 += 2 * U) {
    use(t0, ra);
    if (t0 + 2 * U < n) load(t0 + 2 * U, ra);
    if (t0 + U >= n) break;
    use(t0 + U, rb);
    if (t0 + 3 * U < n) load(t0 + 3 * U, rb);
  }
}

// Blocks an SM ptxas is held to: without a bound it traded a few spills for
// occupancy in five instantiations; op = A^T without the gate (at most 80
// registers) ran faster at 3 blocks an SM, op = A at 2 (PERF.md)
template <bool GATE, bool TRANS>
constexpr int MIN_BLOCKS = TRANS && !GATE ? 3 : 2;

// WIDE (op = A only): rows of more than 32 chunks, walked window by window
template <typename T, bool GATE, bool TRANS, bool VEC, bool WIDE>
__global__ void __launch_bounds__(THREADS, (MIN_BLOCKS<GATE, TRANS>))
bgemv_members_kernel(const T* __restrict__ a, const T* __restrict__ a2,
                     const T* __restrict__ x, const T* __restrict__ bias,
                     const T* __restrict__ res, T* __restrict__ y, int B, int R, int N,
                     int members, int act, bool aligned) {
  using A = typename Acc<T>::type;
  using L = Chunk<T, VEC>;
  using XL = Chunk<T, VEC && !TRANS>;  // x[row] (op = A^T) or x at the chunk's columns
  constexpr int C = L::C, XC = XL::C;
  constexpr int NACC = GATE ? 2 : 1;
  constexpr int U = GATE ? 2 : 4;     // units a batch; two batches in flight
  constexpr int J = GATE ? 2 : 4;  // op = A rows of at most 32 chunks: chunks a lane a unit
  constexpr unsigned FULL = 0xffffffffu;
  struct Batch {  // op = A^T, and op = A over WIDE rows: U units of a chunk
    typename L::Raw a[NACC][U];
    typename XL::Raw x[U];
  };
  struct BatchJ {  // op = A over rows of at most 32 chunks: a unit of J chunks
    typename L::Raw a[NACC][J];
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = VEC ? N / C : N;  // chunks a row (VEC: N % C == 0)
  const int W = max(1, min(G, 32)), P = 32 / W;
  const int windows = (G + W - 1) / W, steps = (R + P - 1) / P;
  const int p = lane / W, g = lane - p * W;  // this lane's row in a step, chunk in a window
  const bool active = p < P;
  const int outs = TRANS ? N : R;

  // the lanes of a finished sum meet by a fixed tree: op = A^T the P row
  // lanes of a chunk (W apart), op = A the W chunk lanes of a row
  auto tree = [&](A& v, int d) {
    if constexpr (TRANS) {
      const A t = __shfl_down_sync(FULL, v, d * W);
      if ((p & (2 * d - 1)) == 0 && p + d < P) v += t;
    } else {
      const A t = __shfl_down_sync(FULL, v, d);
      if ((g & (2 * d - 1)) == 0 && g + d < W) v += t;
    }
  };

  for (int i = 0; i < members / WARPS; ++i) {
    const long b = (long)blockIdx.x * members + (long)i * WARPS + warp;
    if (b >= B) break;
    const long ob = b * outs;  // this member's outputs
    if (G == 0 || R == 0) {  // no element to sum (K = 0): the epilogue of 0
      for (int o = lane; o < outs; o += 32)
        y[ob + o] = from_f<T>(epilogue<T>(A(0), A(0), bias, res, o, ob + o, act, GATE));
      continue;
    }
    const T* am[NACC] = {a + b * R * N};
    if constexpr (GATE) am[1] = a2 + b * R * N;
    const T* xb = x + b * (TRANS ? R : N);

    if constexpr (TRANS) {
      // window by window: unit t is rows p + t P, the lane's C columns
      for (int w = 0; w < windows; ++w) {
        const int grp = w * W + g;
        const bool on = active && grp < G;
        const long base = (long)p * N + (long)grp * C, stride = (long)P * N;
        A acc[NACC][C];
#pragma unroll
        for (int k = 0; k < NACC; ++k)
#pragma unroll
          for (int e = 0; e < C; ++e) acc[k][e] = A(0);
        pipeline<U, Batch>(
            steps,
            [&](int t, Batch& r, int u) {
              const bool live = on && t < steps && p + t * P < R;
#pragma unroll
              for (int k = 0; k < NACC; ++k)
                r.a[k][u] = live ? L::load(am[k] + base + t * stride, aligned) : typename L::Raw{};
              r.x[u] = live ? XL::load(xb + p + t * P, aligned) : typename XL::Raw{};
            },
            [&](int t0, const Batch& r) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                if (t0 + u < steps) {
                  A xv[XC];
                  XL::unpack(r.x[u], xv);
#pragma unroll
                  for (int k = 0; k < NACC; ++k) {
                    A f[C];
                    L::unpack(r.a[k][u], f);
#pragma unroll
                    for (int e = 0; e < C; ++e) acc[k][e] = fma_(f[e], xv[0], acc[k][e]);
                  }
                }
              }
            });
#pragma unroll
        for (int k = 0; k < NACC; ++k)
#pragma unroll
          for (int e = 0; e < C; ++e)
            for (int d = 1; d < P; d <<= 1) tree(acc[k][e], d);
        if (p == 0 && grp < G) {
#pragma unroll
          for (int e = 0; e < C; ++e) {
            const int col = grp * C + e;
            y[ob + col] = from_f<T>(epilogue<T>(acc[0][e], acc[NACC - 1][e], bias, res, col,
                                                ob + col, act, GATE));
          }
        }
      }
    } else if constexpr (!WIDE) {
      // rows of at most 32 chunks: a lane takes J of a row's chunks a unit
      // (chunks g + Wj j of rows p + t Pj), so its row's sum covers J
      // chunks before the Wj lanes of the row meet by a tree of log2(Wj)
      // levels; x at the lane's J chunks is loaded once a member
      const int Wj = (G + J - 1) / J, Pj = 32 / Wj, rows_step = (R + Pj - 1) / Pj;
      const int pj = lane / Wj, gj = lane - pj * Wj;
      typename XL::Raw xr[J];
#pragma unroll
      for (int c = 0; c < J; ++c)
        xr[c] = pj < Pj && gj + Wj * c < G ? XL::load(xb + (gj + Wj * c) * C, aligned)
                                           : typename XL::Raw{};
      pipeline<1, BatchJ>(
          rows_step,
          [&](int t, BatchJ& r, int) {
            const int row = pj + t * Pj;
            const bool live = pj < Pj && t < rows_step && row < R;
#pragma unroll
            for (int c = 0; c < J; ++c) {
              const bool on = live && gj + Wj * c < G;
              const long off = (long)row * N + (long)(gj + Wj * c) * C;
#pragma unroll
              for (int k = 0; k < NACC; ++k)
                r.a[k][c] = on ? L::load(am[k] + off, aligned) : typename L::Raw{};
            }
          },
          [&](int t, const BatchJ& r) {
            A v[NACC];
#pragma unroll
            for (int k = 0; k < NACC; ++k) {
              v[k] = A(0);
#pragma unroll
              for (int c = 0; c < J; ++c) {
                A f[C], xv[C];
                L::unpack(r.a[k][c], f);
                XL::unpack(xr[c], xv);
#pragma unroll
                for (int e = 0; e < C; ++e) v[k] = fma_(f[e], xv[e], v[k]);
              }
              for (int d = 1; d < Wj; d <<= 1) {
                const A o = __shfl_down_sync(FULL, v[k], d);
                if ((gj & (2 * d - 1)) == 0 && gj + d < Wj) v[k] += o;
              }
            }
            const int row = pj + t * Pj;
            if (gj == 0 && pj < Pj && row < R)
              y[ob + row] = from_f<T>(epilogue<T>(v[0], v[NACC - 1], bias, res, row, ob + row,
                                                  act, GATE));
          });
    } else {
      // rows of more than 32 chunks: unit t is row t / windows at window
      // t % windows; a lane's sum is carried across the row's windows, and
      // the rows a batch finishes meet a tree level at a time
      const int n = steps * windows;
      A acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = A(0);
      pipeline<U, Batch>(
          n,
          [&](int t, Batch& r, int u) {
            const int row = t / windows, grp = (t - row * windows) * W + g;
            const bool live = t < n && row < R && grp < G;
            const long off = (long)row * N + (long)grp * C;
#pragma unroll
            for (int k = 0; k < NACC; ++k)
              r.a[k][u] = live ? L::load(am[k] + off, aligned) : typename L::Raw{};
            r.x[u] = live ? XL::load(xb + grp * C, aligned) : typename XL::Raw{};
          },
          [&](int t0, const Batch& r) {
            A part[NACC][U];
            unsigned ends = 0;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (t0 + u < n) {
                A xv[XC];
                XL::unpack(r.x[u], xv);
#pragma unroll
                for (int k = 0; k < NACC; ++k) {
                  A f[C];
                  L::unpack(r.a[k][u], f);
#pragma unroll
                  for (int e = 0; e < C; ++e) acc[k] = fma_(f[e], xv[e], acc[k]);
                }
                if ((t0 + u) % windows == windows - 1) {
#pragma unroll
                  for (int k = 0; k < NACC; ++k) part[k][u] = acc[k], acc[k] = A(0);
                  ends |= 1u << u;
                }
              }
            }
            for (int d = 1; d < W; d <<= 1) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                if (ends >> u & 1) {
#pragma unroll
                  for (int k = 0; k < NACC; ++k) tree(part[k][u], d);
                }
              }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int row = (t0 + u) / windows;
              if ((ends >> u & 1) && g == 0 && row < R)
                y[ob + row] = from_f<T>(epilogue<T>(part[0][u], part[NACC - 1][u], bias, res,
                                                    row, ob + row, act, GATE));
            }
          });
    }
  }
}

template <typename T, bool GATE, bool TRANS, bool VEC, bool WIDE>
int run(const T* a, const T* a2, const T* x, const T* bias, const T* res, T* y, int B, int R,
        int N, int members, int act, bool aligned, cudaStream_t s) {
  const long blocks = ((long)B + members - 1) / members;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  bgemv_members_kernel<T, GATE, TRANS, VEC, WIDE>
      <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(a, a2, x, bias, res, y, B, R, N, members,
                                                          act, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* av, const void* a2v, const void* xv, const void* bias, const void* res,
             void* y, int B, int R, int N, bool trans, int members, int act, cudaStream_t s) {
  const T* a = static_cast<const T*>(av);
  const T* a2 = static_cast<const T*>(a2v);
  const T* x = static_cast<const T*>(xv);
  // the chunks from the shape alone; the loads from where the operands sit
  const bool vec = ((long)N * sizeof(T)) % 16 == 0;
  const bool aligned = aligned16(a) && aligned16(a2) && (trans || aligned16(x));
  const bool wide = !trans && (vec ? N / Vec<T>::N : N) > 32;  // op = A rows of windows
#define GO(GATE, TRANS, VEC, WIDE)                                                         \
  run<T, GATE, TRANS, VEC, WIDE>(a, a2, x, static_cast<const T*>(bias),                  \
                                 static_cast<const T*>(res), static_cast<T*>(y), B, R, N, \
                                 members, act, aligned, s)
#define BY_WIDE(GATE, VEC) (wide ? GO(GATE, false, VEC, true) : GO(GATE, false, VEC, false))
#define BY_OP(GATE, VEC) (trans ? GO(GATE, true, VEC, false) : BY_WIDE(GATE, VEC))
#define BY_VEC(GATE) (vec ? BY_OP(GATE, true) : BY_OP(GATE, false))
  return a2 ? BY_VEC(true) : BY_VEC(false);
#undef BY_VEC
#undef BY_OP
#undef BY_WIDE
#undef GO
}

}  // namespace

// One launch over B members of R stored rows of N elements each: op = A^T
// (trans; A (B, K = R, N), y (B, N)) or op = A (A (B, M = R, N), y (B, M)).
// a2, bias and res may be NULL.  `batched` must be set (a 2-D A broadcast
// across the batch is csrc/bgemv.cu's and csrc/bgemv_rows.cu's).  `members`
// a block: a multiple of 8 (one warp a member at a time), at most 256.
// Returns cudaErrorInvalidValue for what the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int bgemv_members_launch(int dtype, const void* a, const void* a2, const void* x,
                                    const void* bias, const void* res, void* y, int B, int R,
                                    int N, int batched, int trans, int members, int act,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!batched || B < 1 || R < 0 || N < 0 || members < WARPS || members > MAX_MEMBERS ||
      members % WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
#define GO(T) dispatch<T>(a, a2, x, bias, res, y, B, R, N, trans != 0, members, act, s)
  if (dtype == DT_F32) return GO(float);
  if (dtype == DT_BF16) return GO(__nv_bfloat16);
  if (dtype == DT_F64) return GO(double);
#undef GO
  return static_cast<int>(cudaErrorInvalidValue);
}
