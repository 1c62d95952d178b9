// Shared device helpers for the port's kernels: storage-type <-> accumulator
// conversion and the fused epilogue (core/epilogue.py), applied in
// accumulator precision in the order bias -> activation -> gate -> residual.
// The accumulator is float for f32 and bf16 operands and double for f64
// (max(f32, dtype), as the reference accumulates).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rt {

enum { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };
enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

// Finite "minus infinity" for masked scores: exp(NEG_INF - m) is 0 for any
// real m, and a row whose every score is masked never produces inf - inf.
constexpr float NEG_INF = -1e30f;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

// storage -> accumulator: bf16 -> f32 is exact
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_f(double v) { return v; }

// accumulator -> storage, rounded once (to nearest even, as torch's cast)
template <typename T, typename A> __device__ __forceinline__ T from_f(A v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float exp_(float z) { return expf(z); }
__device__ __forceinline__ double exp_(double z) { return exp(z); }
__device__ __forceinline__ float tanh_(float z) { return tanhf(z); }
__device__ __forceinline__ double tanh_(double z) { return tanh(z); }

template <typename A>
__device__ __forceinline__ A activate(A z, int act) {
  switch (act) {
    case ACT_SILU:
      return z / (A(1) + exp_(-z));
    case ACT_GELU: {
      const A c = A(0.7978845608028654);  // sqrt(2 / pi): the tanh form
      return A(0.5) * z * (A(1) + tanh_(c * (z + A(0.044715) * z * z * z)));
    }
    case ACT_RELU:
      return z > A(0) ? z : A(0);
    default:
      return z;
  }
}

// h = act(acc + bias[col]) [* acc2] [+ res[res_idx]], all in A.
template <typename T, typename A>
__device__ __forceinline__ A epilogue(A acc, A acc2, const T* bias, const T* res,
                                      int col, long res_idx, int act, bool gate) {
  A h = acc;
  if (bias) h += to_f(bias[col]);
  h = activate(h, act);
  if (gate) h *= acc2;
  if (res) h += to_f(res[res_idx]);
  return h;
}

}  // namespace rt
