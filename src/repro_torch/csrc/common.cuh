// Shared device helpers for the port's kernels: f32 <-> storage-type
// conversion and the fused epilogue (core/epilogue.py), applied in f32 in the
// order bias -> activation -> gate -> residual.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rt {

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2, ACT_RELU = 3 };

// Finite "minus infinity" for masked scores: exp(NEG_INF - m) is 0 for any
// real m, and a row whose every score is masked never produces inf - inf.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case ACT_SILU:
      return z / (1.0f + expf(-z));
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi): the tanh form
      return 0.5f * z * (1.0f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    case ACT_RELU:
      return fmaxf(z, 0.0f);
    default:
      return z;
  }
}

// h = act(acc + bias[col]) [* acc2] [+ res[res_idx]], all in f32.
template <typename T>
__device__ __forceinline__ float epilogue(float acc, float acc2, const T* bias,
                                          const T* res, int col, long res_idx,
                                          int act, bool gate) {
  float h = acc;
  if (bias) h += to_f(bias[col]);
  h = activate(h, act);
  if (gate) h *= acc2;
  if (res) h += to_f(res[res_idx]);
  return h;
}

}  // namespace rt
