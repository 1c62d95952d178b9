// 16-byte vector loads and stores for the streaming kernels (bgemv.cu,
// blas1.cu, gemv.cu, qgemv.cu, attention_splitkv.cu): N elements of T in
// one transaction, unpacked to the accumulator type (bf16 -> f32 is exact:
// the high half of a word; int8 through unpack_i8).  The caller checks
// 16-byte alignment.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace rt {

// 16 bytes of T: N elements, unpacked to the accumulator type
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Vec<double> {
  static constexpr int N = 2;
  __device__ __forceinline__ static void unpack(const uint4& r, double (&f)[N]) {
    f[0] = __hiloint2double(static_cast<int>(r.y), static_cast<int>(r.x));
    f[1] = __hiloint2double(static_cast<int>(r.w), static_cast<int>(r.z));
  }
  __device__ __forceinline__ static void store(double* p, const double (&f)[N]) {
    *reinterpret_cast<double2*>(p) = make_double2(f[0], f[1]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&f)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // little endian: element 2j is the low half
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);  // .x low
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The 4 int8 values of a 32-bit word -> float, exact: bias each byte to
// unsigned (xor 0x80), place it in the mantissa of 2^23 and subtract
// 2^23 + 128.
__device__ __forceinline__ void unpack_i8x4(uint32_t w, float (&f)[4]) {
  w ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + e)) - 8388736.f;
}

// The same into double (the byte in the mantissa of 2^52): no F2F.F64.F32,
// whose quarter rate would compete with the DFMAs of an f64 GEMV.
__device__ __forceinline__ void unpack_i8x4(uint32_t w, double (&f)[4]) {
  w ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __hiloint2double(0x43300000, static_cast<int>(__byte_perm(w, 0u, 0x4440u + e))) -
           4503599627370624.0;
}

// 16 int8 values -> float, exact (unpack_i8x4 on each word).
__device__ __forceinline__ void unpack_i8(const uint4& r, float (&f)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float g[4];
    unpack_i8x4(w[j], g);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * j + e] = g[e];
  }
}

// One 16-byte load through the read-only path, unpacked.
template <typename T>
__device__ __forceinline__ void load16(const T* p, typename Acc<T>::type (&f)[Vec<T>::N]) {
  Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

template <typename T>
__host__ __device__ __forceinline__ bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Sum of v over the warp; every lane gets the same total (a fixed tree).
template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rt
