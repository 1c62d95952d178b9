// Hopper's asynchronous copies, shared by the kernels that use them
// (gemm_sm90.cu, gemm_f32.cu): mbarriers in shared memory, 2-D and 3-D TMA
// tile loads that complete on them, and the host side's TMA descriptor
// encode.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// returns once the phase of the given parity has completed; a wait that
// never completes (a broken pipeline) traps after 2^26 polls (seconds)
// rather than holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// makes the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ---- TMA: one 2-D box into shared memory, completion counted on `bar` -----
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- TMA: one 3-D box (c2 the outermost coordinate, e.g. the batch) -------
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- host: TMA descriptors --------------------------------------------------

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's driver entry point, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) matrix as boxes of (box_outer, box_inner), its
// rows `ld` elements apart (0: inner, contiguous); out-of-bounds elements,
// those of a row's padding past `inner` included, load as zeros.  Returns 0
// or a nonzero CUresult.
inline int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                  int elem, long inner, long outer, int box_inner, int box_outer,
                  CUtensorMapSwizzle swizzle, long ld = 0) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld ? ld : inner) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  return static_cast<int>(fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// A stack of `depth` row-major (outer, inner) matrices, each `outer * ld`
// elements after the one before, as boxes of (box_inner, box_outer) in one
// matrix: a box past a matrix's last row or column loads zeros, never the
// next matrix's elements.  Returns 0 or a nonzero CUresult.
inline int encode3(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                   int elem, long inner, long outer, long depth, int box_inner, int box_outer,
                   CUtensorMapSwizzle swizzle, long ld) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * elem,
                                 static_cast<cuuint64_t>(ld) * outer * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return static_cast<int>(fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace rt
