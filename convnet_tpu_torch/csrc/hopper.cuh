// Hopper (sm_90a) plumbing shared by the TMA + wgmma kernels of this
// directory (matmul_fused.cu, matmul_int8.cu): mbarriers, TMA loads and
// stores, named barriers, wgmma shared-memory descriptors, and the host-side
// encoding of TMA tensor maps. Included by each .cu file, which is built on
// its own into its own library (ops/kernels/_build.py keys every build on
// the headers its source includes).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Makes the mbarriers one thread initialised visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA

// A 2-D box at (c0 inner, c1 outer) into shared memory at dst; completion
// (the box's bytes) is reported to the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory writes of this thread, made visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The TMA stores this thread issued since the last commit, as one group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Returns once this thread's store groups have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Returns once this thread's store groups have completed.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The barrier of one warpgroup (128 threads); id 0 is __syncthreads'.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------------------ wgmma

// A K-major wgmma operand in shared memory as TMA writes it with a 128-,
// 64- or 32-byte swizzle (swizzle_bytes): 8-row groups of swizzled rows of
// swizzle_bytes each, so the stride between groups (SBO) is 8 rows.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr,
                                                int swizzle_bytes) {
  const uint64_t mode = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * swizzle_bytes >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- tensor maps (the host)

// cuTensorMapEncodeTiled, reached through the runtime so that no driver
// library is linked; null where the driver does not offer it.
inline PFN_cuTensorMapEncodeTiled encode_fn() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, inner) matrix of elem_bytes-wide elements of `type`,
// read or written in boxes of (box_rows, box_inner) with the given swizzle;
// out-of-range elements read as 0 and are not written.
inline bool encode(PFN_cuTensorMapEncodeTiled fn, CUtensorMap* map,
                   CUtensorMapDataType type, int elem_bytes, const void* p,
                   int rows, int inner, int box_inner, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 case in boxes of (box_rows, 64) with the 128-byte swizzle.
inline bool encode_bf16(PFN_cuTensorMapEncodeTiled fn, CUtensorMap* map,
                        const void* p, int rows, int inner, int box_rows) {
  return encode(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, rows, inner,
                64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hopper
