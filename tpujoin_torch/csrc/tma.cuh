// Hopper's bulk copies (TMA) from device memory into shared memory, each
// completing on an mbarrier. Used by the capability probes' two copies
// (csrc/probe_mosaic2.cu, csrc/probe_mosaic3.cu):
//   mbar_init / mbar_arrive_expect_tx / mbar_wait   the barrier itself;
//   bulk_load        cp.async.bulk of contiguous bytes (1-D);
//   tensor_load_2d   cp.async.bulk.tensor.2d of a box of a tensor map;
//   encode_2d_i32    the host side: a tiled tensor map of a row-major i32
//                    matrix, from cuTensorMapEncodeTiled.
//
// Rules the caller keeps (the hardware's): a bulk copy's global and shared
// addresses are 16-byte aligned and its size is a multiple of 16 bytes; a
// tensor copy's shared destination is 128-byte aligned, a box dimension is
// at most 256 elements and its inner extent a multiple of 16 bytes. A tensor
// copy fills the part of its box outside the tensor with zeros and counts
// the whole box's bytes on the barrier.
//
// The library links no libcuda: libcuda's encoder is looked up at run time
// through the runtime's entry-point query, once per process.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tj {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread initialises the barrier for `count` arrivals, then the block
// syncs before any thread waits on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Copies `bytes` from global `src` to shared `dst`; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copies the box of `map` at (column c0, row c1) to shared `dst`; completes
// on `bar`. `map` lies in the kernel's parameters (__grid_constant__).
__device__ __forceinline__ void tensor_load_2d(void* dst,
                                               const CUtensorMap* map,
                                               int32_t c0, int32_t c1,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once.
inline cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A tensor map of the row-major i32 matrix `base` (rows x cols, 16-byte
// aligned, cols * 4 a multiple of 16) in boxes of box_rows x box_cols, no
// swizzle, zeros outside the matrix.
inline cudaError_t encode_2d_i32(CUtensorMap* map, const void* base,
                                 uint64_t rows, uint64_t cols,
                                 uint32_t box_rows, uint32_t box_cols) {
  EncodeTiledFn encode;
  cudaError_t err = encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};            // innermost first
  const cuuint64_t strides[1] = {cols * sizeof(int32_t)};  // of dim 1, bytes
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tj
