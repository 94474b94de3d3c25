// Hopper's bulk copy (TMA) from device memory into shared memory,
// completing on an mbarrier. Used by the capability probe's copy
// (csrc/probe_mosaic2.cu, hbm_to_smem):
//   mbar_init / mbar_arrive_expect_tx / mbar_wait   the barrier itself;
//   bulk_load        cp.async.bulk of contiguous bytes (1-D).
//
// Rules the caller keeps (the hardware's): a bulk copy's global and shared
// addresses are 16-byte aligned and its size is a multiple of 16 bytes.
#pragma once

#include <cstdint>
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

}  // namespace tj
