// Shared device helpers for the tpujoin_torch kernels.
//
// Every entry point is a plain C function that launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() after its launch
// (0 = launched). Indices are 64-bit wherever a column can pass 2^31 bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tj {

// First index in a[lo, hi) with a[i] >= x (a ascending).
__device__ __forceinline__ int64_t lower_bound(const int32_t* a, int64_t lo,
                                               int64_t hi, int32_t x) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index in a[lo, hi) with a[i] > x (a ascending).
__device__ __forceinline__ int64_t upper_bound(const int32_t* a, int64_t lo,
                                               int64_t hi, int32_t x) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace tj
