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

// First index i >= lo of a[lo, n) with a[i] > x (UPPER) or a[i] >= x (a
// ascending), galloping from lo: one load when a[lo] is already past x.
template <bool UPPER, typename I>
__device__ __forceinline__ I gallop(const int32_t* a, I lo, I n, int32_t x) {
  const auto before = [x](int32_t v) { return UPPER ? v <= x : v < x; };
  if (lo >= n || !before(a[lo])) return lo;
  I good = lo, step = 1;                  // before(a[good])
  for (;;) {
    const I next = good + step;
    if (next >= n || !before(a[next])) {
      I l = good + 1, h = next < n ? next : n;
      while (l < h) {
        const I mid = (l + h) >> 1;
        if (before(a[mid])) l = mid + 1; else h = mid;
      }
      return l;
    }
    good = next;
    step <<= 1;
  }
}

// Copies the TILE words of x from `base` into the shared `tile`, coalesced:
// each of THREADS threads loads TILE / THREADS words, neighbouring threads
// neighbouring words, with streaming loads (each word is read once).
template <int THREADS, int TILE>
__device__ __forceinline__ void stage_tile(const int32_t* __restrict__ x,
                                           int64_t base, int32_t* tile) {
  static_assert(TILE % THREADS == 0, "a tile is whole loads");
#pragma unroll
  for (int k = 0; k < TILE / THREADS; ++k) {
    const int l = k * THREADS + threadIdx.x;
    tile[l] = __ldcs(x + base + l);
  }
}

}  // namespace tj
