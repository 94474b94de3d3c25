// The decoupled look-back of a single-pass scan (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016),
// templated on the scan's combine operator. carry_scan (bench_mat2.cu) runs
// it with `+`, fill_forward (probe_fill.cu) with "the later marker wins".
//
// Each tile publishes one 64-bit status word, the flag in the high 32 bits
// and the 32-bit value in the low: first its aggregate, then, once known,
// its inclusive prefix. A word is written whole, so a reader never sees
// half of one. The words (and the caller's tile ticket) are zeroed on the
// launch's stream before every launch: flag 0 means "not yet published".
//
// An operator is a struct of static device functions over uint32_t:
//   identity()         the value before tile 0;
//   combine(a, b)      a then b (a earlier), associative;
//   absorbs(v)         combine(x, v) == v for every x: the look-back may
//                      stop at a predecessor whose aggregate absorbs;
//   warp_reduce(v)     combine over the warp's lanes, lane 31 the earliest,
//                      returned in every lane.
#pragma once

#include "common.cuh"

namespace tj {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The word alone, with no fence: for a caller whose readers use nothing
// but the word, as radix_sort.cu's digit counts, where 256 threads a tile
// publish twice and a fence after each would stall them.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long flag,
                                             uint32_t value) {
  *reinterpret_cast<volatile unsigned long long*>(p) = flag | value;
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag,
                                        uint32_t value) {
  store_status(p, flag, value);
  __threadfence();
}

struct AddOp {
  __device__ static uint32_t identity() { return 0u; }
  __device__ static uint32_t combine(uint32_t a, uint32_t b) { return a + b; }
  __device__ static bool absorbs(uint32_t) { return false; }
  __device__ static uint32_t warp_reduce(uint32_t v) {
    return __reduce_add_sync(FULL_MASK, v);
  }
};

// Forward fill: a value is an i32 marker (>= 0) or -1 for "none"; the later
// marker wins.
struct LastMarkerOp {
  __device__ static uint32_t identity() { return 0xffffffffu; }
  __device__ static uint32_t combine(uint32_t a, uint32_t b) {
    return (int32_t)b >= 0 ? b : a;
  }
  __device__ static bool absorbs(uint32_t v) { return (int32_t)v >= 0; }
  __device__ static uint32_t warp_reduce(uint32_t v) {
    // lane l folds in lane l + d, which is earlier: v = combine(that, v)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t earlier = __shfl_down_sync(FULL_MASK, v, d);
      if ((threadIdx.x % 32) + d < 32) v = combine(earlier, v);
    }
    return __shfl_sync(FULL_MASK, v, 0);
  }
};

// Exclusive prefix of `tile` (>= 1) from its predecessors' status words, by
// one whole warp (every lane returns it). The warp reads 32 predecessors at
// a time, nearest in lane 0, and stops at the nearest one that holds its
// inclusive prefix or whose aggregate absorbs everything before it.
template <class Op>
__device__ __forceinline__ uint32_t look_back(
    const unsigned long long* status, int64_t tile, int lane) {
  uint32_t exclusive = Op::identity();
  for (int64_t last = tile - 1;; last -= 32) {
    const int64_t j = last - lane;
    // before tile 0: the identity, as a prefix
    unsigned long long word = FLAG_PREFIX | (unsigned long long)Op::identity();
    if (j >= 0) {
      do {
        word = load_status(status + j);
      } while ((word >> 32) == 0);
    }
    uint32_t value = (uint32_t)word;
    const unsigned stop_lanes =
        __ballot_sync(FULL_MASK, (word >> 32) == 2 || Op::absorbs(value));
    // lanes past the nearest stopping predecessor add nothing
    if (stop_lanes != 0 && lane > __ffs(stop_lanes) - 1) value = Op::identity();
    exclusive = Op::combine(Op::warp_reduce(value), exclusive);
    if (stop_lanes != 0) return exclusive;
  }
}

}  // namespace tj
