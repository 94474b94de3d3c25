// K4: expansion — for each output slot t, the compacted row r that holds it
// (offs[r] <= t < offs[r + 1]), its build position lo[r] + t - offs[r] and
// its probe id sid[r].
//
// Replaces tpujoin/kernels/expand.py: `expand` (`_kernel`).
//
// What bounds it on the H100: the search for r is latency bound (dependent
// global loads); the bytes are 8 B written per slot plus the rows read,
// ~0.2 GB for the low-selectivity join's ~10M slots.
//
// What the simple design does about it: one thread per slot. Slots are
// ascending and offs is non-decreasing, so a block first finds the rows of
// its first and last slots, and each thread then runs upper_bound - 1 over
// that short window only. The TPU kernel's one-hot and masked-max
// reductions, which stood in for a gather, are plain loads here. Slots at
// or past the total read the last row (r clamped to [0, K - 1]); the caller
// masks them. The arithmetic wraps like the plain version's i32 ops.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
expand_kernel(const int32_t* __restrict__ offs, const int32_t* __restrict__ lo,
              const int32_t* __restrict__ sid, int64_t k,
              int32_t* __restrict__ bpos, int32_t* __restrict__ sid_out,
              int64_t capacity) {
  __shared__ int64_t window[2];
  const int64_t first = (int64_t)blockIdx.x * THREADS;
  const int64_t last = min(first + THREADS, capacity) - 1;
  if (threadIdx.x == 0)
    window[0] = tj::upper_bound(offs, 0, k, (int32_t)first);
  if (threadIdx.x == 32)
    window[1] = tj::upper_bound(offs, 0, k, (int32_t)last);
  __syncthreads();
  const int64_t t = first + threadIdx.x;
  if (t >= capacity) return;
  int64_t r = tj::upper_bound(offs, window[0], window[1], (int32_t)t) - 1;
  r = min(max(r, (int64_t)0), k - 1);
  bpos[t] = (int32_t)((uint32_t)lo[r] + (uint32_t)t - (uint32_t)offs[r]);
  sid_out[t] = sid[r];
}

}  // namespace

extern "C" int tj_expand(const int32_t* offs, const int32_t* lo,
                         const int32_t* sid, int64_t k, int32_t* bpos,
                         int32_t* sid_out, int64_t capacity,
                         cudaStream_t stream) {
  if (capacity <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (capacity + THREADS - 1) / THREADS;
  expand_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      offs, lo, sid, k, bpos, sid_out, capacity);
  return (int)cudaGetLastError();
}
