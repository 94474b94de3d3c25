// K2: merge count for Hopper — per sorted probe key, its lower bound and its
// number of equal keys in the sorted build keys.
//
// Replaces tpujoin/kernels/merge_count.py: `merge_count` (both launches,
// `_kernel` for small m and `_kernel_big` with SMEM metadata slabs above
// 65,536 tiles).
//
// What bounds it on the H100: the binary searches are latency bound, a
// chain of dependent global loads per probe key. The bytes are small: 4 B
// read per build key and 12 B moved per probe key (~1.6 GB at 100M x 100M,
// ~0.5 ms at 3.35 TB/s).
//
// What the simple design does about it: one thread per probe key. Because
// the probe keys are sorted, a block first finds the build window of its
// first and last keys (two searches over the whole array, by two warps at
// once), and every thread then searches only that window — a few steps in
// lines the block shares, instead of ~27 over 100M keys. One kernel covers
// every m: the TPU's small-m/big-m split existed only for its 1 MB SMEM.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
merge_count_kernel(const int32_t* __restrict__ b, int64_t n,
                   const int32_t* __restrict__ p, int64_t m,
                   int32_t* __restrict__ lo, int32_t* __restrict__ cnt) {
  __shared__ int64_t window[2];
  const int64_t first = (int64_t)blockIdx.x * THREADS;
  const int64_t last = min(first + THREADS, m) - 1;
  if (threadIdx.x == 0) window[0] = tj::lower_bound(b, 0, n, p[first]);
  if (threadIdx.x == 32) window[1] = tj::upper_bound(b, 0, n, p[last]);
  __syncthreads();
  const int64_t i = first + threadIdx.x;
  if (i >= m) return;
  const int32_t x = p[i];
  const int64_t l = tj::lower_bound(b, window[0], window[1], x);
  const int64_t u = tj::upper_bound(b, l, window[1], x);
  lo[i] = (int32_t)l;
  cnt[i] = (int32_t)(u - l);
}

}  // namespace

extern "C" int tj_merge_count(const int32_t* b, int64_t n, const int32_t* p,
                              int64_t m, int32_t* lo, int32_t* cnt,
                              cudaStream_t stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + THREADS - 1) / THREADS;
  merge_count_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(b, n, p, m, lo,
                                                               cnt);
  return (int)cudaGetLastError();
}
