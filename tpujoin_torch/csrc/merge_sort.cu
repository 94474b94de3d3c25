// K1: (key, id) merge sort for Hopper — block sort + merge-path passes.
//
// Replaces tpujoin/kernels/merge_sort.py: `local_sort` (_local_sort_kernel)
// and `merge_pass` (_kernel, host co-rank `_plan`), driven from Python by
// tpujoin_torch/kernels/merge_sort.py:sort_pairs.
//
// What bounds it on the H100: each merge pass streams every (key, id) pair
// in and out once, 16 B per pair, so a 100M-row sort of ceil(log2(n/2048))
// = 16 passes moves ~26 GB (~8 ms at 3.35 TB/s). The block sort is bound by
// its 66 shared-memory compare-exchange stages, each ending in a barrier.
// The co-rank searches are latency bound: two per block, ~log2(run) global
// loads each.
//
// What the simple design does about it: one pass is one launch that reads
// each pair once into shared memory and writes it once, coalesced; the
// per-thread merge runs entirely in shared memory. No sentinel keys: the
// block sort packs (key, local index) into one 64-bit word, so pad slots
// (all ones) sort strictly after every real pair, and the merge handles the
// ragged last run with bounds. Every i32 key sorts, INT32_MAX included.
// The result is stable: ties keep their input order (the local index breaks
// ties in the block sort; the merge takes A first on ties).
//
// Not carried over from the TPU kernel: the alternating asc/desc run
// orientation (Mosaic had no `rev`), ALIGN-sized DMA slabs and the flat
// rolls that placed them, and the padding of n to a multiple of the tile.
#include "common.cuh"

namespace {

constexpr int SORT_TILE = 2048;      // pairs per block-sorted run
constexpr int SORT_THREADS = SORT_TILE / 2;
constexpr int MERGE_TILE = 2048;     // outputs per merge block
constexpr int MERGE_THREADS = 256;
constexpr int IPT = MERGE_TILE / MERGE_THREADS;

__global__ void __launch_bounds__(SORT_THREADS)
block_sort_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ ids, int32_t* __restrict__ ko,
                  int32_t* __restrict__ io, int64_t n) {
  __shared__ uint64_t s[SORT_TILE];
  __shared__ int32_t sid[SORT_TILE];
  const int64_t base = (int64_t)blockIdx.x * SORT_TILE;
  const int valid = (int)min((int64_t)SORT_TILE, n - base);
  for (int i = threadIdx.x; i < SORT_TILE; i += SORT_THREADS) {
    if (i < valid) {
      // flip the sign bit: unsigned order of the biased key == i32 order
      const uint32_t k = (uint32_t)keys[base + i] ^ 0x80000000u;
      s[i] = ((uint64_t)k << 32) | (uint32_t)i;
      sid[i] = ids[base + i];
    } else {
      s[i] = ~0ull;  // local index < SORT_TILE, so no real word reaches this
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= SORT_TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      // thread t owns the pair (i, i + j): t with a zero bit inserted at j
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const uint64_t x = s[i], y = s[i + j];
      const bool up = (i & k) == 0;
      if ((x > y) == up) {
        s[i] = y;
        s[i + j] = x;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < valid; i += SORT_THREADS) {
    const uint64_t v = s[i];
    ko[base + i] = (int32_t)((uint32_t)(v >> 32) ^ 0x80000000u);
    io[base + i] = sid[(uint32_t)v];
  }
}

// Number of A elements among the first d outputs of merge(A, B), ties from
// A first: the smallest a with A[a] > B[d - 1 - a].
__device__ int64_t co_rank(const int32_t* A, int64_t la, const int32_t* B,
                           int64_t lb, int64_t d) {
  int64_t lo = max((int64_t)0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (A[mid] <= B[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_pass_kernel(const int32_t* __restrict__ ki,
                  const int32_t* __restrict__ ii, int32_t* __restrict__ ko,
                  int32_t* __restrict__ io, int64_t n, int64_t run) {
  __shared__ int32_t sk[MERGE_TILE];
  __shared__ int32_t sv[MERGE_TILE];
  __shared__ int64_t split[2];
  // a tile never straddles two pairs: 2 * run is a multiple of MERGE_TILE
  const int64_t c = (int64_t)blockIdx.x * MERGE_TILE;
  const int64_t pair0 = (c / (2 * run)) * (2 * run);
  const int64_t la = min(run, n - pair0);
  const int64_t lb = max((int64_t)0, min(run, n - pair0 - run));
  const int32_t* A = ki + pair0;
  const int32_t* B = ki + pair0 + run;  // read only when lb > 0
  const int64_t d0 = c - pair0;
  const int64_t d1 = min(d0 + MERGE_TILE, la + lb);
  if (threadIdx.x == 0) split[0] = co_rank(A, la, B, lb, d0);
  if (threadIdx.x == 32) split[1] = co_rank(A, la, B, lb, d1);
  __syncthreads();
  const int64_t a0 = split[0];
  const int64_t b0 = d0 - a0;
  const int na = (int)(split[1] - a0);
  const int nb = (int)(d1 - split[1] - b0);
  for (int i = threadIdx.x; i < na; i += MERGE_THREADS) {
    sk[i] = A[a0 + i];
    sv[i] = ii[pair0 + a0 + i];
  }
  for (int i = threadIdx.x; i < nb; i += MERGE_THREADS) {
    sk[na + i] = B[b0 + i];
    sv[na + i] = ii[pair0 + run + b0 + i];
  }
  __syncthreads();

  // each thread merges IPT consecutive outputs from the shared windows
  const int total = na + nb;
  const int d = min((int)threadIdx.x * IPT, total);
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] <= sk[na + d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int a = lo, b = d - lo;
  int32_t ok[IPT], ov[IPT];
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    const bool take_a = b >= nb || (a < na && sk[a] <= sk[na + b]);
    // past the window's end both sides are spent: clamp, the value is unused
    const int src = min(take_a ? a : na + b, MERGE_TILE - 1);
    ok[q] = sk[src];
    ov[q] = sv[src];
    if (take_a) ++a; else ++b;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < IPT; ++q) {
    if (d + q < total) {
      sk[d + q] = ok[q];
      sv[d + q] = ov[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += MERGE_THREADS) {
    ko[c + i] = sk[i];
    io[c + i] = sv[i];
  }
}

}  // namespace

extern "C" {

int tj_block_sort(const int32_t* keys, const int32_t* ids, int32_t* ko,
                  int32_t* io, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + SORT_TILE - 1) / SORT_TILE;
  block_sort_kernel<<<(unsigned)blocks, SORT_THREADS, 0, stream>>>(
      keys, ids, ko, io, n);
  return (int)cudaGetLastError();
}

int tj_merge_pass(const int32_t* ki, const int32_t* ii, int32_t* ko,
                  int32_t* io, int64_t n, int64_t run, cudaStream_t stream) {
  if (run <= 0 || (2 * run) % MERGE_TILE != 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n + MERGE_TILE - 1) / MERGE_TILE;
  merge_pass_kernel<<<(unsigned)blocks, MERGE_THREADS, 0, stream>>>(
      ki, ii, ko, io, n, run);
  return (int)cudaGetLastError();
}

const char* tj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
