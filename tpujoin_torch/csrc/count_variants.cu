// merge_count_v: K2's dense-compare design probe for Hopper — per sorted
// probe key, its lower bound and its number of equal keys in the sorted
// build keys, by counting compares against shared-memory slabs of build keys
// instead of a binary search.
//
// Replaces exp/count_variants.py: `merge_count_v` (`_kernel`), every
// strategy: fat512 (no slab skip), fatcN (the whole tile as one probe piece,
// N-key slabs), diagN and quadN (128-key probe pieces, N-key slabs).
//
// What bounds it on the H100: the compares. The bytes are K2's (4 B a build
// key, 12 B a probe key: 0.478 ms at 100M x 100M and 3.35 TB/s), but a tile
// of probe keys is compared with every build key of its window: ~1024 x
// 2048 compare pairs a tile at ref_low, ~2e11 in all, two compares and two
// adds a pair on the i32 units. The slab skip is what the strategies vary:
// a slab that lies wholly below a probe piece adds its length to lo without
// a compare, one wholly above is skipped.
//
// Design: one block takes a tile of TILE probe keys, ITEMS (4) consecutive
// keys a thread, so a 128-key probe piece is one warp and its skip decision
// is warp-uniform. The block finds its build window with two searches of
// the whole build column, from the JAX kernel's CHUNK-aligned start, and
// stages CHUNK (1024) build keys at a time in shared memory (4 KB), keys
// past n read as INT32_MAX, the JAX kernel's pad. A chunk wholly below the
// tile adds CHUNK, one wholly above is skipped (the chunk-level skip every
// strategy keeps); otherwise each slab is skipped, added or compared
// densely, each thread reading the slab as 16-byte broadcasts and counting
// `<` and `==` for its four keys. lo is the true lower bound: the JAX
// kernel's clamp of its window start to n_pad - CHUNK has no counterpart.
#include "common.cuh"

namespace {

constexpr int CHUNK = 1024;
constexpr int TILE = 1024;               // probe keys a block
constexpr int ITEMS = 4;                 // probe keys a thread
constexpr int THREADS = TILE / ITEMS;
constexpr int32_t PAD = 0x7fffffff;

__global__ void __launch_bounds__(THREADS)
slab_count_kernel(const int32_t* __restrict__ b, int64_t n,
                  const int32_t* __restrict__ p, int64_t m, int warp_pieces,
                  int slab, int skip_slabs, int32_t* __restrict__ lo,
                  int32_t* __restrict__ cnt) {
  __shared__ __align__(16) int32_t keys[CHUNK];
  __shared__ int64_t window[2];
  const int64_t first = (int64_t)blockIdx.x * TILE;
  const int64_t last = min(first + TILE, m) - 1;
  if (threadIdx.x == 0) window[0] = tj::lower_bound(b, 0, n, p[first]);
  if (threadIdx.x == 32) window[1] = tj::upper_bound(b, 0, n, p[last]);
  __syncthreads();
  const int64_t w0 = window[0] / CHUNK * CHUNK;
  const int64_t nchunks = (window[1] - w0 + CHUNK - 1) / CHUNK;
  const int32_t tile_min = p[first], tile_max = p[last];

  const int64_t k0 = first + (int64_t)threadIdx.x * ITEMS;
  int32_t x[ITEMS];
  int lt[ITEMS], eq[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    x[i] = k0 + i <= last ? p[k0 + i] : PAD;
    lt[i] = eq[i] = 0;
  }
  // the probe piece's bounds: the warp's keys, or the whole tile's
  int32_t piece_min = tile_min, piece_max = tile_max;
  if (warp_pieces) {
    piece_min = __shfl_sync(0xffffffffu, x[0], 0);
    piece_max = __shfl_sync(0xffffffffu, x[ITEMS - 1], 31);
  }

  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t start = w0 + c * CHUNK;
    __syncthreads();   // the previous chunk is no longer read
    for (int e = threadIdx.x; e < CHUNK; e += THREADS)
      keys[e] = start + e < n ? b[start + e] : PAD;
    __syncthreads();
    const int32_t c_min = keys[0], c_max = keys[CHUNK - 1];
    if (c_max < tile_min) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) lt[i] += CHUNK;
      continue;
    }
    if (c_min > tile_max) continue;
    for (int s0 = 0; s0 < CHUNK; s0 += slab) {
      if (skip_slabs) {
        if (keys[s0 + slab - 1] < piece_min) {
#pragma unroll
          for (int i = 0; i < ITEMS; ++i) lt[i] += slab;
          continue;
        }
        if (keys[s0] > piece_max) continue;
      }
#pragma unroll 4
      for (int k = s0; k < s0 + slab; k += 4) {
        const int4 v = *reinterpret_cast<const int4*>(keys + k);
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          lt[i] += (v.x < x[i]) + (v.y < x[i]) + (v.z < x[i]) + (v.w < x[i]);
          eq[i] += (v.x == x[i]) + (v.y == x[i]) + (v.z == x[i]) +
                   (v.w == x[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (k0 + i > last) break;
    lo[k0 + i] = (int32_t)min(w0 + lt[i], n);
    cnt[k0 + i] = eq[i];
  }
}

}  // namespace

// slab: a power of two in [4, CHUNK]; warp_pieces: 128-key probe pieces
// (else the whole tile is one piece); skip_slabs: 0 compares every slab of
// a boundary chunk (fat512).
extern "C" int tj_slab_count(const int32_t* b, int64_t n, const int32_t* p,
                             int64_t m, int64_t warp_pieces, int64_t slab,
                             int64_t skip_slabs, int32_t* lo, int32_t* cnt,
                             cudaStream_t stream) {
  if (m <= 0) return 0;
  if (slab < 4 || slab > CHUNK || (slab & (slab - 1)))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (m + TILE - 1) / TILE;
  slab_count_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      b, n, p, m, (int)warp_pieces, (int)slab, (int)skip_slabs, lo, cnt);
  return (int)cudaGetLastError();
}
