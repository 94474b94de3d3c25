// merge_count_v: K2's slab design probe for Hopper — per sorted probe key,
// its lower bound and its number of equal keys in the sorted build keys,
// resolved slab by slab of build keys staged in shared memory, the slabs cut
// and skipped as the JAX kernel's strategies cut and skip them.
//
// Replaces exp/count_variants.py: `merge_count_v` (`_kernel`), every
// strategy: fat512 (no slab skip), fatcN (the whole tile as one probe piece,
// N-key slabs), diagN and quadN (128-key probe pieces, N-key slabs).
//
// What bounds it on the H100: the bytes, K2's (4 B a build key, 12 B a
// probe key: 0.478 ms at 100M x 100M and 3.35 TB/s). The JAX kernel, and
// this port's first design, resolved a slab by comparing each probe key of
// a piece with every key of the slab, two compares and two adds a pair:
// ~1e11 i32 ops at ref_low for diag128 and ~8e11 for fat512, which set the
// time. A slab is sorted, so its keys below x are x's lower bound in it and
// its keys equal to x are the upper bound minus the lower bound: a search
// gives in ~log2(slab) loads what the compare gives in `slab` steps,
// bitwise the same.
//
// Design. Two launches:
//   window_kernel      one thread a tile of TILE probe keys finds the
//                      tile's build window [w_lo, w_hi): the lower bound of
//                      its first key (a binary search of the whole column)
//                      and the upper bound of its last (galloping from
//                      w_lo), into a scratch the wrapper allocates. All the
//                      searches run at once, so their dependent loads
//                      overlap, as in K2's co-rank pass.
//   slab_count_kernel  one block a tile, ITEMS (4) consecutive probe keys a
//                      thread, so a 128-key probe piece is one warp and its
//                      bounds are warp-uniform. The window's CHUNK (1024)
//                      key chunks, from the CHUNK-aligned start at or below
//                      w_lo, go through two shared-memory buffers by
//                      cp.async (16 bytes a thread), the next chunk's copy
//                      in flight while this one is searched; keys past n
//                      read as INT32_MAX, the JAX kernel's pad. A chunk
//                      wholly below the tile adds CHUNK, one wholly above
//                      is skipped (the chunk-level skip every strategy
//                      keeps). In a boundary chunk the slabs wholly below
//                      the piece come first and the slabs wholly above it
//                      last; a search of the slab ends finds both runs,
//                      each slab below adds its length and each slab above
//                      is skipped (fat512 skips none and adds none: it
//                      resolves every slab). The slabs left are consecutive,
//                      so one search of their span resolves them all: it
//                      gives what a search of each gives, summed. A thread
//                      leaves a span its four keys miss after two loads;
//                      otherwise it takes its first key's lower bound by a
//                      branch-free halving of the span and each next bound
//                      by a few loads at once from the bound before, with a
//                      gallop where a run of equal keys outlasts them.
// lo is the true lower bound: the JAX kernel's clamp of its window start to
// n_pad - CHUNK has no counterpart.
#include "common.cuh"

namespace {

constexpr int CHUNK = 1024;
constexpr int TILE = 1024;               // probe keys a block
constexpr int ITEMS = 4;                 // probe keys a thread
constexpr int THREADS = TILE / ITEMS;
constexpr int WINDOW_THREADS = 256;
constexpr int32_t PAD = 0x7fffffff;
static_assert(THREADS * 4 == CHUNK, "a chunk is one 16-byte copy a thread");

// Tile t's window: w_lo[t] = #{build < p[first]}, w_hi[t] = #{build <=
// p[last]}.
__global__ void __launch_bounds__(WINDOW_THREADS)
window_kernel(const int32_t* __restrict__ b, int64_t n,
              const int32_t* __restrict__ p, int64_t m, int64_t tiles,
              int32_t* __restrict__ w_lo, int32_t* __restrict__ w_hi) {
  const int64_t t = (int64_t)blockIdx.x * WINDOW_THREADS + threadIdx.x;
  if (t >= tiles) return;
  const int64_t first = t * TILE, last = min(first + TILE, m) - 1;
  const int64_t lo = tj::lower_bound(b, 0, n, p[first]);
  w_lo[t] = (int32_t)lo;
  w_hi[t] = (int32_t)tj::gallop<true>(b, lo, n, p[last]);
}

// Starts the copy of b[start, start + CHUNK) into dst (the caller commits
// and waits), keys past n as PAD: one 16-byte copy a thread where b is
// 16-byte aligned and the thread's four keys lie below n, else key by key.
__device__ __forceinline__ void stage_chunk(const int32_t* __restrict__ b,
                                            int64_t n, int64_t start,
                                            bool aligned, int32_t* dst) {
  const int e = threadIdx.x * 4;
  const int64_t g = start + e;
  if (aligned && g + 4 <= n) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + e);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(b + g));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (g + j < n) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + e + j);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(b + g + j));
    } else {
      dst[e + j] = PAD;
    }
  }
}

// First index k >= j of s[j, len) with s[k] past x (> x for UPPER, else
// >= x), s[j - 1] not: P loads at once, then a gallop when all P keys fall
// short (a run of equal keys).
template <bool UPPER, int P>
__device__ __forceinline__ int ahead(const int32_t* s, int j, int len,
                                     int32_t x) {
  int k = j;
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int idx = min(j + t, len - 1);
    const int32_t v = s[idx];
    k += (j + t < len) && (UPPER ? v <= x : v < x);
  }
  return k == j + P ? tj::gallop<UPPER>(s, k, len, x) : k;
}

// Adds to lt[i] and eq[i] the keys of the sorted span s[0, len) below and
// equal to x[i], for a thread's ascending consecutive keys x.
__device__ __forceinline__ void resolve(const int32_t* s, int len,
                                        const int32_t (&x)[ITEMS],
                                        int (&lt)[ITEMS], int (&eq)[ITEMS]) {
  if (x[ITEMS - 1] < s[0]) return;          // every key below the span
  if (x[0] > s[len - 1]) {                  // every key above it
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) lt[i] += len;
    return;
  }
  int l = 0;
  if (x[0] > s[0]) {
    // s[l] < x[0] holds and the bound lies in (l, l + w]
    for (int w = len; w > 1;) {
      const int half = w >> 1;
      if (s[l + half] < x[0]) l += half;
      w -= half;
    }
    ++l;
  }
  int u = ahead<true, 2>(s, l, len, x[0]);
  lt[0] += l;
  eq[0] += u - l;
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) {
    if (x[i] != x[i - 1]) {        // x[i] > x[i - 1] >= every key below u
      l = ahead<false, 3>(s, u, len, x[i]);
      u = ahead<true, 2>(s, l, len, x[i]);
    }
    lt[i] += l;
    eq[i] += u - l;
  }
}

__global__ void __launch_bounds__(THREADS)
slab_count_kernel(const int32_t* __restrict__ b, int64_t n,
                  const int32_t* __restrict__ p, int64_t m,
                  const int32_t* __restrict__ w_lo,
                  const int32_t* __restrict__ w_hi, int warp_pieces,
                  int slab, int skip_slabs, int32_t* __restrict__ lo,
                  int32_t* __restrict__ cnt) {
  __shared__ __align__(16) int32_t keys[2][CHUNK];
  const int64_t tile = blockIdx.x;
  const int64_t first = tile * TILE, last = min(first + TILE, m) - 1;
  const int64_t w0 = (int64_t)w_lo[tile] / CHUNK * CHUNK;
  const int nchunks = (int)((w_hi[tile] - w0 + CHUNK - 1) / CHUNK);
  const bool aligned = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  if (nchunks > 0) {
    stage_chunk(b, n, w0, aligned, keys[0]);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int32_t tile_min = p[first], tile_max = p[last];
  const int64_t k0 = first + (int64_t)threadIdx.x * ITEMS;
  int32_t x[ITEMS];
  int lt[ITEMS], eq[ITEMS];
  if (k0 + ITEMS - 1 <= last && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int4 q = *reinterpret_cast<const int4*>(p + k0);   // k0 % 4 == 0
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) x[i] = k0 + i <= last ? p[k0 + i] : PAD;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) lt[i] = eq[i] = 0;
  // the probe piece's bounds: the warp's keys, or the whole tile's
  int32_t piece_min = tile_min, piece_max = tile_max;
  if (warp_pieces) {
    piece_min = __shfl_sync(0xffffffffu, x[0], 0);
    piece_max = __shfl_sync(0xffffffffu, x[ITEMS - 1], 31);
  }

  for (int c = 0; c < nchunks; ++c) {
    // chunk c + 1's buffer was last read in chunk c - 1, before its barrier
    if (c + 1 < nchunks) {
      stage_chunk(b, n, w0 + (int64_t)(c + 1) * CHUNK, aligned,
                  keys[(c + 1) & 1]);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();   // chunk c has landed for every thread
    const int32_t* s = keys[c & 1];
    if (s[CHUNK - 1] < tile_min) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) lt[i] += CHUNK;
    } else if (s[0] <= tile_max) {
      // slabs [a, z) are resolved; those below a lie wholly below the
      // piece and are added, those from z on wholly above it and skipped
      int a = 0, z = CHUNK / slab;
      if (skip_slabs) {
        for (int hi = z; a < hi;) {
          const int mid = (a + hi) >> 1;
          if (s[mid * slab + slab - 1] < piece_min) a = mid + 1; else hi = mid;
        }
        for (int l = a; l < z;) {
          const int mid = (l + z) >> 1;
          if (s[mid * slab] > piece_max) z = mid; else l = mid + 1;
        }
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) lt[i] += a * slab;
      // the resolved slabs are consecutive: one search of their span gives
      // what a search of each gives, summed
      if (a < z) resolve(s + a * slab, (z - a) * slab, x, lt, eq);
    }
    __syncthreads();   // no thread reads chunk c once c + 2 is staged
  }
  int32_t lo_v[ITEMS], cnt_v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    lo_v[i] = (int32_t)min(w0 + lt[i], n);
    cnt_v[i] = eq[i];
  }
  if (k0 + ITEMS - 1 <= last) {   // the wrapper's fresh outputs: aligned
    *reinterpret_cast<int4*>(lo + k0) =
        make_int4(lo_v[0], lo_v[1], lo_v[2], lo_v[3]);
    *reinterpret_cast<int4*>(cnt + k0) =
        make_int4(cnt_v[0], cnt_v[1], cnt_v[2], cnt_v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (k0 + i > last) break;
    lo[k0 + i] = lo_v[i];
    cnt[k0 + i] = cnt_v[i];
  }
}

}  // namespace

// slab: a power of two in [4, CHUNK]; warp_pieces: 128-key probe pieces
// (else the whole tile is one piece); skip_slabs: 0 resolves every slab of
// a boundary chunk (fat512). window: the two window columns, nwindow >=
// ceil(m / TILE) entries each.
extern "C" int tj_slab_count(const int32_t* b, int64_t n, const int32_t* p,
                             int64_t m, int64_t warp_pieces, int64_t slab,
                             int64_t skip_slabs, int32_t* window,
                             int64_t nwindow, int32_t* lo, int32_t* cnt,
                             cudaStream_t stream) {
  if (m <= 0) return 0;
  const int64_t tiles = (m + TILE - 1) / TILE;
  if (slab < 4 || slab > CHUNK || (slab & (slab - 1)) || n < 0 ||
      n > PAD || nwindow < tiles)
    return (int)cudaErrorInvalidValue;
  int32_t* w_lo = window;
  int32_t* w_hi = window + nwindow;
  window_kernel<<<(unsigned)((tiles + WINDOW_THREADS - 1) / WINDOW_THREADS),
                  WINDOW_THREADS, 0, stream>>>(b, n, p, m, tiles, w_lo, w_hi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slab_count_kernel<<<(unsigned)tiles, THREADS, 0, stream>>>(
      b, n, p, m, w_lo, w_hi, (int)warp_pieces, (int)slab, (int)skip_slabs,
      lo, cnt);
  return (int)cudaGetLastError();
}
