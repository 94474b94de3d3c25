// K2: merge count for Hopper — per sorted probe key x, lo = #{build < x}
// and cnt = #{build == x} in the sorted build keys, as a merge-path count.
//
// Replaces tpujoin/kernels/merge_count.py: `merge_count` (both launches,
// `_kernel` for small m at :201 and `_kernel_big` with SMEM metadata slabs
// at :218).
//
// What bounds it on the H100: the bytes, 4 B read per build key and 12 B
// moved per probe key (~1.6 GB at 100M x 100M, ~0.48 ms at 3.35 TB/s),
// as long as no key waits on a chain of dependent loads through the whole
// build column.
//
// The design: take the merged order of the two sorted columns, a probe key
// before every build key equal to it. The build index at a probe key's
// place on that path is its lo. The path is cut into tiles of TILE
// elements of both columns together, so a block's work and shared memory
// are bounded by TILE whatever the two sizes and the skew:
//   corank_kernel       one thread per tile boundary d finds its co-rank
//                       (i, d - i) by one binary search along the
//                       diagonal; all the searches run at once, so their
//                       dependent loads overlap. No key is a sentinel:
//                       INT32_MIN and INT32_MAX compare like any other.
//   merge_count_kernel  a block stages its build slice b[i0, i1) and probe
//                       slice p[j0, j1) in shared memory (16-byte cp.async
//                       copies where the slice allows, all in flight at
//                       once), each thread finds the co-rank of its ITEMS
//                       consecutive path elements by a search in shared
//                       memory and merges them: a probe key met at (i, j)
//                       gets lo[j] = i. Then thread t takes probe keys t,
//                       t + THREADS, ..., counts each and writes lo and cnt
//                       as coalesced stores.
// cnt: the build keys equal to x follow the probe keys equal to x on the
// path, so when a larger probe key lies in the same tile, x's build run
// ends inside the tile, and a galloping search of the staged slice from
// lo finds its end (one load for a key without a match). Only the tile's
// last probe key can have its run leave the slice. Its #{build <= x} is
// searched once per tile boundary, in the co-rank pass: a galloping search
// of the global build column from the boundary's i, one load when the run
// does not cross (the usual case), ~2 log2(run) when it does (Zipf's top
// key). The alternative, a second co-rank under the other tie order, would
// search every boundary twice and merge every tile twice. Equal probe keys are adjacent on the path with
// no build key between them, so every copy of x, in whichever tile, gets
// the same (lo, cnt). The TPU kernel's window per probe tile had no bound
// on a skewed build; its INT32_MAX padding, small-m/big-m split and
// compare slabs have no counterpart here.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                 // path elements a thread merges
constexpr int TILE = THREADS * ITEMS;     // path elements a block takes
constexpr int CORANK_THREADS = 256;

// Co-rank of path position d: the number i of build keys among the first d
// elements of the merged order (probe first on ties), with d - i probe
// keys. Needs max(0, d - m) <= d <= n + m.
template <typename I>
__device__ __forceinline__ I corank(const int32_t* b, I n, const int32_t* p,
                                    I m, I d) {
  I lo = d > m ? d - m : 0, hi = d < n ? d : n;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (b[mid] < p[d - mid - 1]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Words a pointer lies past a 16-byte boundary.
__device__ __forceinline__ int quad_shift(const int32_t* ptr) {
  return (int)((reinterpret_cast<uintptr_t>(ptr) >> 2) & 3);
}

// Starts the copy of x[0, len) into the shared memory from buf on, 16
// bytes a copy where x allows (cp.async; the caller waits); returns s with
// s[k] = x[k]. buf is 16-byte aligned and holds len + 3 words.
__device__ __forceinline__ int32_t* stage(const int32_t* __restrict__ x,
                                          int len, int32_t* buf) {
  const int sh = quad_shift(x);
  int32_t* s = buf + sh;                  // s + k is aligned where x + k is
  const int head = min((4 - sh) & 3, len);
  const int quads = (len - head) >> 2;
  for (int q = threadIdx.x; q < quads; q += THREADS) {
    const int k = head + 4 * q;
    const unsigned d = (unsigned)__cvta_generic_to_shared(s + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(x + k));
  }
  const int rest = head + 4 * quads, t = threadIdx.x;
  // thread t < head copies word t, the next len - rest threads the tail's
  const int k = t < head ? t : t - head < len - rest ? rest + t - head : -1;
  if (k >= 0) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(s + k);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(x + k));
  }
  return s;
}

// Boundary k of `tiles` + 1: part_i[k] the co-rank i of path position
// min(k * TILE, n + m), part_u[k] = #{build <= p[j - 1]} for its j = d - i
// (i when j == 0).
__global__ void __launch_bounds__(CORANK_THREADS)
corank_kernel(const int32_t* __restrict__ b, int64_t n,
              const int32_t* __restrict__ p, int64_t m, int64_t tiles,
              int32_t* __restrict__ part_i, int32_t* __restrict__ part_u) {
  const int64_t k = (int64_t)blockIdx.x * CORANK_THREADS + threadIdx.x;
  if (k > tiles) return;
  const int64_t d = min(k * TILE, n + m);
  const int64_t i = corank(b, n, p, m, d);
  const int64_t j = d - i;
  part_i[k] = (int32_t)i;
  part_u[k] = (int32_t)(j > 0 ? tj::gallop<true>(b, i, n, p[j - 1]) : i);
}

__global__ void __launch_bounds__(THREADS)
merge_count_kernel(const int32_t* __restrict__ b, int64_t n,
                   const int32_t* __restrict__ p, int64_t m,
                   const int32_t* __restrict__ part_i,
                   const int32_t* __restrict__ part_u,
                   int32_t* __restrict__ lo, int32_t* __restrict__ cnt) {
  // the build slice, then the probe slice, each with 3 words of slack for
  // its alignment; then each probe key's build index in the slice
  __shared__ __align__(16) int32_t keys[TILE + 16];
  __shared__ int32_t lo_s[TILE];
  const int64_t tile = blockIdx.x;
  const int64_t d0 = tile * TILE, d1 = min(d0 + TILE, n + m);
  const int64_t i0 = part_i[tile], i1 = part_i[tile + 1];
  const int64_t j0 = d0 - i0, j1 = d1 - i1;
  const int ni = (int)(i1 - i0), nj = (int)(j1 - j0);
  if (nj == 0) return;                   // build keys only
  const int32_t* bs = stage(b + i0, ni, keys);
  const int32_t* ps = stage(p + j0, nj, keys + ((ni + 6) & ~3));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // #{build <= the tile's last probe key}, for a run that leaves the slice
  const int64_t last_upper = part_u[tile + 1];
  __syncthreads();
  const int dl = threadIdx.x * ITEMS;
  const int nt = (int)(d1 - d0);
  if (dl < nt) {
    int ii = corank(bs, ni, ps, nj, dl);
    int jj = dl - ii;
    const int steps = min(ITEMS, nt - dl);
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      if (s < steps) {
        const bool take_p = jj < nj && (ii >= ni || ps[jj] <= bs[ii]);
        if (take_p) lo_s[jj] = ii;
        jj += take_p;
        ii += !take_p;
      }
    }
  }
  __syncthreads();
  const int32_t last = ps[nj - 1];
  for (int jj = threadIdx.x; jj < nj; jj += THREADS) {
    const int32_t x = ps[jj];
    const int l = lo_s[jj];
    const int u = tj::gallop<true>(bs, l, ni, x);
    lo[j0 + jj] = (int32_t)(i0 + l);
    cnt[j0 + jj] = (u == ni && x == last) ? (int32_t)(last_upper - (i0 + l))
                                          : u - l;
  }
}

}  // namespace

// Path tiles of n + m keys: the co-rank pass needs that + 1 entries in
// each of the two columns of `parts`.
extern "C" int tj_merge_count(const int32_t* b, int64_t n, const int32_t* p,
                              int64_t m, int32_t* lo, int32_t* cnt,
                              int32_t* parts, int64_t nparts,
                              cudaStream_t stream) {
  if (m <= 0) return 0;
  const int64_t tiles = (n + m + TILE - 1) / TILE;
  if (n < 0 || nparts < tiles + 1) return (int)cudaErrorInvalidValue;
  int32_t* part_i = parts;
  int32_t* part_u = parts + nparts;
  corank_kernel<<<(unsigned)((tiles + CORANK_THREADS) / CORANK_THREADS),
                  CORANK_THREADS, 0, stream>>>(b, n, p, m, tiles, part_i,
                                               part_u);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_count_kernel<<<(unsigned)tiles, THREADS, 0, stream>>>(
      b, n, p, m, part_i, part_u, lo, cnt);
  return (int)cudaGetLastError();
}
