// run_variant: the phase ablation of K7 expand_runs for Hopper. Each
// variant keeps some of the kernel's phases and drops the others, so that
// their times attribute expand_runs' cost:
//
//   full      rank search + per-slot run search + metadata reads + the
//             shared-memory gather of the source slab
//   noroll    as full, the gather replaced by src[sb + u] + delta
//   noscalar  no metadata reads: run d of a tile has offset t0 + d, build
//             start 7d and probe id d
//   norank    no rank search: runs 0..min(rel_max, 12) of the slab
//   empty     the rank search, then both columns D(D + 1) / 2, stores only
//
// Replaces exp/profile_expand_runs.py: `run_variant` (`_kernel`), all five
// variants, each computed bitwise (the JAX ablations' outputs are defined,
// if not pairs).
//
// Per slot u of the TILE-slot tile at t0 of step i: mb = meta_base[i],
// sb = src_base[i]; r0 = #(off[mb:mb+META] <= t0) - 1 and
// r1 = #(off[mb:mb+META] < t0 + TILE) - 1, clipped as the JAX kernel clips
// them; d = the last of 0..r1-r0 with off[mb+r0+d] <= t0 + u (none: both
// columns 0); raw = t0 - off_d + lo_d - sb in i32, delta = raw mod SRC;
// r = src[sb + (u + delta) mod SRC], s = sid_d; both -1 at t0 + u >= total.
// The JAX kernel loops over d and keeps the last whose mask holds; the
// offsets are sorted, so that d is one upper-bound search in the slab.
//
// What bounds it on the H100: the 8 B written a slot (0.8 GB at the
// probe's 100M slots, ~0.24 ms at 3.35 TB/s); the run metadata and the
// source are read once in ~60 MB. Design: one block a STEP (8 tiles of
// 1024 slots), 256 threads, 4 consecutive slots a thread a tile and one
// 16-byte store a column; the META offsets, build starts and probe ids
// (3 x 8 KB) and the SRC-slot source slab (16 KB) are staged in shared
// memory, as the JAX kernel DMAs them to SMEM and VMEM.
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int BATCH = 8;
constexpr int META = 2048;
constexpr int SRC = 4096;
constexpr int THREADS = 256;
constexpr int ITEMS = TILE / THREADS;    // slots a thread a tile

enum Variant { FULL = 0, NOROLL = 1, NOSCALAR = 2, NORANK = 3, EMPTY = 4 };

template <int V>
__global__ void __launch_bounds__(THREADS)
run_variant_kernel(const int32_t* __restrict__ off,
                   const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ sid,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ meta_base,
                   const int32_t* __restrict__ src_base, int64_t nonzero,
                   int64_t total, int32_t* __restrict__ r_out,
                   int32_t* __restrict__ s_out) {
  __shared__ int32_t off_s[META], lo_s[META], sid_s[META], slab[SRC];
  const int64_t step = blockIdx.x;
  const int64_t mb = meta_base[step], sb = src_base[step];
  for (int e = threadIdx.x; e < META; e += THREADS) {
    off_s[e] = __ldg(off + mb + e);
    lo_s[e] = __ldg(lo + mb + e);
    sid_s[e] = __ldg(sid + mb + e);
  }
  for (int e = threadIdx.x; e < SRC; e += THREADS) slab[e] = __ldg(src + sb + e);
  __syncthreads();
  const int64_t rel_max = min(nonzero - 1 - mb, (int64_t)META - 1);

  for (int j = 0; j < BATCH; ++j) {
    const int64_t t0 = (step * BATCH + j) * TILE;
    int64_t r0, r1;
    if (V == NORANK) {
      r0 = 0;
      r1 = min(rel_max, (int64_t)12);
    } else {
      r0 = tj::upper_bound(off_s, 0, META, (int32_t)t0) - 1;
      r1 = tj::lower_bound(off_s, 0, META, (int32_t)(t0 + TILE)) - 1;
      r0 = min(max(r0, (int64_t)0), rel_max);
      r1 = min(max(r1, r0), rel_max);
    }
    const int64_t span = r1 - r0;          // D: runs r0..r1 of the slab
    int32_t rv[ITEMS], sv[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int u = threadIdx.x * ITEMS + q;
      const int64_t t = t0 + u;
      rv[q] = sv[q] = 0;
      if (V == EMPTY) {
        rv[q] = sv[q] = (int32_t)(span * (span + 1) / 2);
      } else {
        int64_t d;
        int32_t off_d, lo_d, sid_d;
        if (V == NOSCALAR) {
          d = min((int64_t)u, span);
          off_d = (int32_t)(t0 + d);
          lo_d = (int32_t)(7 * d);
          sid_d = (int32_t)d;
        } else {
          d = tj::upper_bound(off_s, r0, r1 + 1, (int32_t)t) - 1 - r0;
          const int64_t m = r0 + max(d, (int64_t)0);
          off_d = off_s[m];
          lo_d = lo_s[m];
          sid_d = sid_s[m];
        }
        if (d >= 0) {
          const int32_t raw = (int32_t)((uint32_t)t0 - (uint32_t)off_d +
                                        (uint32_t)lo_d - (uint32_t)sb);
          const int32_t delta = ((raw % SRC) + SRC) % SRC;
          rv[q] = V == NOROLL
                      ? (int32_t)((uint32_t)slab[u] + (uint32_t)delta)
                      : slab[(u + delta) & (SRC - 1)];
          sv[q] = sid_d;
        }
      }
      if (t >= total) rv[q] = sv[q] = -1;
    }
    const int64_t at = t0 + threadIdx.x * ITEMS;
    *reinterpret_cast<int4*>(r_out + at) = make_int4(rv[0], rv[1], rv[2], rv[3]);
    *reinterpret_cast<int4*>(s_out + at) = make_int4(sv[0], sv[1], sv[2], sv[3]);
  }
}

}  // namespace

// Caller guarantees: 1 <= nonzero; for every step i < steps,
// 0 <= meta_base[i] <= nonzero - 1, meta_base[i] + META <= len(off) (and
// lo, sid), 0 <= src_base[i], src_base[i] + SRC <= len(src); the offsets
// in each slab ascending; outputs 16-byte aligned with steps * BATCH *
// TILE < 2^31 slots.
extern "C" int tj_run_variant(const int32_t* off, const int32_t* lo,
                              const int32_t* sid, const int32_t* src,
                              const int32_t* meta_base,
                              const int32_t* src_base, int64_t steps,
                              int64_t nonzero, int64_t total, int64_t variant,
                              int32_t* r_out, int32_t* s_out,
                              cudaStream_t stream) {
  if (steps <= 0) return 0;
  const unsigned grid = (unsigned)steps;
#define TJ_LAUNCH(V)                                                     \
  run_variant_kernel<V><<<grid, THREADS, 0, stream>>>(                   \
      off, lo, sid, src, meta_base, src_base, nonzero, total, r_out, s_out)
  switch (variant) {
    case FULL: TJ_LAUNCH(FULL); break;
    case NOROLL: TJ_LAUNCH(NOROLL); break;
    case NOSCALAR: TJ_LAUNCH(NOSCALAR); break;
    case NORANK: TJ_LAUNCH(NORANK); break;
    case EMPTY: TJ_LAUNCH(EMPTY); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TJ_LAUNCH
  return (int)cudaGetLastError();
}
