// run_variant: the phase ablation of K7 expand_runs for Hopper. Each
// variant keeps some of the kernel's phases and drops the others, so that
// their times attribute expand_runs' cost:
//
//   full      rank search + run walk + metadata reads + the gather of the
//             source slab
//   noroll    as full, the gather replaced by src[sb + u] + delta
//   noscalar  no walk and no metadata reads: run d of a tile has offset
//             t0 + d, build start 7d and probe id d
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
// offsets are sorted, so that d is where a walk over the sorted offsets
// stands.
//
// What bounds it on the H100: the 8 B written a slot (0.8 GB at the
// probe's 100M slots, ~0.24 ms at 3.35 TB/s); the run metadata and the
// source are read once in ~60 MB. The first design staged each step's
// whole META window (3 x 8 KB) and SRC slab (16 KB) in shared memory, ran
// two 12-step binary searches a tile on every thread and one search a
// slot: issue-bound at 0.922 ms (full), 0.473 with only the searches and
// the stores (empty), on an NVIDIA H100 80GB HBM3, 700.00 W.
//
// Design: one block a STEP, one warp a tile, nothing staged.
//   - The rank search runs once a tile, on its warp: a ballot of t0 and of
//     t0 + TILE against 32 offsets SPREAD apart finds the 64-offset group
//     that holds each boundary, and two ballots of that group count it
//     exactly. Two dependent loads, the same r0 and r1 on every lane.
//   - Each lane owns ITEMS consecutive slots of each CHUNK-slot chunk, so
//     a warp's stores are coalesced 16-byte stores. The lane finds its
//     first slot's run by a gallop from where its previous chunk ended
//     (from r0 in the first), one load when no run starts in between, then
//     walks: the run steps when a slot reaches the next offset, never past
//     r1, so equal offsets end on the last of them and slots before the
//     first offset keep d < 0. A run's lo and probe id are read when the
//     walk reaches it, and delta is computed then.
//   - The metadata and the source are read straight from global memory
//     through L1: a tile touches a few runs and one source span, so no
//     block-wide copy, barrier or shared memory is needed. The gather is
//     coalesced along a run.
//   - Indices are 32-bit: the caller bounds the slots below 2^31 and each
//     step reads inside its META and SRC windows; raw keeps its i32 wrap.
// The variants drop their phase of this design: norank the ballots,
// noscalar the walk and the metadata, noroll the wrapped gather, empty all
// but the ballots and the stores. Full takes 0.324 ms and empty 0.271 at
// 100M slots (NVIDIA H100 80GB HBM3, 700.00 W).
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int BATCH = 8;
constexpr int META = 2048;
constexpr int SRC = 4096;
constexpr int THREADS = 32 * BATCH;       // one warp a tile of the step
constexpr int ITEMS = 4;                  // consecutive slots a lane a chunk
constexpr int CHUNK = 32 * ITEMS;         // slots a warp stores at a time
constexpr int SPREAD = META / 32;         // offsets between the first ballot's
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE % CHUNK == 0 && META == 32 * SPREAD && SPREAD == 64,
              "a tile is whole chunks; a group is two ballots");

enum Variant { FULL_RUN = 0, NOROLL = 1, NOSCALAR = 2, NORANK = 3, EMPTY = 4 };

// #(a <= x) over the ascending a[0, META), on every lane of the warp: the
// group of SPREAD offsets that holds the boundary, then its two halves.
// With a[0] > x the group is the first and counts 0.
__device__ __forceinline__ int count_within(const int32_t* __restrict__ a,
                                            unsigned groups, int32_t x,
                                            int lane) {
  const int base = SPREAD * max(__popc(groups) - 1, 0);
  return base + __popc(__ballot_sync(FULL, __ldg(a + base + lane) <= x)) +
         __popc(__ballot_sync(FULL, __ldg(a + base + 32 + lane) <= x));
}

template <int V>
__global__ void __launch_bounds__(THREADS)
run_variant_kernel(const int32_t* __restrict__ off,
                   const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ sid,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ meta_base,
                   const int32_t* __restrict__ src_base, int64_t nonzero,
                   int total, int32_t* __restrict__ r_out,
                   int32_t* __restrict__ s_out) {
  const int step = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int t0 = (step * BATCH + (int)(threadIdx.x >> 5)) * TILE;
  const int mb = __ldg(meta_base + step);
  const int32_t sb = __ldg(src_base + step);
  const int32_t* __restrict__ w_off = off + mb;
  const int32_t* __restrict__ w_lo = lo + mb;
  const int32_t* __restrict__ w_sid = sid + mb;
  const int32_t* __restrict__ slab = src + sb;
  const int rel_max = (int)min(nonzero - 1 - mb, (int64_t)META - 1);

  int r0, r1;
  if (V == NORANK) {
    r0 = 0;
    r1 = min(rel_max, 12);
  } else {
    // t0 + TILE < 2^31: the caller bounds the slots
    const int32_t a = __ldg(w_off + SPREAD * lane);
    const int c0 = count_within(w_off, __ballot_sync(FULL, a <= t0), t0,
                                lane);
    const int c1 = count_within(w_off, __ballot_sync(FULL, a < t0 + TILE),
                                t0 + TILE - 1, lane);
    r0 = min(max(c0 - 1, 0), rel_max);
    r1 = min(max(c1 - 1, r0), rel_max);
  }
  const int span = r1 - r0;               // D: runs r0..r1 of the window

  int j = r0 - 1;                         // the run of the lane's last slot
  for (int u = lane * ITEMS; u < TILE; u += CHUNK) {
    const int t = t0 + u;
    int32_t rv[ITEMS], sv[ITEMS];
    if (t >= total) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) rv[q] = sv[q] = -1;
    } else if (V == EMPTY) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) rv[q] = sv[q] = span * (span + 1) / 2;
    } else if (V == NOSCALAR) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        const int d = min(u + q, span);
        // raw = t0 - (t0 + d) + 7d - sb
        const int32_t delta =
            (int32_t)((uint32_t)(6 * d) - (uint32_t)sb) & (SRC - 1);
        rv[q] = __ldg(slab + ((u + q + delta) & (SRC - 1)));
        sv[q] = d;
      }
    } else {
      // every offset in [r0, j] is <= t; the run of slot t is the last
      // offset <= t up to r1
      j = tj::gallop<true, int>(w_off, j + 1, r1 + 1, t) - 1;
      int32_t next = j < r1 ? __ldg(w_off + j + 1) : INT32_MAX;
      int32_t delta = 0, sid_j = 0;
      if (j >= r0) {
        delta = (int32_t)((uint32_t)t0 - (uint32_t)__ldg(w_off + j) +
                          (uint32_t)__ldg(w_lo + j) - (uint32_t)sb) &
                (SRC - 1);
        sid_j = __ldg(w_sid + j);
      }
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        // t + q < 2^31 - 1, so the sentinel is never reached
        while (t + q >= next) {           // once per run reached
          const int32_t off_j = next;
          ++j;
          next = j < r1 ? __ldg(w_off + j + 1) : INT32_MAX;
          delta = (int32_t)((uint32_t)t0 - (uint32_t)off_j +
                            (uint32_t)__ldg(w_lo + j) - (uint32_t)sb) &
                  (SRC - 1);
          sid_j = __ldg(w_sid + j);
        }
        rv[q] = sv[q] = 0;
        if (j >= r0) {
          rv[q] = V == NOROLL
                      ? (int32_t)((uint32_t)__ldg(slab + u + q) +
                                  (uint32_t)delta)
                      : __ldg(slab + ((u + q + delta) & (SRC - 1)));
          sv[q] = sid_j;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (t + q >= total) rv[q] = sv[q] = -1;
    *reinterpret_cast<int4*>(r_out + t) = make_int4(rv[0], rv[1], rv[2], rv[3]);
    *reinterpret_cast<int4*>(s_out + t) = make_int4(sv[0], sv[1], sv[2], sv[3]);
  }
}

}  // namespace

// Caller guarantees: 1 <= nonzero; 0 <= total < 2^31; for every step
// i < steps, 0 <= meta_base[i] <= nonzero - 1, meta_base[i] + META <=
// len(off) (and lo, sid), 0 <= src_base[i], src_base[i] + SRC <= len(src);
// the offsets in each window ascending; outputs 16-byte aligned with
// steps * BATCH * TILE < 2^31 slots.
extern "C" int tj_run_variant(const int32_t* off, const int32_t* lo,
                              const int32_t* sid, const int32_t* src,
                              const int32_t* meta_base,
                              const int32_t* src_base, int64_t steps,
                              int64_t nonzero, int64_t total, int64_t variant,
                              int32_t* r_out, int32_t* s_out,
                              cudaStream_t stream) {
  if (steps <= 0) return 0;
  if (steps > (INT32_MAX / (BATCH * TILE)) || total < 0 || total > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)steps;
#define TJ_LAUNCH(V)                                                     \
  run_variant_kernel<V><<<grid, THREADS, 0, stream>>>(                   \
      off, lo, sid, src, meta_base, src_base, nonzero, (int)total, r_out, \
      s_out)
  switch (variant) {
    case FULL_RUN: TJ_LAUNCH(FULL_RUN); break;
    case NOROLL: TJ_LAUNCH(NOROLL); break;
    case NOSCALAR: TJ_LAUNCH(NOSCALAR); break;
    case NORANK: TJ_LAUNCH(NORANK); break;
    case EMPTY: TJ_LAUNCH(EMPTY); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TJ_LAUNCH
  return (int)cudaGetLastError();
}
