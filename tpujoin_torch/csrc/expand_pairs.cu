// K4, K5 and K7: pair expansion from the factorized (RLE) join result
// into the (build position or id, probe id) pair columns.
//
//   expand_fill_kernel  slot t in run r and group g ->
//                       (src[glo[g] + (t - goff[g]) mod gnb[g]], rsid[r])
//                       (K5), or in a run mode, slot t in row r ->
//                       (lo[r] + t - offs[r], sid[r]) (K4, RUNS_POS) or
//                       (src[lo[r] + t - offs[r]], sid[r]) (K7b, RUNS_GATHER)
//
// K5 and K7b write -1 to both columns at t >= total. K4 has no total: a
// slot at or past the last row's offset takes the last row, as
// upper_bound - 1 clamped to the rows gives it.
//
// Replaces tpujoin/kernels/expand.py: `expand` (`_kernel`, K4),
// tpujoin/kernels/expand_fill.py: `expand_fill` (`_kernel`),
// tpujoin/kernels/expand_groups.py: `expand_groups` (`_kernel`; the same
// function as expand_fill, so it launches expand_fill_kernel),
// tpujoin/kernels/expand_runs.py: `expand_runs` (`_kernel`, K7b), and
// exp/fill_variants.py: `expand_fill_v` (`_kernel_v`, the phase ablation
// of expand_fill: expand_fill_kernel templated on the phases that run).
//
// What bounds them on the H100: the bytes written, 8 B per slot (8 GB for
// the ~1e9 slots of the high-selectivity join, ~2.4 ms at 3.35 TB/s). The
// run and group metadata and the source ids read are ~0.1 GB there. K4's
// slots are the low-selectivity join's pairs (~1e7, 0.08 GB written).
//
// K5 is two launches. A partition pass, one thread per tile boundary,
// finds each TILE-slot tile's first run and first group by a binary search
// of the whole offset columns: all the searches run at once, so their
// dependent loads overlap. In the fill kernel a block takes BLOCK_TILES
// consecutive tiles in turn and copies each tile's runs and groups into
// shared memory. The first nruns run offsets are strictly increasing, so
// every run holds a slot and a tile meets at most TILE + 1 runs; groups
// likewise. The window is sized for that bound: no envelope, no second
// path. Each thread owns ITEMS consecutive slots, finds its first
// slot's group and run by a search of the window, then walks: the group
// steps when the slot reaches the next group's offset, the run likewise,
// and the phase (t - goff) mod gnb is divided once and then steps by one,
// wrapping at gnb. The group walk comes first, so its loads are in flight
// during the run walk. Each thread writes one 16-byte store per column
// per 4 slots. The source id is one load, a group's slice staying in L1
// or L2. The TPU kernels' marker scatter and
// doubling forward fill, periodic images, flat rolls, SMEM/DMA slabs and
// fit envelope stood in for that gather. A source index outside [0, n)
// reads -1, as the TPU kernels' -1 padding of the source does.
//
// K4 is the same two launches in the run mode (RUNS_POS): the window holds
// each row's offset, probe id and lo - offset, and the walk writes
// lo - offset + t beside the probe id; no groups. Its rows are compact3's:
// strictly increasing offsets below the total, then a zero tail (offset ==
// total, lo == sid == 0) that can be longer than a tile. Only the slots
// below the last row's offset are walked, so the tail never enters a
// window; the slots from it on take the last row directly. One tile a
// block: K4's slots are few (~1e7), and more blocks hide more latency. The
// TPU kernel's one-hot and masked-max reductions stood in for gathers.
//
// K7b is the same two launches in the gather mode (RUNS_GATHER): the
// window holds each run's offset, probe id and lo - offset, the last in 64
// bits, and the walk writes src[lo - offset + t] beside the probe id, the
// index taken in 64 bits (it can leave [0, n) and the i32 range). As in
// K5 the walk ends at the total and the slots past it write -1; slots
// before the first run's offset take the first run, as upper_bound - 1
// clamped to the runs gives it. One tile a block, as K4: on the dense
// state and on one-slot runs it beat K5's BLOCK_TILES (PERF.md §6).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                    // consecutive slots per thread
constexpr int SLOTS = THREADS * ITEMS;      // slots per block at a time
constexpr int TILE = 2048;                  // slots of one K5 window
constexpr int BLOCK_TILES = 16;             // tiles a K5 block takes
constexpr int RUN_BLOCK_TILES = 1;          // tiles a K4 or K7b block takes
constexpr int PART_THREADS = 256;
static_assert(TILE % SLOTS == 0, "a tile is whole sweeps of a block");

__device__ __forceinline__ int32_t take_or_neg(const int32_t* src, int64_t n,
                                               int64_t idx) {
  return (idx >= 0 && idx < n) ? src[idx] : -1;
}

// Writes ITEMS slots from t0 on, the ragged end of the columns slot by slot.
__device__ __forceinline__ void store(int32_t* __restrict__ r_out,
                                      int32_t* __restrict__ s_out, int64_t t0,
                                      int64_t capacity, const int32_t* rv,
                                      const int32_t* sv) {
  if (t0 + ITEMS <= capacity) {
    *reinterpret_cast<int4*>(r_out + t0) = make_int4(rv[0], rv[1], rv[2], rv[3]);
    *reinterpret_cast<int4*>(s_out + t0) = make_int4(sv[0], sv[1], sv[2], sv[3]);
    return;
  }
  for (int i = 0; i < ITEMS && t0 + i < capacity; ++i) {
    r_out[t0 + i] = rv[i];
    s_out[t0 + i] = sv[i];
  }
}

// First index in the shared a[0, n) with a[i] > x, in 32-bit indices.
__device__ __forceinline__ int upper_bound_smem(const int32_t* a, int n,
                                                int32_t x) {
  int lo = 0;
  while (lo < n) {
    const int mid = (lo + n) >> 1;
    if (a[mid] <= x) lo = mid + 1; else n = mid;
  }
  return lo;
}

// Entry i of `nparts`: the run and the group of slot i * tile, as
// upper_bound - 1 (the run -1 before the first run, the group clamped to
// 0). nruns or ngroups 0 skips that search.
__global__ void __launch_bounds__(PART_THREADS)
partition_kernel(const int32_t* __restrict__ roff, int64_t nruns,
                 const int32_t* __restrict__ goff, int64_t ngroups,
                 int64_t tile, int64_t nparts, int32_t* __restrict__ run_part,
                 int32_t* __restrict__ grp_part) {
  const int64_t i = (int64_t)blockIdx.x * PART_THREADS + threadIdx.x;
  if (i >= nparts) return;
  // past INT32_MAX every offset lies at or before the slot
  const int32_t t = (int32_t)min(i * tile, (int64_t)INT32_MAX);
  run_part[i] = (int32_t)(tj::upper_bound(roff, 0, nruns, t) - 1);
  grp_part[i] = (int32_t)max(tj::upper_bound(goff, 0, ngroups, t) - 1,
                             (int64_t)0);
}

// What expand_fill_kernel computes of the runs: nothing (the probe column
// -1), the probe column (K5), it and the build position (K4), or it and
// the source id at that position (K7b).
enum RunPhase { RUNS_NONE = 0, RUNS_SID = 1, RUNS_POS = 2, RUNS_GATHER = 3 };
// What it computes of the build column from the groups.
enum GroupPhase { GROUPS_NONE = 0, GROUPS_INDEX = 1, GROUPS_GATHER = 2 };

// Words of shared memory a window array takes: TILE + 1 entries and the
// sentinel after the last.
constexpr int WINDOW = TILE + 2;

// The words of a window: the runs' arrays where the run walk runs (two,
// three with the build position, four with the 64-bit one of the gather),
// the groups' three where the group walk does.
__host__ __device__ constexpr int run_words(int runs) {
  return (runs == RUNS_GATHER ? 4 : runs == RUNS_POS ? 3
          : runs == RUNS_SID  ? 2 : 0) * WINDOW;
}
__host__ __device__ constexpr int window_words(int runs, int groups) {
  return run_words(runs) + (groups ? 3 : 0) * WINDOW;
}
static_assert(window_words(RUNS_SID, GROUPS_GATHER) * 4 <= 48 * 1024 &&
                  window_words(RUNS_GATHER, GROUPS_NONE) * 4 <= 48 * 1024,
              "the window fits the default shared-memory limit");

// RUNS: what the run walk computes; GROUPS: what of the build column runs
// (RUNS_SID with GROUPS_GATHER is K5, RUNS_POS with GROUPS_NONE K4,
// RUNS_GATHER with GROUPS_NONE K7b). Each
// block takes `tiles` tiles of `tile` slots (tile divides TILE), one at a
// time; the partition has an entry for every tile boundary up to the last
// tile with a slot below the end of the walk: total, or with RUNS_POS the
// last of the `nruns` rows' offset.
template <int RUNS, int GROUPS>
__global__ void __launch_bounds__(THREADS)
expand_fill_kernel(const int32_t* __restrict__ roff,
                   const int32_t* __restrict__ rsid,
                   const int32_t* __restrict__ rlo, int64_t nruns,
                   const int32_t* __restrict__ goff,
                   const int32_t* __restrict__ glo,
                   const int32_t* __restrict__ gnb, int64_t ngroups,
                   const int32_t* __restrict__ run_part,
                   const int32_t* __restrict__ grp_part,
                   const int32_t* __restrict__ src, int64_t n, int64_t total,
                   int32_t* __restrict__ r_out, int32_t* __restrict__ s_out,
                   int64_t capacity, int64_t tiles, int tile) {
  // the window: runs (offset, probe id, with RUNS_POS lo - offset, with
  // RUNS_GATHER lo - offset in 64 bits), then groups (offset, slice start,
  // period), each entry j the j-th run or group from the tile's first
  __shared__ __align__(8) int32_t window[window_words(RUNS, GROUPS)];
  int32_t* w_roff = window;
  int32_t* w_rsid = w_roff + WINDOW;
  int32_t* w_rbase = w_rsid + WINDOW;
  int64_t* w_rbase64 = reinterpret_cast<int64_t*>(w_rbase);
  int32_t* w_goff = window + run_words(RUNS);
  int32_t* w_glo = w_goff + WINDOW;
  int32_t* w_gnb = w_glo + WINDOW;
  const bool groups = GROUPS != GROUPS_NONE && ngroups > 0;
  // the slots below `end` are walked; the others take the tail: -1, or
  // with RUNS_POS the last row
  int64_t end = total;
  uint32_t tail_base = 0;
  int32_t tail_sid = -1;
  if (RUNS == RUNS_POS) {
    end = roff[nruns - 1];
    tail_base = (uint32_t)rlo[nruns - 1] - (uint32_t)roff[nruns - 1];
    tail_sid = rsid[nruns - 1];
  }
  const int64_t block_end = min((blockIdx.x + 1) * tiles * tile, capacity);
  for (int64_t part = blockIdx.x * tiles; part * tile < block_end; ++part) {
    const int64_t first = part * tile;
    int nr = 0, ng = 0;
    if (first < end) {
      if (RUNS != RUNS_NONE) {
        const int32_t lo = run_part[part];
        nr = min(run_part[part + 1] - lo + 1, tile + 1);
        for (int j = threadIdx.x; j < nr; j += THREADS) {
          const int32_t r = lo + j;        // -1: before the first run
          w_roff[j] = r < 0 ? INT32_MIN : roff[r];
          if (RUNS == RUNS_SID) {
            w_rsid[j] = r < 0 ? -1 : rsid[r];
          } else {                         // K4, K7b clamp to the first row
            const int32_t q = max(r, 0);
            w_rsid[j] = rsid[q];
            if (RUNS == RUNS_POS)
              w_rbase[j] = (int32_t)((uint32_t)rlo[q] - (uint32_t)roff[q]);
            else
              w_rbase64[j] = (int64_t)rlo[q] - roff[q];
          }
        }
        if (threadIdx.x == 0) w_roff[nr] = INT32_MAX;
      }
      if (groups) {
        const int32_t lo = grp_part[part];
        ng = min(grp_part[part + 1] - lo + 1, tile + 1);
        for (int j = threadIdx.x; j < ng; j += THREADS) {
          w_goff[j] = goff[lo + j];
          w_glo[j] = glo[lo + j];
          w_gnb[j] = max(gnb[lo + j], 1);
        }
        if (threadIdx.x == 0) w_goff[ng] = INT32_MAX;
      }
    }
    __syncthreads();
    const int64_t tile_end = min(first + tile, block_end);
    for (int64_t t0 = first + (int64_t)threadIdx.x * ITEMS;
         t0 < tile_end; t0 += SLOTS) {
      int32_t rv[ITEMS], sv[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        rv[i] = RUNS == RUNS_POS ? (int32_t)(tail_base + (uint32_t)(t0 + i))
                                 : -1;
        sv[i] = tail_sid;
      }
      // the slots below end: t0 .. t0 + real - 1, all below 2^31
      const int real = (int)max(min((int64_t)ITEMS, end - t0), (int64_t)0);
      const int32_t s0 = (int32_t)t0;
      if (groups && real > 0) {
        int g = max(upper_bound_smem(w_goff, ng, s0) - 1, 0);
        int32_t nb = w_gnb[g], next = w_goff[g + 1];
        int64_t base = w_glo[g];
        // (t0 - goff) mod nb, canonical; d < 0 only before the first group
        const int64_t d = t0 - w_goff[g];
        int32_t phase = d >= 0 ? (int32_t)((uint32_t)d % (uint32_t)nb)
                               : (int32_t)((nb - 1) - ((-d - 1) % nb));
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (i >= real) break;
          if (s0 + i >= next) {            // a new group starts at this slot
            do { ++g; } while (s0 + i >= w_goff[g + 1]);
            nb = w_gnb[g];
            base = w_glo[g];
            next = w_goff[g + 1];
            phase = 0;
          }
          rv[i] = GROUPS == GROUPS_GATHER ? take_or_neg(src, n, base + phase)
                                          : (int32_t)(base + phase);
          phase = phase + 1 == nb ? 0 : phase + 1;
        }
      }
      if (RUNS != RUNS_NONE && real > 0) {
        // entry 0 starts at or before the tile, the sentinel after it
        int j = upper_bound_smem(w_roff, nr, s0) - 1;
        int32_t sid = w_rsid[j], next = w_roff[j + 1];
        uint32_t base = RUNS == RUNS_POS ? (uint32_t)w_rbase[j] : 0;
        int64_t base64 = RUNS == RUNS_GATHER ? w_rbase64[j] : 0;
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (i >= real) break;
          while (s0 + i >= next) {         // once per run reached
            ++j;
            sid = w_rsid[j];
            next = w_roff[j + 1];
            if (RUNS == RUNS_POS) base = (uint32_t)w_rbase[j];
            if (RUNS == RUNS_GATHER) base64 = w_rbase64[j];
          }
          sv[i] = sid;
          if (RUNS == RUNS_POS) rv[i] = (int32_t)(base + (uint32_t)(s0 + i));
          if (RUNS == RUNS_GATHER)
            rv[i] = take_or_neg(src, n, base64 + (s0 + i));
        }
      }
      store(r_out, s_out, t0, capacity, rv, sv);
    }
    __syncthreads();   // the window is rewritten for the next tile
  }
}

int gcd(int64_t a, int64_t b) {
  while (b) { const int64_t r = a % b; a = b; b = r; }
  return (int)a;
}

// The partition pass, then the fill kernel with `per_block` slots a block.
// `parts` holds two columns of `nparts` entries, the runs' then the
// groups'; it needs one entry per tile of the slots below min(total,
// capacity), and one more. With RUNS_POS the kernel reads its end of the
// walk from the rows, and total is capacity.
template <int RUNS, int GROUPS>
int launch_fill(const int32_t* roff, const int32_t* rsid,
                const int32_t* rlo, int64_t nruns, const int32_t* goff,
                const int32_t* glo, const int32_t* gnb, int64_t ngroups,
                const int32_t* src, int64_t n, int64_t total,
                int32_t* r_out, int32_t* s_out, int64_t capacity,
                int32_t* parts, int64_t nparts, int64_t per_block,
                cudaStream_t stream) {
  const int tile = gcd(per_block, TILE);
  const int64_t valid = min(total, capacity);
  const int64_t need = (valid + tile - 1) / tile + 1;
  if (nparts < need) return (int)cudaErrorInvalidValue;
  int32_t* run_part = parts;
  int32_t* grp_part = parts + nparts;
  if (valid > 0) {
    partition_kernel<<<(unsigned)((need + PART_THREADS - 1) / PART_THREADS),
                       PART_THREADS, 0, stream>>>(
        roff, RUNS != RUNS_NONE ? nruns : 0, goff, GROUPS ? ngroups : 0,
        tile, need, run_part, grp_part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((capacity + per_block - 1) / per_block);
  expand_fill_kernel<RUNS, GROUPS><<<grid, THREADS, 0, stream>>>(
      roff, rsid, rlo, nruns, goff, glo, gnb, GROUPS ? ngroups : 0, run_part,
      grp_part, src, n, total, r_out, s_out, capacity, per_block / tile,
      tile);
  return (int)cudaGetLastError();
}

}  // namespace

// Caller guarantees: 0 <= nruns <= len(roff), 0 <= ngroups <= len(goff),
// 0 <= total < 2^31, the first nruns run offsets and the first ngroups
// group offsets strictly increasing, outputs 16-byte aligned with capacity
// slots; `parts` 2 x nparts i32 scratch, nparts at least
// ceil(min(total, capacity) / TILE) + 1.
extern "C" int tj_expand_fill(const int32_t* roff, const int32_t* rsid,
                              int64_t nruns, const int32_t* goff,
                              const int32_t* glo, const int32_t* gnb,
                              int64_t ngroups, const int32_t* src, int64_t n,
                              int64_t total, int32_t* r_out, int32_t* s_out,
                              int64_t capacity, int32_t* parts,
                              int64_t nparts, cudaStream_t stream) {
  if (capacity <= 0) return 0;
  return launch_fill<RUNS_SID, GROUPS_GATHER>(
      roff, rsid, nullptr, nruns, goff, glo, gnb, ngroups, src, n, total,
      r_out, s_out, capacity, parts, nparts, BLOCK_TILES * TILE, stream);
}

// K4. Caller guarantees: 1 <= k <= len of each of offs, lo and sid, the
// offsets below offs[k - 1] strictly increasing (compact3's rows: a
// non-decreasing column that repeats only its last value), outputs 16-byte
// aligned with capacity slots, 0 <= capacity < 2^31; `parts` 2 x nparts
// i32 scratch, nparts at least ceil(capacity / TILE) + 1.
extern "C" int tj_expand(const int32_t* offs, const int32_t* lo,
                         const int32_t* sid, int64_t k, int32_t* bpos,
                         int32_t* sid_out, int64_t capacity, int32_t* parts,
                         int64_t nparts, cudaStream_t stream) {
  if (capacity <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  return launch_fill<RUNS_POS, GROUPS_NONE>(
      offs, sid, lo, k, nullptr, nullptr, nullptr, 0, nullptr, 0, capacity,
      bpos, sid_out, capacity, parts, nparts, RUN_BLOCK_TILES * TILE, stream);
}

// expand_fill_v: K5's kernels with `step` slots a block and the phases of
// `variant`: 0 all (full), 1 no run walk (no_fill: s = -1), 2 no group
// walk and no gather (no_groups: r = -1), 3 the group walk and phase
// without the gather (no_double: r = glo[g] + phase). Caller guarantees
// as tj_expand_fill, step a positive multiple of SLOTS and nparts at
// least ceil(min(total, capacity) / gcd(step, TILE)) + 1.
extern "C" int tj_expand_fill_v(const int32_t* roff, const int32_t* rsid,
                                int64_t nruns, const int32_t* goff,
                                const int32_t* glo, const int32_t* gnb,
                                int64_t ngroups, const int32_t* src,
                                int64_t n, int64_t total, int32_t* r_out,
                                int32_t* s_out, int64_t capacity,
                                int64_t step, int64_t variant,
                                int32_t* parts, int64_t nparts,
                                cudaStream_t stream) {
  if (capacity <= 0) return 0;
  if (step <= 0 || step % SLOTS != 0) return (int)cudaErrorInvalidValue;
#define TJ_LAUNCH(RUNS, GROUPS)                                            \
  return launch_fill<RUNS, GROUPS>(roff, rsid, nullptr, nruns, goff, glo, \
                                   gnb, ngroups, src, n, total, r_out,    \
                                   s_out, capacity, parts, nparts, step,  \
                                   stream)
  switch (variant) {
    case 0: TJ_LAUNCH(RUNS_SID, GROUPS_GATHER);
    case 1: TJ_LAUNCH(RUNS_NONE, GROUPS_GATHER);
    case 2: TJ_LAUNCH(RUNS_SID, GROUPS_NONE);
    case 3: TJ_LAUNCH(RUNS_SID, GROUPS_INDEX);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TJ_LAUNCH
}

// K7b. Caller guarantees: 0 <= k <= len of each of offs, lo and sid, the
// first k offsets strictly increasing, 0 <= total < 2^31, outputs 16-byte
// aligned with capacity slots; `parts` 2 x nparts i32 scratch, nparts at
// least ceil(min(total, capacity) / TILE) + 1. With no run every slot is
// -1.
extern "C" int tj_expand_runs(const int32_t* offs, const int32_t* lo,
                              const int32_t* sid, int64_t k,
                              const int32_t* src, int64_t n, int64_t total,
                              int32_t* r_out, int32_t* s_out, int64_t capacity,
                              int32_t* parts, int64_t nparts,
                              cudaStream_t stream) {
  if (capacity <= 0) return 0;
  return launch_fill<RUNS_GATHER, GROUPS_NONE>(
      offs, sid, lo, k, nullptr, nullptr, nullptr, 0, src, n,
      k > 0 ? total : 0, r_out, s_out, capacity, parts, nparts,
      RUN_BLOCK_TILES * TILE, stream);
}
