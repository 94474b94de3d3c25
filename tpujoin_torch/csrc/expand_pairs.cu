// K5 and K7: pair expansion from the factorized (RLE) join result straight
// into the (build id, probe id) pair columns.
//
//   expand_fill_kernel  slot t in run r and group g ->
//                       (src[glo[g] + (t - goff[g]) mod gnb[g]], rsid[r])
//   expand_runs_kernel  slot t in run r -> (src[lo[r] + t - offs[r]], sid[r])
//
// Both write -1 to both columns at t >= total.
//
// Replaces tpujoin/kernels/expand_fill.py: `expand_fill` (`_kernel`),
// tpujoin/kernels/expand_groups.py: `expand_groups` (`_kernel`; the same
// function as expand_fill, so it launches expand_fill_kernel),
// tpujoin/kernels/expand_runs.py: `expand_runs` (`_kernel`), and
// exp/fill_variants.py: `expand_fill_v` (`_kernel_v`, the phase ablation
// of expand_fill: expand_fill_kernel templated on the phases that run).
//
// What bounds them on the H100: the bytes written, 8 B per slot (8 GB for
// the ~1e9 slots of the high-selectivity join, ~2.4 ms at 3.35 TB/s). The
// run and group metadata and the source ids read are ~0.1 GB there.
//
// What the simple design does about it: each thread owns ITEMS consecutive
// slots and writes them with one 16-byte store per column. Slots are
// ascending and the offsets non-decreasing, so a block first finds the runs
// (and groups) of its first and last real slot, and each thread then runs
// upper_bound - 1 over that short window only, as K4 does. The TPU
// kernels' marker scatter and doubling forward fill, periodic images,
// flat rolls, SMEM/DMA slabs and fit envelope stood in for a gather; here
// the source id is one load. A source index outside [0, n) reads -1, as
// the TPU kernels' -1 padding of the source does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                    // slots per thread
constexpr int SLOTS = THREADS * ITEMS;      // slots per block

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

// What expand_fill_kernel computes of the build column.
enum GroupPhase { GROUPS_NONE = 0, GROUPS_INDEX = 1, GROUPS_GATHER = 2 };

// RUNS: the run search and the probe column (else -1); GROUPS: what of the
// build column runs (GROUPS_GATHER is K5). Each block takes `per_block`
// slots, SLOTS at a time.
template <bool RUNS, int GROUPS>
__global__ void __launch_bounds__(THREADS)
expand_fill_kernel(const int32_t* __restrict__ roff,
                   const int32_t* __restrict__ rsid, int64_t nruns,
                   const int32_t* __restrict__ goff,
                   const int32_t* __restrict__ glo,
                   const int32_t* __restrict__ gnb, int64_t ngroups,
                   const int32_t* __restrict__ src, int64_t n, int64_t total,
                   int32_t* __restrict__ r_out, int32_t* __restrict__ s_out,
                   int64_t capacity, int64_t per_block) {
  // [run window lo, hi), [group window lo, hi) of the SLOTS real slots
  __shared__ int64_t window[4];
  const int64_t block_end = min((int64_t)(blockIdx.x + 1) * per_block,
                                capacity);
  for (int64_t first = (int64_t)blockIdx.x * per_block; first < block_end;
       first += SLOTS) {
    const int64_t last = min(first + SLOTS, total) - 1;
    if (first <= last) {
      if (RUNS && threadIdx.x == 0)
        window[0] = tj::upper_bound(roff, 0, nruns, (int32_t)first);
      if (RUNS && threadIdx.x == 32)
        window[1] = tj::upper_bound(roff, 0, nruns, (int32_t)last);
      if (GROUPS && threadIdx.x == 64)
        window[2] = tj::upper_bound(goff, 0, ngroups, (int32_t)first);
      if (GROUPS && threadIdx.x == 96)
        window[3] = tj::upper_bound(goff, 0, ngroups, (int32_t)last);
    }
    __syncthreads();
    const int64_t t0 = first + (int64_t)threadIdx.x * ITEMS;
    if (t0 < block_end) {
      int32_t rv[ITEMS], sv[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int64_t t = t0 + i;
        rv[i] = sv[i] = -1;
        if (t > last) continue;
        const int32_t ti = (int32_t)t;
        if (RUNS) {
          const int64_t r = tj::upper_bound(roff, window[0], window[1], ti) - 1;
          if (r >= 0) sv[i] = rsid[r];
        }
        if (!GROUPS || ngroups <= 0) continue;
        const int64_t g = max(
            tj::upper_bound(goff, window[2], window[3], ti) - 1, (int64_t)0);
        const int32_t nb = max(gnb[g], 1);
        const int64_t d = t - goff[g];
        // (t - goff) mod nb, canonical; d < 0 only before the first group
        const int64_t phase = d >= 0 ? (int64_t)((uint32_t)d % (uint32_t)nb)
                                     : (nb - 1) - ((-d - 1) % nb);
        rv[i] = GROUPS == GROUPS_GATHER
                    ? take_or_neg(src, n, (int64_t)glo[g] + phase)
                    : (int32_t)((int64_t)glo[g] + phase);
      }
      store(r_out, s_out, t0, capacity, rv, sv);
    }
    __syncthreads();   // the window is rewritten for the next SLOTS
  }
}

__global__ void __launch_bounds__(THREADS)
expand_runs_kernel(const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ lo,
                   const int32_t* __restrict__ sid, int64_t k,
                   const int32_t* __restrict__ src, int64_t n, int64_t total,
                   int32_t* __restrict__ r_out, int32_t* __restrict__ s_out,
                   int64_t capacity) {
  __shared__ int64_t window[2];
  const int64_t first = (int64_t)blockIdx.x * SLOTS;
  const int64_t last = min(first + SLOTS, total) - 1;
  if (first <= last) {
    if (threadIdx.x == 0)
      window[0] = tj::upper_bound(offs, 0, k, (int32_t)first);
    if (threadIdx.x == 32)
      window[1] = tj::upper_bound(offs, 0, k, (int32_t)last);
  }
  __syncthreads();
  const int64_t t0 = first + (int64_t)threadIdx.x * ITEMS;
  if (t0 >= capacity) return;
  int32_t rv[ITEMS], sv[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t t = t0 + i;
    rv[i] = sv[i] = -1;
    if (t > last || k <= 0) continue;
    int64_t r = tj::upper_bound(offs, window[0], window[1], (int32_t)t) - 1;
    r = min(max(r, (int64_t)0), k - 1);
    rv[i] = take_or_neg(src, n, (int64_t)lo[r] + (t - offs[r]));
    sv[i] = sid[r];
  }
  store(r_out, s_out, t0, capacity, rv, sv);
}

int64_t blocks_for(int64_t capacity) { return (capacity + SLOTS - 1) / SLOTS; }

}  // namespace

// Caller guarantees: 0 <= nruns <= len(roff), 0 <= ngroups <= len(goff),
// 0 <= total < 2^31, outputs 16-byte aligned with capacity slots.
extern "C" int tj_expand_fill(const int32_t* roff, const int32_t* rsid,
                              int64_t nruns, const int32_t* goff,
                              const int32_t* glo, const int32_t* gnb,
                              int64_t ngroups, const int32_t* src, int64_t n,
                              int64_t total, int32_t* r_out, int32_t* s_out,
                              int64_t capacity, cudaStream_t stream) {
  if (capacity <= 0) return 0;
  expand_fill_kernel<true, GROUPS_GATHER>
      <<<(unsigned)blocks_for(capacity), THREADS, 0, stream>>>(
          roff, rsid, nruns, goff, glo, gnb, ngroups, src, n, total, r_out,
          s_out, capacity, SLOTS);
  return (int)cudaGetLastError();
}

// expand_fill_v: K5's kernel with `step` slots a block and the phases of
// `variant`: 0 all (full), 1 no run search (no_fill: s = -1), 2 no group
// search and no gather (no_groups: r = -1), 3 the group search and modulo
// without the gather (no_double: r = glo[g] + phase). Caller guarantees
// as tj_expand_fill, and step a positive multiple of SLOTS.
extern "C" int tj_expand_fill_v(const int32_t* roff, const int32_t* rsid,
                                int64_t nruns, const int32_t* goff,
                                const int32_t* glo, const int32_t* gnb,
                                int64_t ngroups, const int32_t* src,
                                int64_t n, int64_t total, int32_t* r_out,
                                int32_t* s_out, int64_t capacity,
                                int64_t step, int64_t variant,
                                cudaStream_t stream) {
  if (capacity <= 0) return 0;
  if (step <= 0 || step % SLOTS != 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((capacity + step - 1) / step);
#define TJ_LAUNCH(RUNS, GROUPS)                                            \
  expand_fill_kernel<RUNS, GROUPS><<<grid, THREADS, 0, stream>>>(          \
      roff, rsid, nruns, goff, glo, gnb, ngroups, src, n, total, r_out,    \
      s_out, capacity, step)
  switch (variant) {
    case 0: TJ_LAUNCH(true, GROUPS_GATHER); break;
    case 1: TJ_LAUNCH(false, GROUPS_GATHER); break;
    case 2: TJ_LAUNCH(true, GROUPS_NONE); break;
    case 3: TJ_LAUNCH(true, GROUPS_INDEX); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TJ_LAUNCH
  return (int)cudaGetLastError();
}

// Caller guarantees: 0 <= k <= len(offs), 0 <= total < 2^31, outputs
// 16-byte aligned with capacity slots.
extern "C" int tj_expand_runs(const int32_t* offs, const int32_t* lo,
                              const int32_t* sid, int64_t k,
                              const int32_t* src, int64_t n, int64_t total,
                              int32_t* r_out, int32_t* s_out, int64_t capacity,
                              cudaStream_t stream) {
  if (capacity <= 0) return 0;
  expand_runs_kernel<<<(unsigned)blocks_for(capacity), THREADS, 0, stream>>>(
      offs, lo, sid, k, src, n, total, r_out, s_out, capacity);
  return (int)cudaGetLastError();
}
