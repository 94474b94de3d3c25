// fill_forward: the forward fill of a marker column, the probe column of
// the marker-scatter design (exp/probe_fill.py). out[t] is the last marker
// mark[t'] >= 0 with t' <= t, or -1 before the first.
//
// Replaces exp/probe_fill.py: `fill_forward` (`_fill_kernel`). The TPU
// kernel forward-fills each STEP-slot block with log2(STEP) doubling rolls
// and carries the last value from grid step to grid step in SMEM.
//
// What bounds it on the H100: bytes, 4 B read and 4 B written a slot
// (8.4 GB at the probe's 1,048,576,000 slots, ~2.5 ms at 3.35 TB/s).
//
// Design: a single-pass scan with a decoupled look-back (lookback.cuh),
// the operator "the later marker wins", whose tile is the TPU kernel's
// STEP:
//   - a block takes its tile from an atomic ticket, as carry_scan does;
//   - the tile's aggregate is its last marker, found by reading the tile
//     backwards 1024 slots at a time, one 16-byte load a thread, until a
//     1024-slot piece holds a marker: one piece for a column with markers
//     a few hundred slots apart. A tile whose aggregate is a marker
//     publishes it at once as its inclusive prefix (a marker absorbs what
//     came before), else as its aggregate;
//   - warp 0 looks back, stopping at the nearest predecessor that holds a
//     marker or its prefix;
//   - the tile is then filled SUB (8192) slots at a time: coalesced loads
//     into shared memory (padded one word in 32), each thread fills its 32
//     consecutive slots, a shuffle scan of the threads' last markers covers
//     the warp, the warps' totals and the carry cover the block, and the
//     slots go back out coalesced.
// The operator is not commutative: every scan keeps the earlier value on
// the left. A tile without a marker passes the value before it on, and
// slots before the first marker stay -1.
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 32;                   // slots a thread a pass
constexpr int SUB = THREADS * ITEMS;        // slots a pass
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = THREADS * 4;          // slots a step of the search
using Op = tj::LastMarkerOp;

__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

__device__ __forceinline__ int32_t later(int32_t a, int32_t b) {
  return b >= 0 ? b : a;
}

__global__ void __launch_bounds__(THREADS)
fill_forward_kernel(const int32_t* __restrict__ mark,
                    int32_t* __restrict__ out, int64_t step,
                    unsigned long long* status, unsigned int* ticket) {
  __shared__ int32_t rows[SUB + SUB / 32];
  __shared__ int32_t warp_vals[WARPS];
  __shared__ int32_t tile_in;
  __shared__ int64_t tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t base = tile * step;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // the tile's last marker, from its end
  int32_t aggregate = -1;
  for (int64_t end = step; end > 0 && aggregate < 0; end -= PIECE) {
    const int4 v = *reinterpret_cast<const int4*>(
        mark + base + end - PIECE + threadIdx.x * 4);
    const int32_t mine = later(later(later(v.x, v.y), v.z), v.w);
    const unsigned lanes = __ballot_sync(tj::FULL_MASK, mine >= 0);
    const int32_t w = lanes ? __shfl_sync(tj::FULL_MASK, mine,
                                          31 - __clz((int)lanes))
                            : -1;
    __syncthreads();            // warp_vals of the previous piece are read
    if (lane == 0) warp_vals[warp] = w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WARPS; ++k) aggregate = later(aggregate, warp_vals[k]);
  }

  if (warp == 0) {
    uint32_t in = Op::identity();
    if (tile == 0) {
      if (lane == 0) tj::publish(status, tj::FLAG_PREFIX, (uint32_t)aggregate);
    } else {
      if (lane == 0)
        tj::publish(status + tile,
                    aggregate >= 0 ? tj::FLAG_PREFIX : tj::FLAG_AGGREGATE,
                    (uint32_t)aggregate);
      in = tj::look_back<Op>(status, tile, lane);
      if (lane == 0 && aggregate < 0)
        tj::publish(status + tile, tj::FLAG_PREFIX, in);
    }
    if (lane == 0) tile_in = (int32_t)in;
  }
  __syncthreads();

  int32_t carry = tile_in;
  for (int64_t s0 = 0; s0 < step; s0 += SUB) {
    const int64_t at = base + s0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = k * THREADS + threadIdx.x;
      rows[slot(e)] = __ldcs(mark + at + e);
    }
    __syncthreads();
    int32_t incl[ITEMS];
    int32_t run = -1;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      run = later(run, rows[slot(threadIdx.x * ITEMS + j)]);
      incl[j] = run;
    }
    int32_t w = run;            // inclusive over lanes 0..lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t t = __shfl_up_sync(tj::FULL_MASK, w, d);
      if (lane >= d) w = later(t, w);
    }
    int32_t w_excl = __shfl_up_sync(tj::FULL_MASK, w, 1);
    if (lane == 0) w_excl = -1;
    if (lane == 31) warp_vals[warp] = w;
    __syncthreads();
    int32_t before = carry, pass = carry;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      if (k < warp) before = later(before, warp_vals[k]);
      pass = later(pass, warp_vals[k]);
    }
    const int32_t in = later(before, w_excl);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      rows[slot(threadIdx.x * ITEMS + j)] = incl[j] >= 0 ? incl[j] : in;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = k * THREADS + threadIdx.x;
      __stcs(out + at + e, rows[slot(e)]);
    }
    carry = pass;
    __syncthreads();            // rows and warp_vals are free again
  }
}

}  // namespace

// n: a multiple of step; step: a positive multiple of SUB; mark and out
// 16-byte aligned. scratch: scratch_words >= n / step + 1 64-bit words,
// zeroed here on `stream` (the tiles' status words, then the ticket).
extern "C" int tj_fill_forward(const int32_t* mark, int32_t* out, int64_t n,
                               int64_t step, unsigned long long* scratch,
                               int64_t scratch_words, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (step <= 0 || step % SUB != 0 || n % step != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = n / step;
  if (scratch_words < tiles + 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (tiles + 1) * 8, stream);
  if (err != cudaSuccess) return (int)err;
  fill_forward_kernel<<<(unsigned)tiles, THREADS, 0, stream>>>(
      mark, out, step, scratch, reinterpret_cast<unsigned int*>(scratch + tiles));
  return (int)cudaGetLastError();
}
