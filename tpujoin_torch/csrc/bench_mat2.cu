// The two kernels of the materialization probes (exp/bench_mat2.py):
//   carry_scan  the inclusive prefix sum of i32 mod 2^32;
//   shift_loop  the per-1024-tile shift-select loop that models the cost
//               of a data-dependent shift.
//
// Replaces exp/bench_mat2.py: `pallas_scan` (`_scan_kernel`) and `rollloop`
// (`_rollloop_kernel`).
//
// carry_scan. What bounds it on the H100: bytes, 4 B read and 4 B written a
// row (8.59 GB at the probe's 2^30 rows, 2.564 ms at 3.35 TB/s); a
// reduce-then-scan in three passes would read the input twice, 12 B a row.
// What the design does about it: one pass with a decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), the Hopper form of the TPU kernel's carry passed from
// grid step to grid step (`carry_ref`):
//   - a block takes its tile from an atomic ticket, not from blockIdx.x, so
//     every tile it waits on belongs to a block that is already running;
//   - it loads its SCAN_TILE (8192) rows coalesced into shared memory
//     (padded one word in 32 against bank conflicts), each thread sums
//     SCAN_ITEMS consecutive rows, a __shfl_up_sync scan covers the warp
//     and warp 0 scans the warp totals;
//   - it publishes (flag, value) as one 64-bit status word per tile: first
//     its aggregate, then, once known, its inclusive prefix;
//   - warp 0 looks back over the predecessors 32 at a time with volatile
//     loads, adding aggregates until it meets an inclusive prefix;
//   - the rows go back out coalesced through shared memory.
// The status words and the ticket are zeroed on the launch's stream before
// every launch. All sums are unsigned, so wrapping is defined; row offsets
// are 64-bit. The TPU kernel needed n to be a multiple of its 65,536-row
// block; here the last tile may be ragged and n may be 0.
//
// shift_loop. Within each SHIFT_TILE tile, for d in [0, rolls):
// acc[l] = l >= d ? x[l - d] : acc[l], from acc = 0; that is
// x[max(0, l - (rolls - 1))] for rolls >= 1 and 0 for rolls = 0. The loop is
// the point of the probe, so the kernel keeps it: a block stages its tile in
// shared memory and runs the select `rolls` times, a run-time count that
// cannot fold into the closed form. What bounds it: bytes, 8 B a row
// (0.641 ms at 2^28 rows), until the shared-memory reads, 4 * rolls B a row,
// pass them (about rolls = 20 at ~33 TB/s of shared-memory bandwidth over
// the card). Each of SHIFT_THREADS threads holds SHIFT_TILE / SHIFT_THREADS
// lanes, so it has that many loads in flight, where one lane a thread
// (1024 threads a tile) would keep only one.
#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 32;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SHIFT_TILE = 1024;
constexpr int SHIFT_THREADS = 256;
constexpr int SHIFT_LANES = SHIFT_TILE / SHIFT_THREADS;  // lanes a thread
constexpr unsigned FULL = 0xffffffffu;
// status word: flag in the high 32 bits, value in the low 32
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;

// the shared-memory slot of row e of a tile: one pad word every 32 rows
__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag,
                                        uint32_t value) {
  *reinterpret_cast<volatile unsigned long long*>(p) = flag | value;
  __threadfence();
}

// Exclusive prefix of `tile` (>= 1) from its predecessors' status words, by
// warp 0 (every lane returns it).
__device__ uint32_t look_back(const unsigned long long* status, int64_t tile,
                              int lane) {
  uint32_t exclusive = 0;
  for (int64_t last = tile - 1;; last -= 32) {
    const int64_t j = last - lane;
    unsigned long long word = FLAG_PREFIX;  // before tile 0: prefix 0
    if (j >= 0) {
      do {
        word = load_status(status + j);
      } while ((word >> 32) == 0);
    }
    const unsigned prefix_lanes = __ballot_sync(FULL, (word >> 32) == 2);
    uint32_t value = (uint32_t)word;
    if (prefix_lanes != 0) {
      // lanes up to the nearest predecessor that holds its prefix
      if (lane > __ffs(prefix_lanes) - 1) value = 0;
      return exclusive + __reduce_add_sync(FULL, value);
    }
    exclusive += __reduce_add_sync(FULL, value);
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
carry_scan_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                  int64_t n, unsigned long long* status,
                  unsigned int* ticket) {
  __shared__ uint32_t rows[SCAN_TILE + SCAN_TILE / 32];
  __shared__ uint32_t warp_offsets[SCAN_WARPS];
  __shared__ uint32_t tile_prefix;
  __shared__ int64_t tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int64_t base = tile * SCAN_TILE;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int e = k * SCAN_THREADS + threadIdx.x;
    rows[slot(e)] = base + e < n ? (uint32_t)__ldcs(x + base + e) : 0u;
  }
  __syncthreads();

  uint32_t incl[SCAN_ITEMS];
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    sum += rows[slot(threadIdx.x * SCAN_ITEMS + j)];
    incl[j] = sum;
  }
  uint32_t warp_incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, warp_incl, d);
    if (lane >= d) warp_incl += t;
  }
  if (lane == 31) warp_offsets[warp] = warp_incl;
  __syncthreads();

  if (warp == 0) {
    const uint32_t w = lane < SCAN_WARPS ? warp_offsets[lane] : 0u;
    uint32_t w_incl = w;
#pragma unroll
    for (int d = 1; d < SCAN_WARPS; d <<= 1) {
      const uint32_t t = __shfl_up_sync(FULL, w_incl, d);
      if (lane >= d) w_incl += t;
    }
    if (lane < SCAN_WARPS) warp_offsets[lane] = w_incl - w;
    const uint32_t aggregate = __shfl_sync(FULL, w_incl, SCAN_WARPS - 1);
    uint32_t exclusive = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, FLAG_PREFIX, aggregate);
    } else {
      if (lane == 0) publish(status + tile, FLAG_AGGREGATE, aggregate);
      exclusive = look_back(status, tile, lane);
      if (lane == 0)
        publish(status + tile, FLAG_PREFIX, exclusive + aggregate);
    }
    if (lane == 0) tile_prefix = exclusive;
  }
  __syncthreads();

  const uint32_t offset = tile_prefix + warp_offsets[warp] + warp_incl - sum;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j)
    rows[slot(threadIdx.x * SCAN_ITEMS + j)] = incl[j] + offset;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int e = k * SCAN_THREADS + threadIdx.x;
    if (base + e < n) __stcs(y + base + e, (int32_t)rows[slot(e)]);
  }
}

__global__ void __launch_bounds__(SHIFT_THREADS)
shift_loop_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int64_t rolls) {
  __shared__ int32_t tile[SHIFT_TILE];
  const int64_t base = (int64_t)blockIdx.x * SHIFT_TILE;
#pragma unroll
  for (int k = 0; k < SHIFT_LANES; ++k) {
    const int l = k * SHIFT_THREADS + threadIdx.x;
    tile[l] = __ldcs(x + base + l);
  }
  __syncthreads();
  int32_t acc[SHIFT_LANES] = {};
  for (int64_t d = 0; d < rolls; ++d) {
#pragma unroll
    for (int k = 0; k < SHIFT_LANES; ++k) {
      const int l = k * SHIFT_THREADS + threadIdx.x;
      acc[k] = l >= d ? tile[l - d] : acc[k];
    }
  }
#pragma unroll
  for (int k = 0; k < SHIFT_LANES; ++k)
    __stcs(out + base + k * SHIFT_THREADS + threadIdx.x, acc[k]);
}

}  // namespace

extern "C" {

// scratch: scratch_words >= cdiv(n, SCAN_TILE) + 1 64-bit words, zeroed
// here on `stream` (the tiles' status words, then the ticket).
int tj_carry_scan(const int32_t* x, int32_t* y, int64_t n,
                  unsigned long long* scratch, int64_t scratch_words,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (scratch_words < tiles + 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (tiles + 1) * 8, stream);
  if (err != cudaSuccess) return (int)err;
  carry_scan_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>(
      x, y, n, scratch, reinterpret_cast<unsigned int*>(scratch + tiles));
  return (int)cudaGetLastError();
}

// n: a multiple of SHIFT_TILE; rolls >= 0.
int tj_shift_loop(const int32_t* x, int32_t* out, int64_t n, int64_t rolls,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n % SHIFT_TILE != 0 || rolls < 0) return (int)cudaErrorInvalidValue;
  shift_loop_kernel<<<(unsigned)(n / SHIFT_TILE), SHIFT_THREADS, 0, stream>>>(
      x, out, rolls);
  return (int)cudaGetLastError();
}

}  // extern "C"
