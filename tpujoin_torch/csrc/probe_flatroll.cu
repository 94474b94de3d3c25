// The kernel of the flat-roll probe (exp/probe_flatroll.py):
//   flat_roll  each 1024-element tile of an i32 column becomes
//              sum over d < rolls of tile[(f - shifts[d]) mod 1024],
//              the row-major flat roll of its (8, 128) form, adds wrapping.
//
// Replaces exp/probe_flatroll.py: `run` (`_kernel`, `flat_roll`).
//
// The roll is defined for every i32 shift: (f - k) mod 1024 is
// (f - k) & 1023 in unsigned arithmetic. The TPU kernel builds it from a
// lane roll by rem(k, 128) and row rolls by k // 128, which agree only for
// k >= 0 (floor and truncation differ below 0); this kernel gives np.roll's
// answer for every k.
//
// What bounds it on the H100: bytes, 8 B a row (0.641 ms at the probe's
// 2^28 rows, 3.35 TB/s), until the shared-memory reads, 4 * rolls B a row,
// pass them, as for shift_loop (csrc/bench_mat2.cu), whose staging this
// kernel shares (tj::stage_tile).
//
// What the design does about it: a block stages its tile in shared memory
// with coalesced streaming loads and keeps the shifts beside it; each of
// FR_THREADS threads sums, for FR_LANES outputs f, `rolls` reads at
// (f - k_d) & 1023. The 32 threads of a warp read 32 neighbouring words
// (mod 1024), so no read has a bank conflict, and each thread keeps
// FR_LANES independent sums in flight.
#include "common.cuh"

namespace {

constexpr int FR_TILE = 1024;
constexpr int FR_THREADS = 256;
constexpr int FR_LANES = FR_TILE / FR_THREADS;  // outputs a thread
constexpr int64_t FR_MAX_SHIFTS = 8192;         // shared-memory words

__global__ void __launch_bounds__(FR_THREADS)
flat_roll_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 const int32_t* __restrict__ shifts, int64_t rolls) {
  extern __shared__ int32_t smem[];  // the tile, then the shifts
  int32_t* tile = smem;
  int32_t* shift_s = smem + FR_TILE;
  const int64_t base = (int64_t)blockIdx.x * FR_TILE;
  for (int64_t d = threadIdx.x; d < rolls; d += FR_THREADS)
    shift_s[d] = shifts[d];
  tj::stage_tile<FR_THREADS, FR_TILE>(x, base, tile);
  __syncthreads();
  uint32_t acc[FR_LANES] = {};
  for (int64_t d = 0; d < rolls; ++d) {
    const uint32_t k = (uint32_t)shift_s[d];
#pragma unroll
    for (int j = 0; j < FR_LANES; ++j) {
      const uint32_t f = j * FR_THREADS + threadIdx.x;
      acc[j] += (uint32_t)tile[(f - k) & (FR_TILE - 1)];
    }
  }
#pragma unroll
  for (int j = 0; j < FR_LANES; ++j)
    __stcs(out + base + j * FR_THREADS + threadIdx.x, (int32_t)acc[j]);
}

}  // namespace

extern "C" {

// x, out: n i32, n a multiple of FR_TILE; shifts: at least rolls i32;
// 0 <= rolls <= FR_MAX_SHIFTS.
int tj_flat_roll(const int32_t* x, int32_t* out, int64_t n,
                 const int32_t* shifts, int64_t rolls, cudaStream_t stream) {
  if (n < 0 || n % FR_TILE != 0 || rolls < 0 || rolls > FR_MAX_SHIFTS ||
      n / FR_TILE > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  flat_roll_kernel<<<(unsigned)(n / FR_TILE), FR_THREADS,
                     (FR_TILE + rolls) * sizeof(int32_t), stream>>>(
      x, out, shifts, rolls);
  return (int)cudaGetLastError();
}

}  // extern "C"
