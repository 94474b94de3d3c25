// The kernels of the third Mosaic capability probe (exp/probe_mosaic3.py),
// one block each, on (R, 128) i32 tiles:
//   sublane_roll  out[r] = x[(r + s[0]) mod 32] of the (32, 128) x, a roll
//                 of the rows by -s[0]
//   row_dma_2d    rows s[0] .. s[0] + 31 of the (256, 128) x, rows
//                 outside x 0
//   flat_rotate   out[u] = flat[(u + s[0]) mod 4096] for the first 1024
//                 words u of the row-major flat (32, 128) x, as (8, 128)
//
// Replaces exp/probe_mosaic3.py: the pallas_call of `t_sublane_roll`,
// `t_2d_row_dma` and `t_flat_rotate`.
//
// sublane_roll stages the tile in shared memory with coalesced loads and
// writes each row from its rolled source row. row_dma_2d, the TPU kernel's
// 2-D make_async_copy and DMA semaphore, is a direct load: each of 1024
// threads reads s[0] (one broadcast), takes row s[0] + tid / 32 in 64
// bits, and moves one 16-byte word of it, or zeros where the row lies
// outside x. No shared memory, barrier or tensor map: the scalar and the
// row are its two dependent loads. flat_rotate computes what the TPU
// kernel builds from two row rolls, a lane roll and a select, as one
// index a thread: (u + s) & 4095 in unsigned arithmetic, so every i32
// shift is defined.
// The TPU kernel agrees with it for shifts >= 0 and multiples of 128 only
// (ROADMAP, "Faults of the JAX package").
//
// What bounds them on the H100: latency. Each moves at most 32 KB (~10 ns
// at 3.35 TB/s); the time is the launch, the scalar's load, one round trip
// to device memory and the stores.
#include "common.cuh"

namespace {

constexpr int TL_LANES = 128;              // a row of every tile
constexpr int TL_THREADS = 1024;
constexpr int SR_ROWS = 32;                // sublane_roll's tile
constexpr int SR_WORDS = SR_ROWS * TL_LANES;
constexpr int RD_X_ROWS = 256;             // row_dma_2d's x
constexpr int RD_ROWS = 32;                // its output
constexpr int RD_WORDS = RD_ROWS * TL_LANES;
constexpr uint32_t FR_FLAT = 32 * TL_LANES;  // flat_rotate's x, flat
constexpr int FR_OUT = 8 * TL_LANES;         // its (8, 128) output

__global__ void __launch_bounds__(TL_THREADS)
sublane_roll_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ s, int32_t* __restrict__ out) {
  __shared__ int32_t tile[SR_WORDS];
  tj::stage_tile<TL_THREADS, SR_WORDS>(x, 0, tile);
  const uint32_t q = (uint32_t)s[0];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SR_WORDS / TL_THREADS; ++k) {
    const uint32_t l = k * TL_THREADS + threadIdx.x;
    const uint32_t row = (l / TL_LANES + q) & (SR_ROWS - 1);
    out[l] = tile[row * TL_LANES + l % TL_LANES];
  }
}

__global__ void __launch_bounds__(TL_THREADS)
row_dma_2d_kernel(const int4* __restrict__ x, const int32_t* __restrict__ s,
                  int4* __restrict__ out) {
  constexpr int VECS = TL_LANES / 4;       // 16-byte words of a row
  const int64_t row = (int64_t)s[0] + threadIdx.x / VECS;
  const int lane = threadIdx.x % VECS;
  out[threadIdx.x] = row >= 0 && row < RD_X_ROWS ? x[row * VECS + lane]
                                                 : make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(FR_OUT)
flat_rotate_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ s, int32_t* __restrict__ out) {
  const uint32_t d = (uint32_t)s[0];
  const uint32_t u = threadIdx.x;
  out[u] = x[(u + d) & (FR_FLAT - 1)];
}

}  // namespace

extern "C" {

// x: 32 x 128 i32; s: 1 i32; out: 32 x 128 i32.
int tj_mosaic_sublane_roll(const int32_t* x, const int32_t* s, int32_t* out,
                           cudaStream_t stream) {
  sublane_roll_kernel<<<1, TL_THREADS, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

// x: 256 x 128 i32, 16-byte aligned; s: 1 i32 (the first row);
// out: 32 x 128 i32, 16-byte aligned.
int tj_mosaic_row_dma_2d(const int32_t* x, const int32_t* s, int32_t* out,
                         cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  static_assert(RD_WORDS == 4 * TL_THREADS, "one 16-byte word a thread");
  row_dma_2d_kernel<<<1, TL_THREADS, 0, stream>>>(
      reinterpret_cast<const int4*>(x), s, reinterpret_cast<int4*>(out));
  return (int)cudaGetLastError();
}

// x: 32 x 128 i32; s: 1 i32 (the shift); out: 8 x 128 i32.
int tj_mosaic_flat_rotate(const int32_t* x, const int32_t* s, int32_t* out,
                          cudaStream_t stream) {
  flat_rotate_kernel<<<1, FR_OUT, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
