// The kernels of the third Mosaic capability probe (exp/probe_mosaic3.py),
// one block each, on (R, 128) i32 tiles:
//   sublane_roll  out[r] = x[(r + s[0]) mod 32] of the (32, 128) x, a roll
//                 of the rows by -s[0]
//   row_dma_2d    rows s[0] .. s[0] + 31 of the (256, 128) x, by a 2-D
//                 tensor-map copy; rows outside x are 0
//   flat_rotate   out[u] = flat[(u + s[0]) mod 4096] for the first 1024
//                 words u of the row-major flat (32, 128) x, as (8, 128)
//
// Replaces exp/probe_mosaic3.py: the pallas_call of `t_sublane_roll`,
// `t_2d_row_dma` and `t_flat_rotate`.
//
// sublane_roll stages the tile in shared memory with coalesced loads and
// writes each row from its rolled source row. row_dma_2d is the TPU
// kernel's 2-D make_async_copy and DMA semaphore on Hopper: the host encodes
// a tensor map of x in 32 x 128 boxes (csrc/tma.cuh), one thread arms an
// mbarrier with the box's bytes and issues cp.async.bulk.tensor.2d at row
// s[0], and the block waits on the barrier. The copy fills rows outside x
// with zeros; a box that misses x entirely (s[0] <= -32 or >= 256) issues
// no copy and writes zeros, so no coordinate near the i32 ends reaches the
// copy engine. flat_rotate computes what the TPU kernel builds from two row
// rolls, a lane roll and a select, as one index a thread:
// (u + s) & 4095 in unsigned arithmetic, so every i32 shift is defined.
// The TPU kernel agrees with it for shifts >= 0 and multiples of 128 only
// (ROADMAP, "Faults of the JAX package").
//
// What bounds them on the H100: latency. Each moves at most 32 KB (~10 ns
// at 3.35 TB/s); the time is the launch, the scalar's load, one round trip
// to device memory (for row_dma_2d through the copy engine and the
// barrier's wait) and the stores.
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int TL_LANES = 128;              // a row of every tile
constexpr int TL_THREADS = 1024;
constexpr int SR_ROWS = 32;                // sublane_roll's tile
constexpr int SR_WORDS = SR_ROWS * TL_LANES;
constexpr int RD_X_ROWS = 256;             // row_dma_2d's x
constexpr int RD_ROWS = 32;                // its box and output
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
row_dma_2d_kernel(const __grid_constant__ CUtensorMap map,
                  const int32_t* __restrict__ s, int32_t* __restrict__ out) {
  __shared__ __align__(128) int32_t buf[RD_WORDS];
  __shared__ __align__(8) uint64_t bar;
  const int32_t r0 = s[0];
  const bool copy = r0 > -RD_ROWS && r0 < RD_X_ROWS;
  if (copy && threadIdx.x == 0) tj::mbar_init(&bar, 1);
  __syncthreads();
  if (copy) {
    if (threadIdx.x == 0) {
      tj::mbar_arrive_expect_tx(&bar, sizeof(buf));
      tj::tensor_load_2d(buf, &map, 0, r0, &bar);
    }
    tj::mbar_wait(&bar, 0);
  }
#pragma unroll
  for (int k = 0; k < RD_WORDS / TL_THREADS; ++k) {
    const int l = k * TL_THREADS + threadIdx.x;
    out[l] = copy ? buf[l] : 0;
  }
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
// out: 32 x 128 i32. The tensor map is encoded on the host each call.
int tj_mosaic_row_dma_2d(const int32_t* x, const int32_t* s, int32_t* out,
                         cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap map;
  const cudaError_t err =
      tj::encode_2d_i32(&map, x, RD_X_ROWS, TL_LANES, RD_ROWS, TL_LANES);
  if (err != cudaSuccess) return (int)err;
  row_dma_2d_kernel<<<1, TL_THREADS, 0, stream>>>(map, s, out);
  return (int)cudaGetLastError();
}

// x: 32 x 128 i32; s: 1 i32 (the shift); out: 8 x 128 i32.
int tj_mosaic_flat_rotate(const int32_t* x, const int32_t* s, int32_t* out,
                          cudaStream_t stream) {
  flat_rotate_kernel<<<1, FR_OUT, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
