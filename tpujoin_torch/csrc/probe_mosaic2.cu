// The kernels of the second Mosaic capability probe
// (exp/probe_mosaic2.py), one block each:
//   hbm_to_smem   a bulk copy of the 2048-word window of the 8192-word x at
//                 the offset s[0] into shared memory, then the window's
//                 word s[1], broadcast to (1, 128)
//   dyn_vec_load  x[0, s[0] : s[0] + 1024] of the (1, 4096) x
//
// Replaces exp/probe_mosaic2.py: the pallas_call of `t_hbm_to_smem` and
// `t_dyn_vec_load`.
//
// hbm_to_smem is the TPU kernel's make_async_copy and DMA semaphore on
// Hopper: one thread arms an mbarrier with the copy's bytes and issues a
// cp.async.bulk (csrc/tma.cuh); the block waits on the barrier, then reads
// the word at its run-time index. A bulk copy needs 16-byte-aligned ends,
// so the copy runs from the offset rounded down to 4 words to its end
// rounded up, clamped to x, and the read is shifted by the rounding: for
// every offset, the window's word s[1] is x[s[0] + s[1]] where that lies in
// x and s[1] in [0, 2048), and 0 otherwise. An empty window issues no copy.
// The TPU kernel's domain is an offset in [0, 6144] (a multiple of 1024
// there); inside it the copy is the window itself.
//
// dyn_vec_load is a load from a start known only at run time, unaligned:
// one word a thread, neighbouring threads neighbouring words, so the warp's
// loads coalesce into at most two sectors more than an aligned start's. A
// word outside x reads 0.
//
// What bounds them on the H100: latency. hbm_to_smem moves 8 KB and
// dyn_vec_load 8 KB (2.4 ns at 3.35 TB/s); their time is the launch, the
// scalar's load, the copy's round trip and, for hbm_to_smem, the barrier's
// wait.
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int64_t HS_N = 8192;       // x of hbm_to_smem
constexpr int64_t HS_WINDOW = 2048;  // the copied window
constexpr int HS_LANES = 128;        // the (1, 128) output
constexpr int64_t DV_N = 4096;       // x of dyn_vec_load
constexpr int DV_OUT = 1024;         // its output row

__global__ void __launch_bounds__(HS_LANES)
hbm_to_smem_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ s, int32_t* __restrict__ out) {
  // the window widened to 16-byte ends: at most HS_WINDOW + 6 words
  __shared__ __align__(128) int32_t buf[HS_WINDOW + 8];
  __shared__ __align__(8) uint64_t bar;
  const int64_t off = s[0], idx = s[1];
  const int64_t lo = off > 0 ? off : 0;
  const int64_t hi = off + HS_WINDOW < HS_N ? off + HS_WINDOW : HS_N;
  const int64_t a = lo & ~(int64_t)3;          // 16-byte ends, inside x
  const int64_t e = (hi + 3) & ~(int64_t)3;
  const bool copy = lo < hi;
  if (copy && threadIdx.x == 0) tj::mbar_init(&bar, 1);
  __syncthreads();
  if (copy) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)((e - a) * sizeof(int32_t));
      tj::mbar_arrive_expect_tx(&bar, bytes);
      tj::bulk_load(buf, x + a, bytes, &bar);
    }
    tj::mbar_wait(&bar, 0);
  }
  const int64_t g = off + idx;
  const bool hit = idx >= 0 && idx < HS_WINDOW && g >= 0 && g < HS_N;
  out[threadIdx.x] = hit ? buf[g - a] : 0;
}

__global__ void __launch_bounds__(DV_OUT)
dyn_vec_load_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ s, int32_t* __restrict__ out) {
  const int64_t g = (int64_t)s[0] + threadIdx.x;
  out[threadIdx.x] = (g >= 0 && g < DV_N) ? x[g] : 0;
}

}  // namespace

extern "C" {

// x: 8192 i32, 16-byte aligned; s: 2 i32 (offset, index); out: 128 i32.
int tj_mosaic_hbm_to_smem(const int32_t* x, const int32_t* s, int32_t* out,
                          cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  hbm_to_smem_kernel<<<1, HS_LANES, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

// x: 4096 i32; s: 1 i32 (the start); out: 1024 i32.
int tj_mosaic_dyn_vec_load(const int32_t* x, const int32_t* s, int32_t* out,
                           cudaStream_t stream) {
  dyn_vec_load_kernel<<<1, DV_OUT, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
