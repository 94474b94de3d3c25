// The kernels of the Mosaic capability probe (exp/probe_mosaic.py), one
// block each, every scalar read from device memory inside the kernel:
//   roll        out[0, i] = x[0, (i + s[0]) mod 1024], a roll by -s[0]
//   smem_dyn    s[s[0]] of the 5-word s, broadcast to (1, 128)
//   vmem_dyn    x[0, s[0]] of the (1, 1024) x, broadcast to (1, 128)
//   fori        sum over d < s[0] of (x + d) on a (1, 128) x, adds wrapping
//   smem_block  element 0 of block r[0] of 1024 of the 4096-word meta,
//               broadcast to (1, 128)
//
// Replaces exp/probe_mosaic.py: the pallas_call of `t_roll`, `t_smem_dyn`,
// `t_vmem_dyn`, `t_fori` and `t_smem_block`.
//
// On the TPU each probes what Mosaic can do with a scalar known only at run
// time: a roll by it, a dynamic index into SMEM or VMEM, a loop bound, a
// BlockSpec index map. Hopper has no scalar prefetch and needs none: a block
// loads its own scalars and indexes memory with them. smem_dyn stages its s
// in shared memory and indexes there, as the TPU kernel does in SMEM; the
// others index device memory directly, one coalesced access a thread.
//
// Every scalar is defined for every i32. The roll's (i + s) mod 1024 is
// (i + s) & 1023 in unsigned arithmetic (2^32 is a multiple of 1024), so
// INT32_MIN does not overflow. An index outside its input reads 0. fori runs
// max(s[0], 0) iterations; its adds are asm volatile, so the compiler can
// neither fold the loop into its closed form nor drop an iteration.
//
// What bounds them on the H100: latency, not bytes. Each moves at most 8 KB
// (2.4 ns at 3.35 TB/s); its time is the launch, the dependent load of the
// scalar and then of the data, and the store. fori adds s[0] dependent adds.
#include "common.cuh"

namespace {

constexpr int PM_ROW = 1024;    // x's (1, 1024) row of roll and vmem_dyn
constexpr int PM_LANES = 128;   // the (1, 128) outputs
constexpr int PM_S = 5;         // smem_dyn's s
constexpr int PM_META = 4096;   // smem_block's meta
constexpr int PM_BLOCK = 1024;  // smem_block's block

__global__ void __launch_bounds__(PM_ROW)
roll_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ s,
            int32_t* __restrict__ out) {
  const uint32_t k = (uint32_t)s[0];
  const uint32_t i = threadIdx.x;
  out[i] = x[(i + k) & (PM_ROW - 1)];
}

__global__ void __launch_bounds__(PM_LANES)
smem_dyn_kernel(const int32_t* __restrict__ s, int32_t* __restrict__ out) {
  __shared__ int32_t s_sh[PM_S];
  if (threadIdx.x < PM_S) s_sh[threadIdx.x] = s[threadIdx.x];
  __syncthreads();
  const int32_t i = s_sh[0];
  out[threadIdx.x] = (i >= 0 && i < PM_S) ? s_sh[i] : 0;
}

__global__ void __launch_bounds__(PM_LANES)
vmem_dyn_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ s,
                int32_t* __restrict__ out) {
  const int32_t i = s[0];
  out[threadIdx.x] = (i >= 0 && i < PM_ROW) ? x[i] : 0;
}

__global__ void __launch_bounds__(PM_LANES)
fori_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ s,
            int32_t* __restrict__ out) {
  const int32_t n = s[0];
  const uint32_t xv = (uint32_t)x[threadIdx.x];
  uint32_t acc = 0;
  for (int32_t d = 0; d < n; ++d)
    asm volatile("add.u32 %0, %0, %1;" : "+r"(acc) : "r"(xv + (uint32_t)d));
  out[threadIdx.x] = (int32_t)acc;
}

__global__ void __launch_bounds__(PM_LANES)
smem_block_kernel(const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ r, int32_t* __restrict__ out) {
  const int32_t b = r[0];
  out[threadIdx.x] =
      (b >= 0 && b < PM_META / PM_BLOCK) ? meta[b * PM_BLOCK] : 0;
}

}  // namespace

extern "C" {

// x: 1024 i32; s: 1 i32; out: 1024 i32.
int tj_mosaic_roll(const int32_t* x, const int32_t* s, int32_t* out,
                   cudaStream_t stream) {
  roll_kernel<<<1, PM_ROW, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

// s: 5 i32; out: 128 i32.
int tj_mosaic_smem_dyn(const int32_t* s, int32_t* out, cudaStream_t stream) {
  smem_dyn_kernel<<<1, PM_LANES, 0, stream>>>(s, out);
  return (int)cudaGetLastError();
}

// x: 1024 i32; s: 1 i32; out: 128 i32.
int tj_mosaic_vmem_dyn(const int32_t* x, const int32_t* s, int32_t* out,
                       cudaStream_t stream) {
  vmem_dyn_kernel<<<1, PM_LANES, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

// x: 128 i32; s: 1 i32 (the loop bound); out: 128 i32.
int tj_mosaic_fori(const int32_t* x, const int32_t* s, int32_t* out,
                   cudaStream_t stream) {
  fori_kernel<<<1, PM_LANES, 0, stream>>>(x, s, out);
  return (int)cudaGetLastError();
}

// meta: 4096 i32; r: 1 i32 (the block); out: 128 i32.
int tj_mosaic_smem_block(const int32_t* meta, const int32_t* r, int32_t* out,
                         cudaStream_t stream) {
  smem_block_kernel<<<1, PM_LANES, 0, stream>>>(meta, r, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
