// The two kernels of the primitive-cost probes (bench/primitives.py):
//   stream_scale  out = 2 * x over i32, wrapping like two's complement
//                 (E7, the streaming copy that measures HBM bandwidth);
//   smem_gather   out[i] = tbl[idx[i]] with the table held on chip (E6).
//
// Replaces bench/primitives.py: `stream` (`copy_kern`) and `vmem_gather`
// (`kern`).
//
// stream_scale. What bounds it on the H100: bytes, 4 B read and 4 B written
// a row (0.797 GB at the probe's 99,614,720 rows, 0.238 ms at 3.35 TB/s).
// What the design does about it: 16-byte int4 loads and stores, UNROLL
// independent int4s in flight a thread over one contiguous chunk a block,
// a grid-stride loop and 64-bit indices. The grid covers the whole column,
// one chunk a block, rather than one wave of blocks striding over it. The
// TPU kernel
// needed n to be a multiple of its 512K block; here a ragged tail (and a
// pointer off 16-byte alignment) takes a scalar loop.
//
// smem_gather. What bounds it: at the probe's shapes (16,384-entry table,
// 65,536 indices) the launch: its bytes take ~0.2 us. What the design does
// about it: each block stages the whole table in dynamic shared memory
// (64 KB, above the 48 KB default, so the kernel's limit is raised once per
// device to the opt-in maximum) and then gathers one index a thread. Every
// block re-reads the table from L2, so the block count trades that staging
// against the gather's parallelism; one index a thread (64 blocks at the
// probe's shape) keeps the most parallelism, and 64 x 64 KB from L2 is
// well under a microsecond.
// Indices outside [0, tbl_n) are the caller's error, as in the TPU kernel.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int STREAM_THREADS = 256;
constexpr int UNROLL = 2;
constexpr int64_t CHUNK = (int64_t)STREAM_THREADS * UNROLL;  // int4s a block
constexpr int GATHER_THREADS = 1024;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ int32_t twice(int32_t v) {
  return (int32_t)((uint32_t)v << 1);
}

__device__ __forceinline__ int4 twice(int4 v) {
  return make_int4(twice(v.x), twice(v.y), twice(v.z), twice(v.w));
}

// Rows [0, 4 * nvec) as int4s, CHUNK of them a block at a time, the rest
// one by one.
__global__ void __launch_bounds__(STREAM_THREADS)
stream_scale_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                    int64_t n, int64_t nvec) {
  const int4* xv = reinterpret_cast<const int4*>(x);
  int4* ov = reinterpret_cast<int4*>(out);
  for (int64_t c = (int64_t)blockIdx.x * CHUNK; c < nvec;
       c += (int64_t)gridDim.x * CHUNK) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = c + u * STREAM_THREADS + threadIdx.x;
      v[u] = j < nvec ? xv[j] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = c + u * STREAM_THREADS + threadIdx.x;
      if (j < nvec) ov[j] = twice(v[u]);
    }
  }
  const int64_t stride = (int64_t)gridDim.x * STREAM_THREADS;
  for (int64_t r = 4 * nvec + (int64_t)blockIdx.x * STREAM_THREADS +
                   threadIdx.x;
       r < n; r += stride)
    out[r] = twice(x[r]);
}

__global__ void __launch_bounds__(GATHER_THREADS)
smem_gather_kernel(const int32_t* __restrict__ tbl, int tbl_n,
                   const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                   int64_t n) {
  extern __shared__ int32_t s_tbl[];
  for (int i = threadIdx.x; i < tbl_n; i += GATHER_THREADS)
    s_tbl[i] = __ldg(tbl + i);
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i < n) out[i] = s_tbl[__ldg(idx + i)];
}

}  // namespace

extern "C" {

int tj_stream_scale(const int32_t* x, int32_t* out, int64_t n,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const int64_t nvec = aligned ? n / 4 : 0;
  const int64_t blocks = std::max((nvec + CHUNK - 1) / CHUNK,
                                  (n - 4 * nvec + STREAM_THREADS - 1) /
                                      STREAM_THREADS);
  stream_scale_kernel<<<(unsigned)blocks, STREAM_THREADS, 0, stream>>>(
      x, out, n, nvec);
  return (int)cudaGetLastError();
}

// tbl: [tbl_n] i32, held in shared memory; idx, out: [n] i32.
int tj_smem_gather(const int32_t* tbl, int64_t tbl_n, const int32_t* idx,
                   int32_t* out, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (tbl_n <= 0 || tbl_n * 4 > optin || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  static bool raised[MAX_DEVICES] = {};
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        smem_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const int64_t blocks = (n + GATHER_THREADS - 1) / GATHER_THREADS;
  smem_gather_kernel<<<(unsigned)blocks, GATHER_THREADS, tbl_n * 4, stream>>>(
      tbl, (int)tbl_n, idx, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
