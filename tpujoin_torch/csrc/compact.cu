// K3 and K6: stable stream compaction under a mask.
//
// Replaces tpujoin/kernels/compact.py: `compact3` (`_kernel`, host `_plan`),
// `compact_ids` (`_kernel_ids`) and `compact_cols` (`_kernel_cols`). All
// three keep the rows whose mask is set, in input order, at width k_cap:
//   compact_ids   the row index itself, tail [nonzero, k_cap) = -1;
//   compact_cols  NCOLS i32 columns (1 <= NCOLS <= 8), tail zeroed;
//   compact3      compact_cols with NCOLS = 3 and its cnt column as mask.
// The mask is bool (1 B a row, set when nonzero) or i32 (set when > 0); the
// load is a template on its type, so a bool mask is never widened first.
//
// What bounds it on the H100: bytes. The count pass reads the mask; the
// scatter pass reads it again plus each kept row's payload, and writes
// k_cap slots of every output. E.g. the filter at 100M rows: 0.1 GB of bool
// mask read, 0.25 GB of ids written (~0.1 ms at 3.35 TB/s); the aggregate's
// 6 columns at 10% kept: ~2.75 GB (~0.8 ms), since a kept row lands in
// nearly every 32-byte sector of each column.
//
// What the simple design does about it: two streaming passes with the
// block counts' prefix sum (torch.cumsum, glue) between them, 64-bit row
// indices and offsets throughout. Inside a block the scatter ranks its rows
// with __ballot_sync and __popc plus a one-warp scan of the per-warp counts
// in shared memory, so kept rows land in input order with no sort and no
// atomics. The output
// always fits: there is no coverage plan, no `fits` flag and no slab
// envelope as on the TPU. A single-pass decoupled look-back scan would save
// the count pass's read of the mask.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int BLOCK_ROWS = THREADS * ITEMS;  // rows per block, both passes
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool is_set(const uint8_t* mask, int64_t r) {
  return mask[r] != 0;
}
__device__ __forceinline__ bool is_set(const int32_t* mask, int64_t r) {
  return mask[r] > 0;
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
count_kernel(const M* __restrict__ mask, int64_t n,
             int32_t* __restrict__ block_counts) {
  __shared__ int warp_counts[WARPS];
  const int64_t base = (int64_t)blockIdx.x * BLOCK_ROWS;
  int c = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t r = base + it * THREADS + threadIdx.x;
    c += __popc(__ballot_sync(FULL, r < n && is_set(mask, r)));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_counts[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_counts[w];
    block_counts[blockIdx.x] = s;
  }
}

// What a kept row r writes at slot dest, and what a tail slot holds.
struct IdsPayload {
  int32_t* out;
  __device__ __forceinline__ void keep(int64_t r, int64_t dest) const {
    out[dest] = (int32_t)r;
  }
  __device__ __forceinline__ void pad(int64_t q) const { out[q] = -1; }
};

template <int NCOLS>
struct ColsPayload {
  const int32_t* in[MAX_COLS];
  int32_t* out[MAX_COLS];
  __device__ __forceinline__ void keep(int64_t r, int64_t dest) const {
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) out[c][dest] = __ldg(in[c] + r);
  }
  __device__ __forceinline__ void pad(int64_t q) const {
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) out[c][q] = 0;
  }
};

// Item `it` of a block covers rows base + it * THREADS + [0, THREADS), so
// the block's rows run in (item, warp, lane) order. Each warp's ballot
// count per item goes to shared memory; one warp scans those ITEMS * WARPS
// = 32 counts, and a row's slot is its block's offset, plus its (item,
// warp)'s exclusive count, plus the kept lower lanes of its ballot.
static_assert(ITEMS * WARPS == 32, "one warp scans the block's counts");

template <typename M, typename P>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const M* __restrict__ mask, int64_t n,
               const int64_t* __restrict__ block_offsets,
               const int64_t* __restrict__ total_ptr, P payload,
               int64_t k_cap) {
  __shared__ int offsets[ITEMS * WARPS];
  const int64_t base = (int64_t)blockIdx.x * BLOCK_ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bool keep[ITEMS];
  unsigned ballot[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t r = base + it * THREADS + threadIdx.x;
    keep[it] = r < n && is_set(mask, r);
    ballot[it] = __ballot_sync(FULL, keep[it]);
    if (lane == 0) offsets[it * WARPS + warp] = __popc(ballot[it]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 counts, in row order
    const int c = offsets[lane];
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += x;
    }
    offsets[lane] = incl - c;
  }
  __syncthreads();
  const int64_t first = block_offsets[blockIdx.x];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (!keep[it]) continue;
    const int64_t dest =
        first + offsets[it * WARPS + warp] + __popc(ballot[it] & lower);
    if (dest < k_cap) payload.keep(base + it * THREADS + threadIdx.x, dest);
  }
  // the tail [total, k_cap); kept rows only ever land below total
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t q = *total_ptr + (int64_t)blockIdx.x * THREADS + threadIdx.x;
       q < k_cap; q += stride)
    payload.pad(q);
}

unsigned num_blocks(int64_t n) {
  return (unsigned)((n + BLOCK_ROWS - 1) / BLOCK_ROWS);
}

template <typename P>
int launch_scatter(const void* mask, int64_t mask_i32, int64_t n,
                   const int64_t* block_offsets, const int64_t* total_ptr,
                   const P& payload, int64_t k_cap, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (mask_i32)
    scatter_kernel<int32_t, P><<<num_blocks(n), THREADS, 0, stream>>>(
        (const int32_t*)mask, n, block_offsets, total_ptr, payload, k_cap);
  else
    scatter_kernel<uint8_t, P><<<num_blocks(n), THREADS, 0, stream>>>(
        (const uint8_t*)mask, n, block_offsets, total_ptr, payload, k_cap);
  return (int)cudaGetLastError();
}

template <int NCOLS>
int launch_cols(const void* mask, int64_t mask_i32, int64_t n,
                const int64_t* block_offsets, const int64_t* total_ptr,
                const int32_t* const* cols, int32_t* const* outs,
                int64_t k_cap, cudaStream_t stream) {
  ColsPayload<NCOLS> payload{};
  for (int c = 0; c < NCOLS; ++c) {
    payload.in[c] = cols[c];
    payload.out[c] = outs[c];
  }
  return launch_scatter(mask, mask_i32, n, block_offsets, total_ptr, payload,
                        k_cap, stream);
}

}  // namespace

extern "C" {

// mask_i32: 0 for a bool mask (1 B a row), 1 for an i32 mask.
// block_counts: one i32 per block of BLOCK_ROWS rows.
int tj_compact_count(const void* mask, int64_t mask_i32, int64_t n,
                     int32_t* block_counts, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (mask_i32)
    count_kernel<int32_t><<<num_blocks(n), THREADS, 0, stream>>>(
        (const int32_t*)mask, n, block_counts);
  else
    count_kernel<uint8_t><<<num_blocks(n), THREADS, 0, stream>>>(
        (const uint8_t*)mask, n, block_counts);
  return (int)cudaGetLastError();
}

// block_offsets: the exclusive prefix of block_counts (i64); total_ptr:
// its sum. out: [k_cap] i32 row ids, -1 from total on.
int tj_compact_ids(const void* mask, int64_t mask_i32, int64_t n,
                   const int64_t* block_offsets, const int64_t* total_ptr,
                   int32_t* out, int64_t k_cap, cudaStream_t stream) {
  return launch_scatter(mask, mask_i32, n, block_offsets, total_ptr,
                        IdsPayload{out}, k_cap, stream);
}

// cols, outs: host arrays of ncols device pointers ([n] and [k_cap] i32).
int tj_compact_cols(const void* mask, int64_t mask_i32, int64_t n,
                    const int64_t* block_offsets, const int64_t* total_ptr,
                    int64_t ncols, const int32_t* const* cols,
                    int32_t* const* outs, int64_t k_cap,
                    cudaStream_t stream) {
  switch (ncols) {
#define TJ_COLS_CASE(N) \
  case N:               \
    return launch_cols<N>(mask, mask_i32, n, block_offsets, total_ptr, cols, \
                          outs, k_cap, stream);
    TJ_COLS_CASE(1)
    TJ_COLS_CASE(2)
    TJ_COLS_CASE(3)
    TJ_COLS_CASE(4)
    TJ_COLS_CASE(5)
    TJ_COLS_CASE(6)
    TJ_COLS_CASE(7)
    TJ_COLS_CASE(8)
#undef TJ_COLS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
