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
// What bounds it on the H100: bytes. K6a reads the mask once and writes
// k_cap ids: the filter at 100M rows reads 0.1 GB of bool mask and writes
// 0.25 GB of ids (~0.1 ms at 3.35 TB/s). K3 and K6b read each kept row's
// payload too: the aggregate's 6 columns at 10% kept come to ~2.75 GB
// (~0.8 ms), since a kept row lands in nearly every 32-byte sector of each
// column.
//
// K6a is one scan with a decoupled look-back (lookback.cuh, `+`): a block
// takes its tile of IDS_TILE_BYTES mask bytes from an atomic ticket, each
// thread loads IDS_VECS 16-byte vectors (16 rows of a bool mask, 4 of an
// i32 one), neighbouring threads neighbouring vectors, and turns each into
// a bit set of its set rows. The vectors' popcounts, one 16-bit field a
// vector in one 64-bit word, go through one warp and block scan; the tile
// publishes its count and looks back for its first output slot. The kept
// rows of one vector index over the block fill one contiguous output
// range, so they are staged in shared memory (16-bit rows within the
// tile), one vector index at a time, and written with 16-byte stores (the
// ragged ends word by word): the stage is 8 KB for a bool mask, so shared
// memory does not limit the blocks an SM. The last tile writes the count.
// A second small launch, a programmatic dependent of the scan, writes -1
// over [count, k_cap), reading the count on the device. The mask may
// start at any byte: the loads start at the 16-byte boundary at or before
// it and drop the rows outside it, at both ends. Before them the status
// words and the ticket are zeroed on the stream: one call is a memset and
// two launches.
//
// K3 and K6b keep two streaming passes with the block counts' prefix sum
// (torch.cumsum, glue) between them, 64-bit row indices and offsets
// throughout. Inside a block the scatter ranks its rows with
// __ballot_sync and __popc plus a one-warp scan of the per-warp counts in
// shared memory, so kept rows land in input order with no sort and no
// atomics. The output always fits: there is no coverage plan, no `fits`
// flag and no slab envelope as on the TPU.
#include "lookback.cuh"

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

// K6a. Each thread of a tile loads IDS_VECS vectors; vector v of thread i
// is the tile's (v * IDS_THREADS + i)-th, so the tile's rows run in
// (vector, thread, row) order and the kept rows of one v, over the
// threads, fill one contiguous output range.
constexpr int IDS_THREADS = 256;
constexpr int IDS_VECS = 4;
constexpr int IDS_WARPS = IDS_THREADS / 32;
constexpr int IDS_TILE_BYTES = IDS_THREADS * IDS_VECS * 16;
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_BLOCKS_PER_SM = 8;
// one 16-bit field a vector in a 64-bit word; a field's sum over the block
// is at most IDS_THREADS * 16, so no field carries into the next
static_assert(IDS_VECS * 16 <= 64 && IDS_THREADS * 16 < (1 << 16),
              "the packed counts fit 16-bit fields of one word");
// a kept row is staged as its 16-bit row within the tile
static_assert(IDS_TILE_BYTES <= (1 << 16), "a tile's rows fit 16 bits");

// The set rows of a 16-byte vector of mask rows, row e at bit e.
__device__ __forceinline__ uint32_t set_bits(const int4 v, uint8_t) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // bit 7 of each byte that is nonzero, then bits 7, 15, 23 and 31
    // gathered into bits 28-31 by one multiply (no carries below them)
    const uint32_t hi =
        (((w[k] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[k]) & 0x80808080u;
    bits |= ((hi * 0x00204081u) >> 28) << (4 * k);
  }
  return bits;
}
__device__ __forceinline__ uint32_t set_bits(const int4 v, int32_t) {
  return (uint32_t)(v.x > 0) | (uint32_t)(v.y > 0) << 1 |
         (uint32_t)(v.z > 0) << 2 | (uint32_t)(v.w > 0) << 3;
}

// Writes out[first, lim), 16 bytes at a time from the 16-byte boundary at
// or before first (out is 16-byte aligned), the ragged ends word by word:
// slot q takes id(q - first).
template <class Id>
__device__ __forceinline__ void write_range(int32_t* __restrict__ out,
                                            int64_t first, int64_t lim,
                                            Id id, int64_t thread,
                                            int64_t threads) {
  for (int64_t q = (first & ~(int64_t)3) + 4 * thread; q < lim;
       q += 4 * threads) {
    const int64_t s = q - first;
    if (q >= first && q + 4 <= lim) {
      *reinterpret_cast<int4*>(out + q) =
          make_int4(id(s), id(s + 1), id(s + 2), id(s + 3));
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (q + i >= first && q + i < lim) out[q + i] = id(s + i);
  }
}

// The mask's rows are the virtual rows [head, head + n) of the 16-byte
// vectors from `vecs` on; row id = virtual row - head.
template <typename M>
__global__ void __launch_bounds__(IDS_THREADS)
compact_ids_scan_kernel(const int4* __restrict__ vecs, int64_t head,
                        int64_t n, int32_t* __restrict__ out, int64_t k_cap,
                        unsigned long long* status, unsigned int* ticket,
                        int64_t tiles, int64_t* __restrict__ count) {
  constexpr int VEC = 16 / sizeof(M);                // rows a vector
  constexpr int TILE = IDS_TILE_BYTES / sizeof(M);   // rows a tile
  using u64 = unsigned long long;
  // one vector index's kept rows at a time, as rows within the tile
  __shared__ uint16_t stage[IDS_THREADS * VEC];
  __shared__ u64 warp_excl[IDS_WARPS];
  __shared__ uint32_t vec_first[IDS_VECS + 1];  // tile slots, by vector
  __shared__ uint32_t tile_first;
  __shared__ unsigned int tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = tile_id;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t end = head + n;
  const int64_t nvec = (end + VEC - 1) / VEC;

  int4 raw[IDS_VECS];
#pragma unroll
  for (int v = 0; v < IDS_VECS; ++v) {
    const int64_t i = (tile * IDS_VECS + v) * IDS_THREADS + threadIdx.x;
    raw[v] = i < nvec ? __ldcs(vecs + i) : make_int4(0, 0, 0, 0);
  }
  uint32_t bits[IDS_VECS];
  u64 packed = 0;
#pragma unroll
  for (int v = 0; v < IDS_VECS; ++v) {
    const int64_t row0 =
        ((tile * IDS_VECS + v) * IDS_THREADS + threadIdx.x) * VEC;
    bits[v] = set_bits(raw[v], M());
    // the bytes before the mask's first row and past its last
    if (row0 < head) bits[v] &= ~0u << (head - row0);
    if (row0 < end && row0 + VEC > end) bits[v] &= (1u << (end - row0)) - 1u;
    packed |= (u64)__popc(bits[v]) << (16 * v);
  }

  u64 incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 t = __shfl_up_sync(tj::FULL_MASK, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const u64 w = lane < IDS_WARPS ? warp_excl[lane] : 0ull;
    u64 w_incl = w;
#pragma unroll
    for (int d = 1; d < IDS_WARPS; d <<= 1) {
      const u64 t = __shfl_up_sync(tj::FULL_MASK, w_incl, d);
      if (lane >= d) w_incl += t;
    }
    if (lane < IDS_WARPS) warp_excl[lane] = w_incl - w;
    const u64 sums = __shfl_sync(tj::FULL_MASK, w_incl, IDS_WARPS - 1);
    uint32_t aggregate = 0;
#pragma unroll
    for (int v = 0; v < IDS_VECS; ++v) {
      if (lane == 0) vec_first[v] = aggregate;
      aggregate += (uint32_t)(sums >> (16 * v)) & 0xffffu;
    }
    uint32_t exclusive = 0;
    if (tile == 0) {
      if (lane == 0) tj::publish(status, tj::FLAG_PREFIX, aggregate);
    } else {
      if (lane == 0)
        tj::publish(status + tile, tj::FLAG_AGGREGATE, aggregate);
      exclusive = tj::look_back<tj::AddOp>(status, tile, lane);
      if (lane == 0)
        tj::publish(status + tile, tj::FLAG_PREFIX, exclusive + aggregate);
    }
    if (lane == 0) {
      vec_first[IDS_VECS] = aggregate;
      tile_first = exclusive;
      if (tile == tiles - 1) *count = (int64_t)exclusive + aggregate;
    }
  }
  __syncthreads();

  // each vector index's kept rows, staged in row order, then written to
  // their contiguous output range
  const u64 excl = warp_excl[warp] + incl - packed;
  const int64_t base = tile * TILE - head;   // id of the tile's row 0
#pragma unroll
  for (int v = 0; v < IDS_VECS; ++v) {
    uint32_t b = bits[v], at = (uint32_t)(excl >> (16 * v)) & 0xffffu;
    const int r = (v * IDS_THREADS + threadIdx.x) * VEC;
    while (b) {
      const int e = __ffs(b) - 1;
      b &= b - 1;
      stage[at++] = (uint16_t)(r + e);
    }
    __syncthreads();
    const int64_t first = (int64_t)tile_first + vec_first[v];
    const int64_t lim = (int64_t)tile_first + vec_first[v + 1];
    write_range(out, first, min(lim, k_cap),
                [&](int64_t i) { return (int32_t)(base + stage[i]); },
                threadIdx.x, IDS_THREADS);
    __syncthreads();   // the stage is rewritten for the next vector
  }
}

// Launched as a programmatic dependent of the scan, so its launch overlaps
// the scan's last blocks: it waits here until the scan has completed and
// its count is visible.
__global__ void __launch_bounds__(TAIL_THREADS)
compact_ids_tail_kernel(int32_t* __restrict__ out,
                        const int64_t* __restrict__ count, int64_t k_cap) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  write_range(out, *count, k_cap, [](int64_t) { return -1; },
              (int64_t)blockIdx.x * TAIL_THREADS + threadIdx.x,
              (int64_t)gridDim.x * TAIL_THREADS);
}

// K6a's tiles over n mask rows from `mask`: its loads start at the
// 16-byte boundary at or before it.
int64_t compact_ids_tiles(const void* mask, int64_t mask_i32, int64_t n) {
  const int64_t bytes =
      (int64_t)((uintptr_t)mask % 16) + n * (mask_i32 ? 4 : 1);
  return (bytes + IDS_TILE_BYTES - 1) / IDS_TILE_BYTES;
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

// The 64-bit words of scratch tj_compact_ids needs: the tiles' status
// words, then the ticket.
int64_t tj_compact_ids_scratch_words(const void* mask, int64_t mask_i32,
                                     int64_t n) {
  return compact_ids_tiles(mask, mask_i32, n) + 1;
}

// K6a. mask: n >= 1 rows from any byte (an i32 mask from a 4-byte
// boundary); scratch: scratch_words >= tj_compact_ids_scratch_words(mask,
// mask_i32, n) 64-bit words, zeroed here on `stream`; out: [k_cap] i32
// row ids, 16-byte aligned, -1 from the count on; count: one i64, the
// number of set rows.
int tj_compact_ids(const void* mask, int64_t mask_i32, int64_t n,
                   unsigned long long* scratch, int64_t scratch_words,
                   int32_t* out, int64_t k_cap, int64_t* count,
                   cudaStream_t stream) {
  const int64_t head_bytes = (int64_t)((uintptr_t)mask % 16);
  const int64_t tiles = compact_ids_tiles(mask, mask_i32, n);
  if (n <= 0 || head_bytes % (mask_i32 ? 4 : 1) || (uintptr_t)out % 16 ||
      scratch_words < tiles + 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (tiles + 1) * 8, stream);
  if (err != cudaSuccess) return (int)err;
  const int4* vecs = reinterpret_cast<const int4*>(
      static_cast<const char*>(mask) - head_bytes);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + tiles);
  if (mask_i32)
    compact_ids_scan_kernel<int32_t><<<(unsigned)tiles, IDS_THREADS, 0,
                                       stream>>>(
        vecs, head_bytes / 4, n, out, k_cap, scratch, ticket, tiles, count);
  else
    compact_ids_scan_kernel<uint8_t><<<(unsigned)tiles, IDS_THREADS, 0,
                                       stream>>>(
        vecs, head_bytes, n, out, k_cap, scratch, ticket, tiles, count);
  err = cudaGetLastError();
  if (err != cudaSuccess || k_cap <= 0) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (k_cap + 4 * TAIL_THREADS - 1) / (4 * TAIL_THREADS);
  cudaLaunchConfig_t config = {};
  config.gridDim =
      dim3((unsigned)min(blocks, (int64_t)sms * TAIL_BLOCKS_PER_SM));
  config.blockDim = dim3(TAIL_THREADS);
  config.stream = stream;
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &dependent;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, compact_ids_tail_kernel, out,
                                 (const int64_t*)count, k_cap);
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
