// K1: the (key, id) sort for Hopper, an LSD radix sort of 8-bit digits.
//
// Replaces tpujoin/kernels/merge_sort.py: `local_sort` (:389, the bitonic
// sort of each tile) and `merge_pass` (:307, the co-ranked merge of runs),
// which tpujoin_torch/kernels/merge_sort.py:sort_pairs chained before. The
// TPU chose merges because it has no vector scatter or gather and no `rev`;
// Hopper has fast scatters, shared-memory atomics and warp ballots, so the
// sort here counts digits instead of comparing keys:
//   histogram_kernel  one read of the keys builds the four 256-bin
//                     histograms of the biased key's 8-bit digits;
//   pass_kernel       one stable counting-sort pass on the digit at
//                     `shift`, single-pass (Adinets & Merrill, "Onesweep: A
//                     Faster Least Significant Digit Radix Sort for GPUs",
//                     2022), run four times, shifts 0, 8, 16 and 24. Its
//                     iota form (IOTA) runs shift 0 on keys alone: a pair's
//                     id is its index, made where the pair is stored, so a
//                     caller whose ids are the row numbers writes no id
//                     array and the pass reads none.
//
// What bounds it on the H100: bytes. The histogram reads 4 B a pair
// (0.119 ms for 100M pairs at 3.35 TB/s), each pass reads and writes the
// key and the id, 16 B a pair (0.478 ms), so the sort's floor is ~2.03 ms
// at 100M; the iota pass reads the key alone, 12 B a pair (0.358 ms). The
// merge design it replaces needed 1 + ceil(log2(n / 2048)) = 17 passes of
// 16 B a pair at 100M, >= 8.1 ms even at the byte bound.
// A pass does not reach its byte bound: its instructions a pair (eight
// ballots to rank it, the shared-memory scatter, the indexed stores) keep
// the SMs' issue slots busier than the memory (see PERF.md).
//
// What the design does about it:
//   - the histogram loads 16 B a thread (int4) and counts in shared
//     memory; each block adds its 1024 counts to the global histogram;
//   - a pass reads each pair once and writes it once. A block takes its
//     tile (PASS_TILE pairs) from an atomic ticket, so every tile it waits
//     on belongs to a block that already runs. Its keys come into
//     registers; its ids stream into shared memory (cp.async), so they
//     take no registers; the iota pass has no ids to load;
//   - each warp ranks a contiguous WARP_ITEMS of the tile, item j of lane l
//     at j * 32 + l, item by item, lane by lane: the input order, so the
//     pass is stable. Lanes with the same digit find each other with eight
//     ballots; the lowest of them bumps the warp's counter of that digit;
//   - the tile publishes its 256 digit counts, then looks back (thread t
//     for digit t, LOOKBACK predecessors at a time) until it meets an
//     inclusive prefix, and publishes its own (lookback.cuh's word: the
//     flag in the high 32 bits; no fence, since a reader uses only the
//     word);
//   - the pairs go through shared memory in digit order, so the global
//     writes are runs of consecutive addresses, one run a digit.
// Every i32 key sorts: the sign bit is flipped before digits are taken, so
// unsigned digit order is i32 order. There are no sentinel keys and no
// padding of n: the ragged last tile ranks its missing pairs as digit 255,
// after every real pair, and does not count them.
#include <algorithm>
#include <cstddef>

#include "lookback.cuh"

namespace {

constexpr int RADIX = 256;
constexpr int DIGITS = 4;               // 8-bit digits of a 32-bit key
constexpr uint32_t SIGN = 0x80000000u;  // flipped: unsigned order == i32
constexpr int HIST_THREADS = 256;
constexpr int HIST_BLOCKS_PER_SM = 8;
constexpr int PASS_THREADS = RADIX;     // thread t owns digit t
constexpr int PASS_WARPS = PASS_THREADS / 32;
constexpr int PASS_ITEMS = 30;          // pairs a thread
constexpr int WARP_ITEMS = 32 * PASS_ITEMS;
constexpr int PASS_TILE = PASS_THREADS * PASS_ITEMS;  // 7680 pairs
constexpr int LOOKBACK = 8;             // predecessors read at once
constexpr unsigned FULL = tj::FULL_MASK;
static_assert(PASS_TILE % 4 == 0, "a tile starts on a 16-byte boundary");

// The dynamic shared memory of a pass block.
struct PassSmem {
  int32_t key[PASS_TILE];    // the tile's keys in digit order
  int32_t id[PASS_TILE];     // its ids in digit order
  int32_t id_in[PASS_TILE];  // and in input order
};

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift) {
  return (((uint32_t)key ^ SIGN) >> shift) & (RADIX - 1);
}

__device__ __forceinline__ void count_key(uint32_t (*hist)[RADIX],
                                          int32_t key) {
  const uint32_t biased = (uint32_t)key ^ SIGN;
#pragma unroll
  for (int d = 0; d < DIGITS; ++d)
    atomicAdd(&hist[d][(biased >> (8 * d)) & (RADIX - 1)], 1u);
}

// keys[0, head) lie before the first 16-byte boundary; from there whole
// int4s, then fewer than four keys of tail.
__global__ void __launch_bounds__(HIST_THREADS)
histogram_kernel(const int32_t* __restrict__ keys, int64_t n, int head,
                 uint32_t* __restrict__ hist) {
  __shared__ uint32_t s[DIGITS][RADIX];
  for (int i = threadIdx.x; i < DIGITS * RADIX; i += HIST_THREADS)
    s[i / RADIX][i % RADIX] = 0;
  __syncthreads();
  const int64_t gtid = (int64_t)blockIdx.x * HIST_THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * HIST_THREADS;
  if (gtid < head) count_key(s, keys[gtid]);
  const int4* body = reinterpret_cast<const int4*>(keys + head);
  const int64_t vecs = (n - head) / 4;
  for (int64_t v = gtid; v < vecs; v += stride) {
    const int4 q = __ldcs(body + v);
    count_key(s, q.x);
    count_key(s, q.y);
    count_key(s, q.z);
    count_key(s, q.w);
  }
  const int64_t tail = head + 4 * vecs;
  if (gtid < n - tail) count_key(s, keys[tail + gtid]);
  __syncthreads();
  for (int i = threadIdx.x; i < DIGITS * RADIX; i += HIST_THREADS) {
    const uint32_t c = s[i / RADIX][i % RADIX];
    if (c) atomicAdd(hist + i, c);
  }
}

// Starts copying src[0, count) to the shared dst (16-byte aligned) without
// registers: 16 bytes a copy where src allows, else 4. One commit group;
// it completes at cp.async.wait_all.
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src,
                                           int count) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int vecs = vec ? count / 4 : 0;
  for (int v = threadIdx.x; v < vecs; v += PASS_THREADS) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * v);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + 4 * v));
  }
  for (int e = 4 * vecs + threadIdx.x; e < count; e += PASS_THREADS) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + e);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Exclusive prefix of v over the block's threads, in thread order.
__device__ __forceinline__ unsigned long long block_exclusive_scan(
    unsigned long long v, unsigned long long* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned long long incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + incl - v;
}

// One stable counting-sort pass of (ki, ii) on the digit at `shift` into
// (ko, io); with IOTA, of (ki, the keys' indices), and ii is not read.
// hist: the (DIGITS, RADIX) digit histogram of the keys. status:
// cdiv(n, PASS_TILE) * RADIX words, then the ticket, all zero at launch.
// Dynamic shared memory: the first pass_smem(IOTA) bytes of a PassSmem.
// Two blocks an SM: at most 128 registers a thread, which the 30 keys and
// 30 ranks a thread fill.
template <bool IOTA>
__global__ void __launch_bounds__(PASS_THREADS, 2)
pass_kernel(const int32_t* __restrict__ ki, const int32_t* __restrict__ ii,
            int32_t* __restrict__ ko, int32_t* __restrict__ io, int64_t n,
            int shift, const uint32_t* __restrict__ hist,
            unsigned long long* status, unsigned int* ticket) {
  extern __shared__ __align__(16) unsigned char s_dynamic[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(s_dynamic);
  // per warp and digit: the count, then the warp's first slot in the digit
  __shared__ uint32_t s_warp[PASS_WARPS][RADIX];
  __shared__ uint32_t s_start[RADIX];  // the digit's first slot in the tile
  __shared__ int32_t s_out[RADIX];     // output index of a slot, less the slot
  __shared__ unsigned long long s_sums[PASS_WARPS];
  __shared__ int64_t s_tile;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t == 0) s_tile = atomicAdd(ticket, 1u);
#pragma unroll
  for (int w = 0; w < PASS_WARPS; ++w) s_warp[w][t] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * PASS_TILE;
  const int tile_n = (int)min((int64_t)PASS_TILE, n - base);
  const int first = warp * WARP_ITEMS + lane;  // item 0's slot in the tile

  // the ids stream into shared memory and wait there for the output; the
  // keys come into registers for the ranking
  if (!IOTA) copy_async(sm.id_in, ii + base, tile_n);
  int32_t key[PASS_ITEMS];
#pragma unroll
  for (int j = 0; j < PASS_ITEMS; ++j) {
    const int e = first + 32 * j;
    key[j] = e < tile_n ? __ldcs(ki + base + e) : 0;
  }

  // rank each pair among the warp's pairs of its digit, in input order
  uint32_t rank[PASS_ITEMS];
  const unsigned lanes_below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < PASS_ITEMS; ++j) {
    const uint32_t d =
        first + 32 * j < tile_n ? digit_of(key[j], shift) : RADIX - 1;
    unsigned peers = FULL;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned set = __ballot_sync(FULL, bit);
      peers &= bit ? set : ~set;
    }
    const int below = __popc(peers & lanes_below);
    uint32_t before = 0;
    if (below == 0) {
      before = s_warp[warp][d];
      s_warp[warp][d] = before + __popc(peers);
    }
    rank[j] = __shfl_sync(FULL, before, __ffs(peers) - 1) + below;
    __syncwarp();
  }
  __syncthreads();

  // thread t: digit t's count in the tile, and each warp's first slot in it
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < PASS_WARPS; ++w) {
    const uint32_t c = s_warp[w][t];
    s_warp[w][t] = count;
    count += c;
  }
  // the ragged last tile's missing pairs were ranked as digit RADIX - 1
  const uint32_t real =
      t == RADIX - 1 ? count - (uint32_t)(PASS_TILE - tile_n) : count;
  unsigned long long* mine = status + tile * RADIX + t;
  tj::store_status(mine, tile == 0 ? tj::FLAG_PREFIX : tj::FLAG_AGGREGATE,
                   real);

  // one scan of both: the tile's counts (low word, <= PASS_TILE each) and
  // the pass's histogram (high word, sums <= n < 2^32)
  const unsigned long long both = block_exclusive_scan(
      (unsigned long long)hist[(shift / 8) * RADIX + t] << 32 | count,
      s_sums);
  const uint32_t start = (uint32_t)both;
  s_start[t] = start;
  if (!IOTA) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the pairs into shared memory in digit order, stable within a digit
#pragma unroll
  for (int j = 0; j < PASS_ITEMS; ++j) {
    const int e = first + 32 * j;
    const uint32_t d = e < tile_n ? digit_of(key[j], shift) : RADIX - 1;
    const uint32_t slot = s_start[d] + s_warp[warp][d] + rank[j];
    sm.key[slot] = key[j];
    sm.id[slot] = IOTA ? (int32_t)(base + e) : sm.id_in[e];
  }

  // digit t's pairs in the tiles before this one: LOOKBACK predecessors at
  // a time, nearest first, up to the nearest inclusive prefix
  uint32_t before_tiles = 0;
  if (tile > 0) {
    for (int64_t p = tile - 1;; p -= LOOKBACK) {
      unsigned long long word[LOOKBACK];
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q)  // before tile 0: a prefix of 0
        word[q] = p - q >= 0 ? tj::load_status(status + (p - q) * RADIX + t)
                             : tj::FLAG_PREFIX;
      bool done = false;
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q) {
        if (done) break;
        while ((word[q] >> 32) == 0)
          word[q] = tj::load_status(status + (p - q) * RADIX + t);
        before_tiles += (uint32_t)word[q];
        done = (word[q] >> 32) == (tj::FLAG_PREFIX >> 32);
      }
      if (done) break;
    }
    tj::store_status(mine, tj::FLAG_PREFIX, before_tiles + real);
  }
  s_out[t] = (int32_t)((uint32_t)(both >> 32) + before_tiles - start);
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PASS_ITEMS; ++j) {
    const int i = t + PASS_THREADS * j;
    if (i < tile_n) {
      const int32_t k = sm.key[i];
      const int32_t g = s_out[digit_of(k, shift)] + i;
      // only a histogram that is not the keys' could send g out of range
      if ((uint32_t)g < (uint32_t)n) {
        ko[g] = k;
        io[g] = sm.id[i];
      }
    }
  }
}

// The dynamic shared memory of a pass block: the iota pass leaves out
// id_in, the last member.
constexpr int pass_smem(bool iota) {
  return iota ? (int)offsetof(PassSmem, id_in) : (int)sizeof(PassSmem);
}

template <bool IOTA>
int launch_pass(const int32_t* ki, const int32_t* ii, int32_t* ko,
                int32_t* io, int64_t n, int64_t shift, const int32_t* hist,
                unsigned long long* scratch, int64_t scratch_words,
                cudaStream_t stream) {
  // i32 output indices and 32-bit status words
  if (shift < 0 || shift > 24 || shift % 8 != 0 || n > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t tiles = (n + PASS_TILE - 1) / PASS_TILE;
  if (scratch_words < tiles * RADIX + 1) return (int)cudaErrorInvalidValue;
  const int smem = pass_smem(IOTA);
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<IOTA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (tiles * RADIX + 1) * 8, stream);
  if (err != cudaSuccess) return (int)err;
  pass_kernel<IOTA><<<(unsigned)tiles, PASS_THREADS, smem, stream>>>(
      ki, ii, ko, io, n, (int)shift,
      reinterpret_cast<const uint32_t*>(hist), scratch,
      reinterpret_cast<unsigned int*>(scratch + tiles * RADIX));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hist: DIGITS * RADIX i32 counts, zeroed by the caller on `stream`; the
// keys' counts are added to it.
int tj_sort_histogram(const int32_t* keys, int64_t n, int32_t* hist,
                      cudaStream_t stream) {
  if (n > INT32_MAX) return (int)cudaErrorInvalidValue;  // i32 counts
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t head = std::min(n, (int64_t)(
      ((16 - (reinterpret_cast<uintptr_t>(keys) & 15)) & 15) / 4));
  const int64_t vecs = (n - head) / 4;
  const int64_t blocks = std::max((int64_t)1, std::min(
      (vecs + HIST_THREADS - 1) / HIST_THREADS,
      (int64_t)sms * HIST_BLOCKS_PER_SM));
  histogram_kernel<<<(unsigned)blocks, HIST_THREADS, 0, stream>>>(
      keys, n, (int)head, reinterpret_cast<uint32_t*>(hist));
  return (int)cudaGetLastError();
}

// shift: 0, 8, 16 or 24. hist: tj_sort_histogram of the keys (any order
// of them). scratch: scratch_words >= cdiv(n, PASS_TILE) * RADIX + 1
// 64-bit words, zeroed here on `stream` (the tiles' status words, then the
// ticket). One block a tile.
int tj_sort_pass(const int32_t* ki, const int32_t* ii, int32_t* ko,
                 int32_t* io, int64_t n, int64_t shift, const int32_t* hist,
                 unsigned long long* scratch, int64_t scratch_words,
                 cudaStream_t stream) {
  return launch_pass<false>(ki, ii, ko, io, n, shift, hist, scratch,
                            scratch_words, stream);
}

// tj_sort_pass at shift 0 with the ids 0, 1, ..., n - 1, which it makes
// and does not read.
int tj_sort_pass_iota(const int32_t* ki, int32_t* ko, int32_t* io, int64_t n,
                      const int32_t* hist, unsigned long long* scratch,
                      int64_t scratch_words, cudaStream_t stream) {
  return launch_pass<true>(ki, nullptr, ko, io, n, 0, hist, scratch,
                           scratch_words, stream);
}

const char* tj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
