// The kernel of the op-cost probe (exp/roll_cost.py):
//   op_chain  one (R, 128) i32 tile put through `ops` chained ops of one
//             kind, `steps` times over, each time from the same tile.
//
// Replaces exp/roll_cost.py: `run` (`_mk_kernel`).
//
// The kinds, with jnp.roll's convention (out[i] = x[(i - s) mod n]):
//   roll_lane     roll each row by sh along its 128 lanes;
//   roll_sub      roll the rows by sh;
//   roll_static   roll the rows by 3;
//   concat_shift  roll the rows by 1 (the TPU kernel concatenates the last
//                 row before the others; on Hopper that is the same move);
//   select        x + 1 where lane < sh;
//   iota_add      x + lane.
// Adds wrap (two's complement).
//
// What it measures, and so what bounds it. The TPU program times a chain
// of dependent ops on one core, one grid step after the other. Its Hopper
// counterpart is one block (R <= 256) or one cluster of two (R = 512), so
// the time is that of the chain and not the card's throughput over many
// tiles. The work is `ops * steps * R * 128` element ops, bounded by
// operations, and on one SM an element op costs at least 1/64 of a clock
// for an i32 add (64 INT32 lanes an SM) and, for a roll, one 4-byte shared
// store and one load (32 words a clock each way) plus two barriers an op:
// the time of an op grows with R.
//
// Design.
//   - 1024 threads. Thread t holds the E = R / 8 elements k * 1024 + t of
//     its CTA's rows in registers, all in lane t % 128.
//   - select and iota_add run in registers. The tile is staged once in
//     shared memory and each repetition reloads it with volatile loads, so
//     that no repetition can be hoisted; each folds its result into a
//     checksum that ends in a volatile store, so that none is dropped.
//     Each op is one `asm volatile` block, so the compiler can neither
//     fold 64 adds of `lane` into one multiply-add nor a run-time count
//     into a closed form.
//   - The roll kinds move the tile through one shared buffer: each op
//     stores its elements at their own slots, waits at a barrier, loads
//     each from its source slot and waits again before the next store.
//     The 32 threads of a warp read 32 neighbouring lanes of one row, so no
//     load has a bank conflict. A second buffer would save a barrier an op
//     but does not fit at R = 256 (2 x 128 KB), so each repetition reloads
//     the tile from device memory (volatile loads, L2 hits after the
//     first): one load an element every `ops` ops.
//   - R = 512 is 256 KB, more than the 227 KB a block may have, and 1024
//     threads x 64 values would overrun the 64K-register file. It runs as
//     a cluster of two CTAs (`__cluster_dims__(2, 1, 1)`) of 256 rows
//     each. The row rolls read the partner's rows through distributed
//     shared memory (`map_shared_rank`) and wait at `cluster.sync()` in
//     place of `__syncthreads()`; the lane roll, select and iota_add need
//     no partner. What it costs: a cluster-wide barrier in place of a
//     block barrier, twice an op, and half the row loads crossing to the
//     other SM.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 1024;
constexpr int PASS_ROWS = THREADS / LANES;  // rows a pass of the threads
constexpr int PAIR_E = 32;                  // values a thread at R = 512

enum Kind : int {
  ROLL_LANE,
  ROLL_SUB,
  ROLL_STATIC,
  CONCAT_SHIFT,
  SELECT,
  IOTA_ADD,
};

// x + y, one instruction the compiler keeps
__device__ __forceinline__ int32_t add_kept(int32_t x, int32_t y) {
  int32_t r;
  asm volatile("add.s32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

// lane < sh ? x + 1 : x, a compare, an add and a select the compiler keeps
__device__ __forceinline__ int32_t select_kept(int32_t x, int32_t lane,
                                               int32_t sh) {
  int32_t r;
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .s32 t;\n\t"
      "setp.lt.s32 p, %1, %2;\n\t"
      "add.s32 t, %3, 1;\n\t"
      "selp.s32 %0, t, %3, p;\n\t}"
      : "=r"(r)
      : "r"(lane), "r"(sh), "r"(x));
  return r;
}

struct ChainArgs {
  const int32_t* x;
  int32_t* out;
  int kind;
  int32_t sh;
  int64_t ops;
  int64_t steps;
};

// A barrier over the CTA, or over the cluster where rows cross CTAs.
template <int CL>
__device__ __forceinline__ void wait_all(bool cluster_wide) {
  if (CL > 1 && cluster_wide)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The chain on R = E * 8 * CL rows; CL CTAs in the cluster (1 or 2).
template <int E, int CL>
__device__ __forceinline__ void chain(const ChainArgs& a) {
  const int32_t* x = a.x;
  int32_t* out = a.out;
  const int kind = a.kind;
  const int32_t sh = a.sh;
  const int64_t ops = a.ops, steps = a.steps;
  extern __shared__ int32_t buf[];  // this CTA's E * THREADS words
  constexpr int CTA_ROWS = E * PASS_ROWS;
  constexpr int ROWS = CTA_ROWS * CL;
  constexpr int CTA_WORDS = CTA_ROWS * LANES;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int trow = tid / LANES;
  const int rank = CL > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t base = (int64_t)rank * CTA_ROWS * LANES;
  int32_t v[E];

  if (kind == SELECT || kind == IOTA_ADD) {
    __shared__ int32_t sink_s;
#pragma unroll
    for (int k = 0; k < E; ++k)
      buf[k * THREADS + tid] = x[base + k * THREADS + tid];
    // a thread reads back only its own words: no barrier
    volatile int32_t* tile = buf;
    int32_t fold = 0;
    for (int64_t s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < E; ++k) v[k] = tile[k * THREADS + tid];
      if (kind == SELECT) {
        for (int64_t d = 0; d < ops; ++d)
#pragma unroll
          for (int k = 0; k < E; ++k) v[k] = select_kept(v[k], lane, sh);
      } else {
        for (int64_t d = 0; d < ops; ++d)
#pragma unroll
          for (int k = 0; k < E; ++k) v[k] = add_kept(v[k], lane);
      }
#pragma unroll
      for (int k = 0; k < E; ++k) fold ^= v[k];
    }
    // every repetition's result feeds this store, so none is dead code
    *static_cast<volatile int32_t*>(&sink_s) = fold;
#pragma unroll
    for (int k = 0; k < E; ++k) out[base + k * THREADS + tid] = v[k];
    return;
  }

  __shared__ int32_t shift_s;
  const bool lanes = kind == ROLL_LANE;
  if (tid == 0)
    shift_s = lanes ? sh & (LANES - 1)
                    : (kind == ROLL_SUB ? sh : kind == ROLL_STATIC ? 3 : 1) &
                          (ROWS - 1);
  __syncthreads();
  const bool remote = CL > 1 && !lanes;
  int32_t* part0 = buf;
  int32_t* part1 = buf;
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    part0 = cluster.map_shared_rank(buf, 0);
    part1 = cluster.map_shared_rank(buf, 1);
  }
  const volatile int32_t* src = x + base;
  for (int64_t s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = src[k * THREADS + tid];
    for (int64_t d = 0; d < ops; ++d) {
#pragma unroll
      for (int k = 0; k < E; ++k) buf[k * THREADS + tid] = v[k];
      wait_all<CL>(remote);
      // The shift is read back each op (a volatile broadcast load) and the
      // E source slots derived from it, so that the compiler cannot hoist
      // E addresses out of the op loop: at E = 32 they left no registers
      // and spilled.
      const int32_t shift = *static_cast<volatile int32_t*>(&shift_s);
      if (lanes) {
        const int c = trow * LANES + ((lane - shift) & (LANES - 1));
#pragma unroll
        for (int k = 0; k < E; ++k) v[k] = buf[c + k * THREADS];
      } else {
        // element k's source: (c + k * THREADS) mod the R * 128 words
        const int c = (rank * CTA_ROWS + trow - shift) * LANES + lane;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int g = (c + k * THREADS) & (ROWS * LANES - 1);
          if constexpr (CL == 1)
            v[k] = buf[g];
          else
            v[k] = (g < CTA_WORDS ? part0 : part1)[g & (CTA_WORDS - 1)];
        }
      }
      wait_all<CL>(remote);
    }
  }
#pragma unroll
  for (int k = 0; k < E; ++k) out[base + k * THREADS + tid] = v[k];
}

template <int E>
__global__ void __launch_bounds__(THREADS) op_chain_kernel(ChainArgs a) {
  chain<E, 1>(a);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS)
op_chain_pair_kernel(ChainArgs a) {
  chain<PAIR_E, 2>(a);
}

// e: values a thread, so the dynamic shared memory is e * THREADS words
template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned ctas, int e, const ChainArgs& a,
                   cudaStream_t stream) {
  const int smem = e * THREADS * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: rows x 128 i32; rows in {16, 64, 256, 512}; kind one
// of Kind (0-5); sh an i32; ops >= 0; steps >= 1.
int tj_op_chain(const int32_t* x, int32_t* out, int64_t rows, int64_t kind,
                int64_t sh, int64_t ops, int64_t steps, cudaStream_t stream) {
  if (kind < ROLL_LANE || kind > IOTA_ADD || ops < 0 || steps < 1 ||
      sh < INT32_MIN || sh > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const ChainArgs a{x, out, (int)kind, (int32_t)sh, ops, steps};
  switch (rows) {
    case 16: return (int)launch(op_chain_kernel<2>, 1, 2, a, stream);
    case 64: return (int)launch(op_chain_kernel<8>, 1, 8, a, stream);
    case 256: return (int)launch(op_chain_kernel<32>, 1, 32, a, stream);
    case 512: return (int)launch(op_chain_pair_kernel, 2, PAIR_E, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
