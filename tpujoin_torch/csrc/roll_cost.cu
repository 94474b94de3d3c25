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
// counterpart is one block (R <= 256) or two (R = 512), so the time is that
// of the chain and not the card's throughput over many tiles. The work is
// `ops * steps * R * 128` element ops, bounded by operations: on one SM an
// i32 add costs at least 1/64 of a clock an element (64 INT32 lanes), and
// a roll one warp shuffle an element (32 lanes a clock).
//
// Design.
//   - select and iota_add run in registers: 1024 threads, thread t holds
//     the E = R / 8 elements k * 1024 + t of its block's rows, all in lane
//     t % 128. The tile is staged once in shared memory and each
//     repetition reloads it with volatile loads, so that no repetition can
//     be hoisted; each folds its result into a checksum that ends in a
//     volatile store, so that none is dropped. Each op is one `asm
//     volatile` block, so the compiler can neither fold 64 adds of `lane`
//     into one multiply-add nor a run-time count into a closed form.
//   - The roll kinds keep the tile in registers too, laid out so that the
//     rolled axis of K * W positions lies across a W-lane shuffle segment
//     and K registers of each lane: position k * W + i in register k of
//     lane i. For the row kinds that axis is a column's R rows (W = 32 and
//     K = R / 32, or one 16-lane segment at R = 16), and a thread holds G
//     columns; for roll_lane it is a row's 128 lanes (W = 32, K = 4), and a
//     thread holds G rows. A roll by s = a * W + b (s taken mod the axis,
//     non-negative) sends from lane j register k - a where j + b < W, else
//     k - a - 1, and lane i reads lane (i - b) mod W: one select and one
//     `__shfl_sync` an element an op, no shared memory and no barrier in
//     the op loop. a is a template case chosen once before the chain, b a
//     run-time lane offset. Every op moves every element: the shifts are
//     not composed, and each repetition folds its result into the
//     checksum. The tile is staged once in shared memory in each thread's
//     own order and reloaded by volatile loads each repetition, as above.
//   - R = 512 (256 KB, more than a block's 227 KB of shared memory, and 64
//     values a thread at 1024 threads) runs as two blocks of 128 KB each:
//     the row kinds split the 128 columns, 64 a block, each with all 512
//     rows; roll_lane, select and iota_add split the rows, 256 a block.
//     No op crosses blocks, so they are two independent blocks and not a
//     cluster: no distributed shared memory and no cluster barrier.
//   - roll_lane at R = 16 has 16 rows of 4 registers: 512 threads.
#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 1024;

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

// select and iota_add on the block's E * 1024 elements.
template <int E>
__global__ void __launch_bounds__(THREADS)
reg_chain_kernel(const int32_t* x, int32_t* out, int kind, int32_t sh,
                 int64_t ops, int64_t steps) {
  extern __shared__ int32_t buf[];  // the block's E * THREADS words
  __shared__ int32_t sink_s;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int64_t base = (int64_t)blockIdx.x * E * THREADS;
  int32_t v[E];
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
}

// The tile word of element (g, k) of this thread: rolled axis position
// k * W + (lane % W) of its axis g. ROWS: the axes are columns, else rows.
template <bool ROWS, int K, int W, int G, int NT>
__device__ __forceinline__ int word(int g, int k) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int warps = NT / 32;
  if constexpr (ROWS) {
    constexpr int COLS = G * 32 / W;        // columns a warp
    const int col = (blockIdx.x * warps + warp) * COLS + lane / W * G + g;
    return (k * W + lane % W) * LANES + col;
  } else {
    const int row = (blockIdx.x * warps + warp) * G + g;
    return row * LANES + k * 32 + lane;
  }
}

// The roll kinds: `ops` rolls of every axis by a * W + b, a = A, on NT
// threads. NT is a constant, so each staged word's address is tid plus a
// constant: no address is kept in a register through the chain.
template <bool ROWS, int K, int W, int G, int A, int NT>
__global__ void __launch_bounds__(NT)
roll_chain_kernel(const int32_t* x, int32_t* out, int b, int64_t ops,
                  int64_t steps) {
  extern __shared__ int32_t buf[];  // the thread's G * K words, its own order
  __shared__ int32_t sink_s;
  const int tid = threadIdx.x;
  const int i = threadIdx.x % W;
  const bool near = i + b < W;              // sends register k - A, else
  const int src = (i - b) & (W - 1);        // k - A - 1; reads lane i - b
  int32_t v[G][K];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < K; ++k)
      buf[(g * K + k) * NT + tid] = x[word<ROWS, K, W, G, NT>(g, k)];
  // a thread reads back only its own words: no barrier
  volatile int32_t* tile = buf;
  int32_t fold = 0;
  for (int64_t s = 0; s < steps; ++s) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < K; ++k) v[g][k] = tile[(g * K + k) * NT + tid];
    for (int64_t d = 0; d < ops; ++d) {
      int32_t t[G][K];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < K; ++k)
          t[g][k] = near ? v[g][(k - A + K) % K] : v[g][(k - A - 1 + K) % K];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < K; ++k)
          v[g][k] = __shfl_sync(0xffffffffu, t[g][k], src, W);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < K; ++k) fold ^= v[g][k];
  }
  // every repetition's result feeds this store, so none is dead code
  *static_cast<volatile int32_t*>(&sink_s) = fold;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < K; ++k) out[word<ROWS, K, W, G, NT>(g, k)] = v[g][k];
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, unsigned blocks, int threads, int words,
                   cudaStream_t stream, Args... args) {
  const int smem = words * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// A roll chain by s (0 <= s < K * W) on `blocks` blocks of NT threads.
template <bool ROWS, int K, int W, int G, int NT, int A = 0>
cudaError_t launch_roll(int s, unsigned blocks, const int32_t* x,
                        int32_t* out, int64_t ops, int64_t steps,
                        cudaStream_t stream) {
  if constexpr (A + 1 < K) {
    if (s / W != A)
      return launch_roll<ROWS, K, W, G, NT, A + 1>(s, blocks, x, out, ops,
                                                   steps, stream);
  }
  return launch(roll_chain_kernel<ROWS, K, W, G, A, NT>, blocks, NT,
                G * K * NT, stream, x, out, s % W, ops, steps);
}

// The row kinds at R rows: W = min(R, 32) lanes and K = R / W registers a
// column, G columns a thread, R = 512 as two blocks of 64 columns.
template <int R, int G>
cudaError_t launch_rows(int64_t shift, const int32_t* x, int32_t* out,
                        int64_t ops, int64_t steps, cudaStream_t stream) {
  constexpr int W = R < 32 ? R : 32;
  return launch_roll<true, R / W, W, G, THREADS>(
      (int)(shift & (R - 1)), R == 512 ? 2 : 1, x, out, ops, steps, stream);
}

// roll_lane at R rows: four registers a row, G rows a thread, R = 512 as
// two blocks of 256 rows, R = 16 as 512 threads.
template <int R, int G>
cudaError_t launch_lanes(int64_t shift, const int32_t* x, int32_t* out,
                         int64_t ops, int64_t steps, cudaStream_t stream) {
  return launch_roll<false, LANES / 32, 32, G, R == 16 ? 512 : THREADS>(
      (int)(shift & (LANES - 1)), R == 512 ? 2 : 1, x, out, ops, steps,
      stream);
}

template <int R, int ROW_G, int LANE_G>
cudaError_t launch_chain(int kind, int64_t sh, const int32_t* x,
                         int32_t* out, int64_t ops, int64_t steps,
                         cudaStream_t stream) {
  constexpr int E = (R == 512 ? R / 2 : R) / 8;   // a block's rows / 8
  switch (kind) {
    case ROLL_LANE:
      return launch_lanes<R, LANE_G>(sh, x, out, ops, steps, stream);
    case ROLL_SUB:
      return launch_rows<R, ROW_G>(sh, x, out, ops, steps, stream);
    case ROLL_STATIC:
      return launch_rows<R, ROW_G>(3, x, out, ops, steps, stream);
    case CONCAT_SHIFT:
      return launch_rows<R, ROW_G>(1, x, out, ops, steps, stream);
    default:
      return launch(reg_chain_kernel<E>, R == 512 ? 2 : 1, THREADS,
                    E * THREADS, stream, x, out, kind, (int32_t)sh, ops,
                    steps);
  }
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
  const int k = (int)kind;
  switch (rows) {
    case 16: return (int)launch_chain<16, 2, 1>(k, sh, x, out, ops, steps,
                                                stream);
    case 64: return (int)launch_chain<64, 4, 2>(k, sh, x, out, ops, steps,
                                                stream);
    case 256: return (int)launch_chain<256, 4, 8>(k, sh, x, out, ops, steps,
                                                  stream);
    case 512: return (int)launch_chain<512, 2, 8>(k, sh, x, out, ops, steps,
                                                  stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
