// The kernel of the per-op overhead probe (exp/probe_opcost.py):
//   select_chain  over each R * 128-element block of an i32 column, `ops`
//                 chained acc = u >= c_d ? acc + c_d : acc from acc = x,
//                 with u the element's index in its block and c_d =
//                 shifts[d].
//
// Replaces exp/probe_opcost.py: `run` (`_kernel`).
//
// The compare is signed, as jnp.where's on two i32 values; the adds are
// unsigned, so they wrap.
//
// What bounds it on the H100: bytes, 8 B a row (2.147 GB at the probe's
// 2^28 rows, 0.641 ms at 3.35 TB/s). The least work that keeps the chain
// is one add an element an op: 33 * 2^28 adds at ops = 33, 0.53 ms at the
// 64 i32 lanes a clock of each of 132 SMs at 1.98 GHz, and less where an
// add issues to the fp32 pipe as well. The first design compared and
// selected on every element at every op, ~2.2 instructions an element an
// op: 1.555 ms at R = 128 and 33 ops, on an NVIDIA H100 80GB HBM3,
// 700.00 W.
//
// What the design does about it. c_d is the same for every element, and a
// warp holds K * 128 consecutive elements of one block, u in [u_w,
// u_w + 128K):
//   - each lane holds K quads of the warp's range in registers (K 16-byte
//     streaming loads in flight, K streaming stores at the end);
//   - for each op the warp tests c_d once against its range: c_d <= u_w,
//     every element adds c_d; c_d > u_w + 128K - 1, none does; otherwise
//     each element compares its offset in the lane's quads with
//     c_d - u_lane, a constant, and adds where it holds. The test is the
//     same on every lane, so the branch does not diverge, and an element
//     costs about one add an op;
//   - K is 4, or 2 or 1 where the block's R is no multiple of 4 (of 2), so
//     a warp never crosses a block;
//   - `shifts` is staged in shared memory once a thread block (a broadcast
//     read an op), and `ops` stays a run-time loop count: every op reads
//     its c_d and adds it, in order, to each element with u >= c_d.
// So at R >= 32 the chain hides behind the bytes: 0.719-0.720 ms at 33
// ops, as at 1 op; 0.777 at R = 8, where a shift inside the block makes
// one of the block's two warps compare for 27 of the 33 ops (NVIDIA H100
// 80GB HBM3, 700.00 W).
#include "common.cuh"

namespace {

constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int64_t SC_MAX_SHIFTS = 8192;  // shared-memory words for shifts

template <int K>
__global__ void __launch_bounds__(SC_THREADS)
select_chain_kernel(const int4* __restrict__ x, int4* __restrict__ out,
                    const int32_t* __restrict__ shifts, int ops,
                    int block_quads, int64_t warps) {
  extern __shared__ int32_t shift_s[];
  for (int d = threadIdx.x; d < ops; d += SC_THREADS) shift_s[d] = shifts[d];
  __syncthreads();
  const int64_t w = (int64_t)blockIdx.x * SC_WARPS + (threadIdx.x >> 5);
  if (w >= warps) return;                 // the same on the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t q0 = w * (32 * K);        // the warp's first quad
  const int u_w = (int)(q0 % block_quads) * 4;
  const int u_last = u_w + 128 * K - 1;
  const int u_lane = u_w + 4 * lane;      // element (i, e): u_lane + 128i + e
  uint32_t acc[K][4];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int4 a = __ldcs(x + q0 + 32 * i + lane);
    acc[i][0] = (uint32_t)a.x;
    acc[i][1] = (uint32_t)a.y;
    acc[i][2] = (uint32_t)a.z;
    acc[i][3] = (uint32_t)a.w;
  }
  for (int d = 0; d < ops; ++d) {
    const int32_t c = shift_s[d];
    if (c <= u_w) {                       // every element of the warp
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += (uint32_t)c;
    } else if (c <= u_last) {             // the warp's range holds c
      // element (i, e) adds c where 128i + e >= c - u_lane: one compare
      // with a constant an element
      const int rel = c - u_lane;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (128 * i + e >= rel) acc[i][e] += (uint32_t)c;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
    __stcs(out + q0 + 32 * i + lane,
           make_int4((int32_t)acc[i][0], (int32_t)acc[i][1],
                     (int32_t)acc[i][2], (int32_t)acc[i][3]));
}

template <int K>
void launch(const int32_t* x, int32_t* out, int64_t n, const int32_t* shifts,
            int64_t ops, int64_t rows, cudaStream_t stream) {
  const int64_t warps = n / (128 * K);
  select_chain_kernel<K><<<(unsigned)((warps + SC_WARPS - 1) / SC_WARPS),
                           SC_THREADS, (size_t)ops * sizeof(int32_t),
                           stream>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(out), shifts,
      (int)ops, (int)(rows * 32), warps);
}

}  // namespace

extern "C" {

// x, out: n i32, 16-byte aligned; n a multiple of block = rows * 128;
// shifts: at least ops i32; 0 <= ops <= SC_MAX_SHIFTS.
int tj_select_chain(const int32_t* x, int32_t* out, int64_t n,
                    const int32_t* shifts, int64_t ops, int64_t rows,
                    cudaStream_t stream) {
  const int64_t block = rows * 128;
  if (rows < 1 || block > (1 << 30) || n < 0 || n % block != 0 || ops < 0 ||
      ops > SC_MAX_SHIFTS || n / 128 / SC_WARPS > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (rows % 4 == 0)
    launch<4>(x, out, n, shifts, ops, rows, stream);
  else if (rows % 2 == 0)
    launch<2>(x, out, n, shifts, ops, rows, stream);
  else
    launch<1>(x, out, n, shifts, ops, rows, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
