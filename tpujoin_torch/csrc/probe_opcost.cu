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
// 2^28 rows, 0.641 ms at 3.35 TB/s), until the operations pass them: a
// compare, an add and a select an element an op, 3 * ops * n, which at
// ops = 33 is 2.66e10 (0.40 ms at the card's 67e12 fp32 rate, up to twice
// that at its INT32 rate, 64 lanes an SM to the fp32's 128).
//
// What the design does about it. The work is elementwise, so the block is
// the probe's own R * 128 elements, and u is the element's index in it:
//   - `shifts` is staged in shared memory once a block (a broadcast read
//     an op);
//   - each of SC_THREADS threads takes four neighbouring elements at a
//     time (one 16-byte streaming load and store), four independent
//     chains to hide the latency of each;
//   - `ops` stays a run-time loop count, so the chain is not unrolled and
//     its constants are not folded.
#include "common.cuh"

namespace {

constexpr int SC_THREADS = 256;
constexpr int64_t SC_MAX_SHIFTS = 8192;  // shared-memory words for shifts

__global__ void __launch_bounds__(SC_THREADS)
select_chain_kernel(const int4* __restrict__ x, int4* __restrict__ out,
                    const int32_t* __restrict__ shifts, int64_t ops,
                    int block_quads) {
  extern __shared__ int32_t shift_s[];
  for (int64_t d = threadIdx.x; d < ops; d += SC_THREADS)
    shift_s[d] = shifts[d];
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * block_quads;
  for (int q = threadIdx.x; q < block_quads; q += SC_THREADS) {
    const int4 a = __ldcs(x + base + q);
    uint32_t acc[4] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z,
                       (uint32_t)a.w};
    const int u = 4 * q;
    for (int64_t d = 0; d < ops; ++d) {
      const int32_t c = shift_s[d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = u + j >= c ? acc[j] + (uint32_t)c : acc[j];
    }
    __stcs(out + base + q, make_int4((int32_t)acc[0], (int32_t)acc[1],
                                     (int32_t)acc[2], (int32_t)acc[3]));
  }
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
      ops > SC_MAX_SHIFTS || n / block > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  select_chain_kernel<<<(unsigned)(n / block), SC_THREADS,
                        (size_t)ops * sizeof(int32_t), stream>>>(
      reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(out), shifts,
      ops, (int)(block / 4));
  return (int)cudaGetLastError();
}

}  // extern "C"
