// range_search: v1's count on the card. For every probe key x, in probe
// order and unsorted, lo = #{build < x} and cnt = #{build == x} in the
// sorted build keys: what torch.searchsorted, left and right, gives.
//
// Replaces no TPU kernel: the JAX package's v1 count is XLA's searchsorted
// (tpujoin/ops/hash_join.py), and the port called torch.searchsorted
// twice. Added because that library call, on unsorted probe keys, ran at
// ~1% of the bytes' floor: two full binary searches a probe key, ~27
// dependent levels each over a 400 MB column at 1e8 build keys, the lower
// ~12 of them random 32 B sectors from HBM.
//
// What bounds it on the H100: random sectors. The probe keys are read
// once and lo and cnt written once, 12 B a probe key (0.36 ms at 1e8 and
// 3.35 TB/s), but each probe key also needs some sector of the build
// keys, a random 32 B read from HBM: one such read a probe key, a gather
// at 1e8, takes ~3.3 ms on an H100. Every other random read a key costs
// about as much again; a binary search of 1e8 keys makes ~12 of them.
//
// Design: a directory of the build keys' range, kept in L2, then about
// one sector from HBM a probe key.
//   search_dir_kernel    2^p buckets of equal key width 2^shift from the
//                        smallest key kmin: dir[b] = lower_bound(keys,
//                        kmin + (b << shift)) for b in [0, 2^p], so
//                        dir[2^p] = n. The block reads keys[0] and
//                        keys[n - 1] itself; shift = max(0, bitlen(kmax -
//                        kmin) - p) in 64 bits, so every key lies in a
//                        bucket whatever the i32 range. p comes from n, 32
//                        to 64 keys a bucket at uniform keys: a directory
//                        of n / 8 to n / 16 bytes (8 MB at 1e8 keys) that
//                        fits in L2 beside the search's traffic. One
//                        thread a bucket start, by a binary search of the
//                        whole column: its work is log2(n) loads whatever
//                        the gaps between keys, and neighbouring threads
//                        share the upper levels in L1. Block 0 writes kmin
//                        and shift to params; every block takes the
//                        largest bucket it sees (the next thread's start
//                        less its own: a block writes 255 entries and
//                        searches 256) into params[2] by an atomic max.
//   search_count_kernel  one thread a probe key (coalesced loads of the
//                        keys, coalesced stores of lo and cnt; the
//                        resident threads keep enough loads in flight:
//                        4.13 ms at 1e8 x 1e8, where 2 and 4 keys a
//                        thread took 4.20 and 4.43). The bucket b =
//                        (x - kmin) >> shift and its bounds dir[b],
//                        dir[b + 1], read with an L2 evict-last policy so
//                        that the directory stays cached. A key below kmin
//                        gets (0, 0), one past the last bucket (n, 0). At
//                        shift 0 a bucket is one key's run: (dir[b],
//                        dir[b + 1] - dir[b]) with no key read. Else the
//                        key's place is interpolated in the bucket, and
//                        the aligned 8-key sector there (two 16-byte
//                        loads) gives both bounds when they lie in it
//                        (uniform keys: most of the time); a bound outside
//                        it takes the sector beside it toward the bound,
//                        then, if still outside, a binary search of the
//                        part of the bucket left. A skewed bucket costs
//                        log2 of its size and is as exact. A sector may
//                        cover up to 7 words past either end of the
//                        column: they lie in the same 32-byte sector as a
//                        key of it, so inside its allocation, and are not
//                        counted.
// The bucket holds every build key equal to x: those below its start lie
// before dir[b], those from the next start on at or past dir[b + 1]; so
// both bounds are the whole column's.
#include "common.cuh"

namespace {

constexpr int DIR_THREADS = 256;
constexpr int DIR_STEP = DIR_THREADS - 1;   // entries a block writes
constexpr int THREADS = 256;
constexpr int MAX_BITS = 30;

__global__ void __launch_bounds__(DIR_THREADS)
search_dir_kernel(const int32_t* __restrict__ keys, int32_t n, int p,
                  int32_t* __restrict__ dir,
                  unsigned long long* __restrict__ params) {
  __shared__ int32_t at[DIR_THREADS];
  __shared__ int32_t warp_max[DIR_THREADS / 32];
  const int64_t kmin = n ? __ldg(keys) : 0;
  const int64_t kmax = n ? __ldg(keys + n - 1) : 0;
  const int64_t range = kmax - kmin;
  const int bits = range ? 64 - __clzll(range) : 0;
  const int shift = bits > p ? bits - p : 0;
  const int64_t buckets = (int64_t)1 << p;
  const int64_t b = (int64_t)blockIdx.x * DIR_STEP + threadIdx.x;
  int32_t pos = 0;
  if (b <= buckets) {
    const int64_t start = kmin + (b << shift);
    int32_t len = n;
    while (len > 0) {
      const int32_t half = len >> 1;
      if ((int64_t)__ldg(keys + pos + half) < start) {
        pos += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    if (threadIdx.x < DIR_STEP || b == buckets) dir[b] = pos;
  }
  at[threadIdx.x] = pos;
  __syncthreads();
  const int32_t size =
      threadIdx.x < DIR_STEP && b < buckets ? at[threadIdx.x + 1] - pos : 0;
  const int32_t w = __reduce_max_sync(0xffffffffu, size);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t most = 0;
#pragma unroll
    for (int k = 0; k < DIR_THREADS / 32; ++k) most = max(most, warp_max[k]);
    if (most) atomicMax(params + 2, (unsigned long long)most);
    if (blockIdx.x == 0) {
      params[0] = (unsigned long long)kmin;
      params[1] = (unsigned long long)shift;
    }
  }
}

// An L2 policy that keeps a line past the others: the directory's.
__device__ __forceinline__ uint64_t keep_in_l2() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ int32_t load_kept(const int32_t* at,
                                             uint64_t policy) {
  int32_t v;
  asm volatile("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v) : "l"(at), "l"(policy));
  return v;
}

// The 8 keys of the 32-byte sector from c (keys + c is 32-byte aligned).
__device__ __forceinline__ void load_sector(const int32_t* keys, int32_t c,
                                            int32_t (&v)[8]) {
  const int4* q = reinterpret_cast<const int4*>(keys + c);
  const int4 a = __ldg(q), b = __ldg(q + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One step of a bound's search over [a, a + len) by the sector's keys v
// from c, which overlaps it: the bound when it lies in the sector (len
// 0), else the part of the range before or after the sector that holds
// it. The bound: the first key > x (UPPER) or >= x.
template <bool UPPER>
__device__ __forceinline__ void sector_step(const int32_t (&v)[8], int32_t c,
                                            int32_t x, int32_t& a,
                                            int32_t& len) {
  const int32_t end = a + len;
  const int32_t fs = max(a, c), fe = min(end, c + 8);
  int32_t before = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    before += c + k >= fs && c + k < fe && (UPPER ? v[k] <= x : v[k] < x);
  if (before == 0 && fs > a) {
    len = fs - a;
  } else if (before == fe - fs && fe < end) {
    a = fe;
    len = end - fe;
  } else {
    a = fs + before;
    len = 0;
  }
}

// The next sector of a bound whose step left [a, a + len) beside the
// sector from c: the one before it or the one after.
__device__ __forceinline__ int32_t next_sector(int32_t c, int32_t a) {
  return a < c ? c - 8 : c + 8;
}

__global__ void __launch_bounds__(THREADS)
search_count_kernel(const int32_t* __restrict__ keys, int32_t n,
                    const int32_t* __restrict__ probe, int64_t m,
                    const int32_t* __restrict__ dir, int64_t buckets,
                    const long long* __restrict__ params,
                    int32_t* __restrict__ lo, int32_t* __restrict__ cnt) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  const int64_t kmin = __ldg(params);
  const int shift = (int)__ldg(params + 1);
  const int32_t x = __ldcs(probe + i);
  const int64_t d = (int64_t)x - kmin;
  // the bucket's rows [s, e); a key outside every bucket gets an empty
  // range at 0 or n
  int32_t s = 0, e = 0;
  int64_t b = 0;
  if (d >= 0) {
    b = d >> shift;
    if (b < buckets) {
      const uint64_t kept = keep_in_l2();
      s = load_kept(dir + b, kept);
      e = load_kept(dir + b + 1, kept);
    } else {
      s = e = n;
    }
  }
  // at shift 0 a bucket is one key's run: no search
  if (shift && s < e) {
    // the sector of the key's place interpolated in the bucket; sector
    // starts are c with (c + align) % 8 == 0
    const int32_t align =
        (int32_t)((reinterpret_cast<uintptr_t>(keys) >> 2) & 7);
    const int32_t guess =
        s + (int32_t)(((int64_t)(e - s) * (d - (b << shift))) >> shift);
    const int32_t c = ((guess + align) & ~7) - align;
    int32_t v[8];
    load_sector(keys, c, v);
    int32_t al = s, nl = e - s, au = s, nu = e - s;
    sector_step<false>(v, c, x, al, nl);
    sector_step<true>(v, c, x, au, nu);
    // a bound outside it: the sector beside it, then a binary search
    if (nl > 0) {
      const int32_t next = next_sector(c, al);
      load_sector(keys, next, v);
      sector_step<false>(v, next, x, al, nl);
      if (nl > 0) al = (int32_t)tj::lower_bound(keys, al, al + nl, x);
    }
    if (nu > 0) {
      const int32_t next = next_sector(c, au);
      load_sector(keys, next, v);
      sector_step<true>(v, next, x, au, nu);
      if (nu > 0) au = (int32_t)tj::upper_bound(keys, au, au + nu, x);
    }
    s = al;
    e = au;
  }
  __stcs(lo + i, s);
  __stcs(cnt + i, e - s);
}

}  // namespace

// dir: 2^p + 1 entries; params: 3 words, set here (kmin, shift, the
// largest bucket's rows). n < 2^31, 0 <= p <= MAX_BITS.
extern "C" int tj_search_dir(const int32_t* keys, int64_t n, int64_t p,
                             int32_t* dir, unsigned long long* params,
                             cudaStream_t stream) {
  if (n < 0 || n > INT32_MAX || p < 0 || p > MAX_BITS)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(params, 0, 3 * 8, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (((int64_t)1 << p) + DIR_STEP - 1) / DIR_STEP;
  search_dir_kernel<<<(unsigned)blocks, DIR_THREADS, 0, stream>>>(
      keys, (int32_t)n, (int)p, dir, params);
  return (int)cudaGetLastError();
}

// dir and params as tj_search_dir left them for these keys and p; lo and
// cnt: m entries each.
extern "C" int tj_search_count(const int32_t* keys, int64_t n,
                               const int32_t* probe, int64_t m,
                               const int32_t* dir, int64_t p,
                               const long long* params, int32_t* lo,
                               int32_t* cnt, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (n < 0 || n > INT32_MAX || p < 0 || p > MAX_BITS)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (m + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  search_count_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      keys, (int32_t)n, probe, m, dir, (int64_t)1 << p, params, lo, cnt);
  return (int)cudaGetLastError();
}
