// Row-wise bitonic co-sort of (f32 key, i32 p0, i32 p1), a row's network in
// one warp's registers.
//
// Replaces: src/repro/kernels/bitonic.py::sort_pairs (the Pallas _sort_kernel:
// one (1, n) row per grid step, log2(n)(log2(n)+1)/2 compare-exchange passes
// over VMEM-resident registers, the partner exchange i <-> i^j as a reshape +
// flip).
//
// Sorts each row of n = 2^k triples ascending in the total order (key, p0,
// p1), keys compared as IEEE floats (-0 == +0, +inf last).  Each pass applies
// the reference's per-element rule exactly (_bitonic_pass): element i with
// partner i ^ j takes the partner's triple when take_min ? partner_first :
// !partner_first, where take_min = (ascending block (i & size) == 0) == (i is
// the lower of the pair), both decided from the values before the pass.  On
// rows without equal-comparing triples of different bits (only -0/+0 or NaN
// keys make those), that is an exchange, and the result is the sorted row,
// equal to the plain version (kernels/ref.py::sort_pairs_ref) and to the
// Pallas kernel bit for bit; on any row it is the Pallas network's result,
// because the passes run in its order under its rule.
//
// Bound on an H100: per row, the network's log2(n)(log2(n)+1)/2 passes of
// dependent compare-and-selects, at a small batch of rows; device-memory
// bytes (12 B per element read and written once) only at a large one.
//
// Design: a row of n <= 1024 is one warp's, with no shared memory and no
// barrier; a block is kRowWarps such warps (one: on an H100, at the merge's
// 512 x 256, one-warp blocks took 0.0106 ms against 0.0120 for two- or
// four-warp blocks, PERF.md).  The layout is striped: element
// i = e * 32 + lane sits in register e of lane `lane` (E = n / 32 registers a
// lane), so the row loads and stores as coalesced 128-byte lines.  A pass at
// stride j >= 32 pairs registers e and e ^ (j / 32) inside a lane; a pass at
// j < 32 pairs lanes by __shfl_xor_sync(j).  Register strides are template
// arguments, so the arrays never leave the registers.  Rows of up to
// kUnrollMax unroll their whole network, and each element's direction folds
// to a constant; 1024-element rows and runs loop over the stages with one
// inlined pass per stride (unrolled whole, their code overflowed the
// instruction cache and ran four times slower).  The payload rides as one
// signed 64-bit key x = p0 * 2^32 + (p1 ^ 2^31), which orders as (p0, p1)
// does, so a comparison is one float and one 64-bit compare (a quarter off
// the time at 512 x 256).  A row of 2048 <= n <= 16384 takes one block of
// up to 8 warps and its 12 B x n in shared memory (192 KB at n = 16384):
// each warp sorts 1024-element runs in registers straight from device
// memory; then for each larger stage the strides j >= 1024 run over shared
// memory, one barrier a pass, and the strides j < 1024 back in each warp's
// registers, the last stage storing straight to device memory.
#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kRowWarps = 1;     // rows of a block for n <= kRunLen, one a warp
constexpr int kRunLen = 1024;    // the longest row, or run, one warp holds: 32 x 32
constexpr int kUnrollMax = 512;  // the longest row whose network unrolls whole
constexpr int kLongWarps = 8;    // warps of a block for n > kRunLen, at most
constexpr int kMaxN = 16384;     // kernels/bitonic.py MAX_N

// (p0, p1) as one signed 64-bit key with the same order, and back
__device__ __forceinline__ long long pack(int p0, int p1) {
  return static_cast<long long>(p0) * 4294967296LL +
         static_cast<long long>(static_cast<unsigned>(p1) ^ 0x80000000u);
}
__device__ __forceinline__ int p0_of(long long x) { return static_cast<int>(x >> 32); }
__device__ __forceinline__ int p1_of(long long x) {
  return static_cast<int>(static_cast<unsigned>(x) ^ 0x80000000u);
}

// (k1, x1) strictly before (k2, x2) in the total order
__device__ __forceinline__ bool before(float k1, long long x1, float k2, long long x2) {
  return k1 < k2 || (k1 == k2 && x1 < x2);
}

// elements base + e * 32 + lane, e < E, of a row, in one warp's registers
template <int E>
struct Run {
  float k[E];
  long long x[E];
};

// A pass at stride j < 32: the partner of register e is register e of
// lane ^ j.  asc(e): is register e's element in an ascending block of the
// stage, (i & size) == 0.
template <int E, typename Asc>
__device__ __forceinline__ void lane_pass(Run<E>& r, int lane, int j, Asc asc) {
  const bool lower = (lane & j) == 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float pk = __shfl_xor_sync(kFullMask, r.k[e], j);
    const long long px = __shfl_xor_sync(kFullMask, r.x[e], j);
    const bool pf = before(pk, px, r.k[e], r.x[e]);
    if (asc(e) == lower ? pf : !pf) {
      r.k[e] = pk;
      r.x[e] = px;
    }
  }
}

// A pass at stride j = 32 JJ: the partner of register e is register e ^ JJ
// of the same lane
template <int E, int JJ, typename Asc>
__device__ __forceinline__ void reg_pass(Run<E>& r, Asc asc) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & JJ) continue;
    const int f = e | JJ;
    const bool up = asc(e);  // the same for e and f
    const float kl = r.k[e], kh = r.k[f];
    const long long xl = r.x[e], xh = r.x[f];
    const bool hi_first = before(kh, xh, kl, xl);
    const bool lo_first = before(kl, xl, kh, xh);
    if (up ? hi_first : !hi_first) {  // the lower element takes the min
      r.k[e] = kh;
      r.x[e] = xh;
    }
    if (up ? !lo_first : lo_first) {  // the upper one the max
      r.k[f] = kl;
      r.x[f] = xl;
    }
  }
}

// Passes J, J / 2, ..., 1 of one stage, each stride a template argument
// (rows of up to kUnrollMax: the network unrolls whole)
template <int E, int J, typename Asc>
__device__ __forceinline__ void merge(Run<E>& r, int lane, Asc asc) {
  if constexpr (J >= 32)
    reg_pass<E, J / 32>(r, asc);
  else
    lane_pass(r, lane, J, asc);
  if constexpr (J > 1) merge<E, J / 2>(r, lane, asc);
}

// Stages 2, 4, ..., N, unrolled; each element's direction is a constant
template <int E, int SIZE, int N>
__device__ __forceinline__ void sort_unrolled(Run<E>& r, int lane) {
  merge<E, SIZE / 2>(r, lane, [&](int e) {
    if constexpr (SIZE < 32) return (lane & SIZE) == 0;
    else return ((e * 32) & SIZE) == 0;
  });
  if constexpr (SIZE < N) sort_unrolled<E, 2 * SIZE, N>(r, lane);
}

// Passes j0, j0 / 2, ..., 1 of stage `size` of the run at `base`, looped:
// one inlined pass per stride (a run of 1024 unrolled whole overflows the
// instruction cache: 0.117 ms against 0.030 looped, at 512 x 1024)
template <int E>
__device__ __forceinline__ void merge_looped(Run<E>& r, int lane, int base, int size, int j0) {
  const auto asc = [&](int e) { return ((base + e * 32 + lane) & size) == 0; };
  for (int j = j0; j > 0; j >>= 1) {
    switch (j >> 5) {
      case 0: lane_pass(r, lane, j, asc); break;
      case 1: if constexpr (E > 1) reg_pass<E, 1>(r, asc); break;
      case 2: if constexpr (E > 2) reg_pass<E, 2>(r, asc); break;
      case 4: if constexpr (E > 4) reg_pass<E, 4>(r, asc); break;
      case 8: if constexpr (E > 8) reg_pass<E, 8>(r, asc); break;
      case 16: if constexpr (E > 16) reg_pass<E, 16>(r, asc); break;
    }
  }
}

// elements [0, n) of a striped run from `k`, `a`, `b` (elements >= n, only
// when n < 32, hold +inf and take no part)
template <int E>
__device__ __forceinline__ void load_run(Run<E>& r, const float* k, const int* a, const int* b,
                                         int n, int lane) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    r.k[e] = i < n ? k[i] : f32_inf();
    r.x[e] = i < n ? pack(a[i], b[i]) : 0;
  }
}

template <int E>
__device__ __forceinline__ void store_run(const Run<E>& r, float* k, int* a, int* b, int n,
                                          int lane) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < n) {
      k[i] = r.k[e];
      a[i] = p0_of(r.x[e]);
      b[i] = p1_of(r.x[e]);
    }
  }
}

// n = N <= kRunLen: one row per warp, kRowWarps rows a block,
// E = max(N / 32, 1)
template <int N>
__global__ void __launch_bounds__(kRowWarps * 32)
sort_row_kernel(const float* __restrict__ keys_in, const int* __restrict__ p0_in,
                const int* __restrict__ p1_in, float* __restrict__ keys_out,
                int* __restrict__ p0_out, int* __restrict__ p1_out, long long rows,
                long long first) {
  constexpr int E = N < 32 ? 1 : N / 32;
  // `& 31` tells the compiler lane < 32, so the i < N guards of a row's
  // loads and stores fold away for N >= 32 (with lane = threadIdx.x the
  // 512 x 256 sort took 0.0156 ms against 0.0110)
  const int lane = threadIdx.x & 31;
  const long long row = (first + blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long off = row * N;
  Run<E> r;
  load_run(r, keys_in + off, p0_in + off, p1_in + off, N, lane);
  if constexpr (N > kUnrollMax) {
    for (int size = 2; size <= N; size <<= 1) merge_looped(r, lane, 0, size, size >> 1);
  } else if constexpr (N > 1) {
    sort_unrolled<E, 2, N>(r, lane);
  }
  store_run(r, keys_out + off, p0_out + off, p1_out + off, N, lane);
}

// kRunLen < n <= kMaxN: one row per block of min(n / kRunLen, kLongWarps)
// warps, the row in shared memory between the register phases
__global__ void __launch_bounds__(kLongWarps * 32)
sort_long_kernel(const float* __restrict__ keys_in, const int* __restrict__ p0_in,
                 const int* __restrict__ p1_in, float* __restrict__ keys_out,
                 int* __restrict__ p0_out, int* __restrict__ p1_out, int n, long long first) {
  constexpr int E = kRunLen / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* key = reinterpret_cast<float*>(smem_raw);
  int* p0 = reinterpret_cast<int*>(key + n);
  int* p1 = p0 + n;
  const long long off = (first + blockIdx.x) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int runs = n / kRunLen;

  // stages 2 .. kRunLen of every run, in registers
  for (int s = warp; s < runs; s += n_warps) {
    const int base = s * kRunLen;
    Run<E> r;
    load_run(r, keys_in + off + base, p0_in + off + base, p1_in + off + base, kRunLen, lane);
    for (int size = 2; size <= kRunLen; size <<= 1) merge_looped(r, lane, base, size, size >> 1);
    store_run(r, key + base, p0 + base, p1 + base, kRunLen, lane);
  }
  __syncthreads();

  const int half = n >> 1;
  for (int size = 2 * kRunLen; size <= n; size <<= 1) {
    // strides j >= kRunLen across runs, in shared memory
    for (int j = size >> 1; j >= kRunLen; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = 2 * t - (t & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & size) == 0;
        const float kl = key[lo], kh = key[hi];
        const long long xl = pack(p0[lo], p1[lo]), xh = pack(p0[hi], p1[hi]);
        const bool hi_first = before(kh, xh, kl, xl);
        const bool lo_first = before(kl, xl, kh, xh);
        if (up ? hi_first : !hi_first) {
          key[lo] = kh;
          p0[lo] = p0_of(xh);
          p1[lo] = p1_of(xh);
        }
        if (up ? !lo_first : lo_first) {
          key[hi] = kl;
          p0[hi] = p0_of(xl);
          p1[hi] = p1_of(xl);
        }
      }
      __syncthreads();
    }
    // strides j < kRunLen inside each run, in registers; the last stage
    // stores to device memory
    for (int s = warp; s < runs; s += n_warps) {
      const int base = s * kRunLen;
      Run<E> r;
      load_run(r, key + base, p0 + base, p1 + base, kRunLen, lane);
      merge_looped(r, lane, base, size, kRunLen / 2);
      if (size == n)
        store_run(r, keys_out + off + base, p0_out + off + base, p1_out + off + base, kRunLen,
                  lane);
      else
        store_run(r, key + base, p0 + base, p1 + base, kRunLen, lane);
    }
    if (size < n) __syncthreads();
  }
}

template <int N>
int launch_rows(const float* ki, const int* ai, const int* bi, float* ko, int* ao, int* bo,
                long long rows, cudaStream_t stream) {
  return launch_blocks((rows + kRowWarps - 1) / kRowWarps, [&](long long first, unsigned count) {
    sort_row_kernel<N><<<count, kRowWarps * 32, 0, stream>>>(ki, ai, bi, ko, ao, bo, rows, first);
  });
}

}  // namespace repro_torch

extern "C" int bitonic_launch(const void* keys_in, const void* p0_in, const void* p1_in,
                              void* keys_out, void* p0_out, void* p1_out, long long rows,
                              int n, void* stream) {
  using namespace repro_torch;
  if (rows < 1 || n < 1 || (n & (n - 1)) != 0 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ki = static_cast<const float*>(keys_in);
  const int* ai = static_cast<const int*>(p0_in);
  const int* bi = static_cast<const int*>(p1_in);
  float* ko = static_cast<float*>(keys_out);
  int* ao = static_cast<int*>(p0_out);
  int* bo = static_cast<int*>(p1_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch_rows<1>(ki, ai, bi, ko, ao, bo, rows, s);
    case 2: return launch_rows<2>(ki, ai, bi, ko, ao, bo, rows, s);
    case 4: return launch_rows<4>(ki, ai, bi, ko, ao, bo, rows, s);
    case 8: return launch_rows<8>(ki, ai, bi, ko, ao, bo, rows, s);
    case 16: return launch_rows<16>(ki, ai, bi, ko, ao, bo, rows, s);
    case 32: return launch_rows<32>(ki, ai, bi, ko, ao, bo, rows, s);
    case 64: return launch_rows<64>(ki, ai, bi, ko, ao, bo, rows, s);
    case 128: return launch_rows<128>(ki, ai, bi, ko, ao, bo, rows, s);
    case 256: return launch_rows<256>(ki, ai, bi, ko, ao, bo, rows, s);
    case 512: return launch_rows<512>(ki, ai, bi, ko, ao, bo, rows, s);
    case 1024: return launch_rows<1024>(ki, ai, bi, ko, ao, bo, rows, s);
    default: break;
  }
  const size_t smem = static_cast<size_t>(n) * 12;
  if (int rc = set_smem(reinterpret_cast<const void*>(&sort_long_kernel), smem)) return rc;
  const int warps = n / kRunLen < kLongWarps ? n / kRunLen : kLongWarps;
  return launch_blocks(rows, [&](long long first, unsigned count) {
    sort_long_kernel<<<count, warps * 32, smem, s>>>(ki, ai, bi, ko, ao, bo, n, first);
  });
}
