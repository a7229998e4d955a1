// Row-wise bitonic co-sort of (f32 key, i32 p0, i32 p1), one block per row.
//
// Replaces: src/repro/kernels/bitonic.py::sort_pairs (the Pallas _sort_kernel:
// one (1, n) row per grid step, log2(n)(log2(n)+1)/2 compare-exchange passes
// over VMEM-resident registers, the partner exchange i <-> i^j as a reshape +
// flip).
//
// Sorts each row of n = 2^k triples ascending in the total order (key, p0,
// p1), keys compared as IEEE floats (-0 == +0, +inf last).  Each pass applies
// the reference's per-lane rule exactly: in an ascending block (i & size) == 0
// the lower lane of a pair takes its partner when the partner orders
// strictly first, the upper lane takes its partner unless it orders strictly
// first (mirrored in a descending block).  On rows without equal-comparing
// triples of different bits (only -0/+0 or NaN keys make those), that is an
// exchange, and the result is the sorted row, equal to the plain version
// (kernels/ref.py::sort_pairs_ref) and to the Pallas kernel bit for bit.
//
// Bound on an H100: device-memory bytes at a large batch of rows (12 B per
// element read and written once); per row the network is log2(n)^2 / 2
// shared-memory passes, which bound a small batch.
//
// Design: a row's three arrays (12 B x n) sit in dynamic shared memory for the
// whole network; min(n/2, 1024) threads each own pairs t, t + blockDim, ...
// of every pass (pair t's lower index has bit j clear), with __syncthreads()
// between passes.  n goes up to 16384: 192 KB of the block's 227 KB.
#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kMaxThreads = 1024;

// (k1, a1, b1) strictly before (k2, a2, b2) in the total order
__device__ __forceinline__ bool before(float k1, int a1, int b1, float k2, int a2,
                                       int b2) {
  return k1 < k2 || (k1 == k2 && (a1 < a2 || (a1 == a2 && b1 < b2)));
}

__global__ void __launch_bounds__(kMaxThreads)
bitonic_kernel(const float* __restrict__ keys_in, const int* __restrict__ p0_in,
               const int* __restrict__ p1_in, float* __restrict__ keys_out,
               int* __restrict__ p0_out, int* __restrict__ p1_out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* key = reinterpret_cast<float*>(smem_raw);
  int* p0 = reinterpret_cast<int*>(key + n);
  int* p1 = p0 + n;
  const long long base = static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    key[i] = keys_in[base + i];
    p0[i] = p0_in[base + i];
    p1[i] = p1_in[base + i];
  }
  __syncthreads();

  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = 2 * t - (t & (j - 1));
        const int hi = lo + j;
        const bool asc = (lo & size) == 0;
        const float kl = key[lo], kh = key[hi];
        const int al = p0[lo], ah = p0[hi];
        const int bl = p1[lo], bh = p1[hi];
        const bool hi_first = before(kh, ah, bh, kl, al, bl);
        const bool lo_first = before(kl, al, bl, kh, ah, bh);
        if (asc ? hi_first : !hi_first) {
          key[lo] = kh;
          p0[lo] = ah;
          p1[lo] = bh;
        }
        if (asc ? !lo_first : lo_first) {
          key[hi] = kl;
          p0[hi] = al;
          p1[hi] = bl;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keys_out[base + i] = key[i];
    p0_out[base + i] = p0[i];
    p1_out[base + i] = p1[i];
  }
}

}  // namespace repro_torch

extern "C" int bitonic_launch(const void* keys_in, const void* p0_in, const void* p1_in,
                              void* keys_out, void* p0_out, void* p1_out, long long rows,
                              int n, void* stream) {
  using namespace repro_torch;
  const size_t smem = static_cast<size_t>(n) * 12;
  if (int rc = set_smem(reinterpret_cast<const void*>(&bitonic_kernel), smem)) return rc;
  const int threads = n / 2 < 1 ? 1 : (n / 2 < kMaxThreads ? n / 2 : kMaxThreads);
  bitonic_kernel<<<static_cast<unsigned>(rows), threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys_in), static_cast<const int*>(p0_in),
      static_cast<const int*>(p1_in), static_cast<float*>(keys_out),
      static_cast<int*>(p0_out), static_cast<int*>(p1_out), n);
  return static_cast<int>(cudaGetLastError());
}
