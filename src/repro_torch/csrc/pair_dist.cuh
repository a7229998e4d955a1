// Shared device code of the CUDA kernels (rowgather.cu, dma.cu, dedup.cu,
// the int8 ones and bitonic.cu): 16-byte loads that widen a table row to f32,
// the warp-shuffle sums, the per-pair reduction, the cp.async staging and the
// launch of a 1-D grid of any size.
//
// pair_dist() is the per-(row, query) reduction of the dedup_gather kernel;
// rowgather.cu reduces several rows at once in the same per-lane order.  The
// element each lane owns, the order in which it accumulates them and the
// shuffle tree are fixed by (d, vec) alone, so the two kernels return
// bit-identical distances for the same pair whether the row sits in device
// memory or in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// elements of T in one 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one 16-byte load from p (16-byte aligned), widened to f32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// butterfly sum: every lane ends with the same total, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// warp_sum() of each of K values, their butterflies interleaved: each value
// takes warp_sum()'s tree, so it ends with the same bits
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] += __shfl_xor_sync(kFullMask, v[j], off);
  }
}

// Distance of one row (d elements of T) to one f32 query, reduced by the
// whole warp; every lane returns it.  l2: sum (x - q)^2; ip: -sum x*q.
// vec: row and query are 16-byte aligned and d is a multiple of Vec<T>::n,
// so each lane reads 16-byte chunks lane, lane + 32, ...; otherwise each
// lane reads elements lane, lane + 32, ...
template <typename T>
__device__ __forceinline__ float pair_dist(const T* row, const float* q, int d,
                                           bool ip, bool vec, int lane) {
  float acc = 0.f;
  if (vec) {
    constexpr int V = Vec<T>::n;
    for (int base = lane * V; base < d; base += 32 * V) {
      float x[V];
      float qv[V];
      load16(row + base, x);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        float t[4];
        load16(q + base + j, t);
#pragma unroll
        for (int k = 0; k < 4; ++k) qv[j + k] = t[k];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (ip) {
          acc = fmaf(x[j], qv[j], acc);
        } else {
          const float t = x[j] - qv[j];
          acc = fmaf(t, t, acc);
        }
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float x = to_f32(row[i]);
      if (ip) {
        acc = fmaf(x, q[i], acc);
      } else {
        const float t = x - q[i];
        acc = fmaf(t, t, acc);
      }
    }
  }
  acc = warp_sum(acc);
  return ip ? -acc : acc;
}

// 16-byte asynchronous global -> shared copy (Ampere+ cp.async, L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The table row an id reads: negative ids read row 0, as the plain version
// (kernels/ref.py) clamps them.  Callers handle ids >= n (padding) first.
__device__ __forceinline__ long long safe_row(int id) { return id < 0 ? 0 : id; }

// Copy `n_rows` table rows (ids[r] through safe_row(); rows whose id is >= n
// are skipped) into `dst` (n_rows x d elements, 16-byte aligned),
// cooperatively by the whole block: cp.async 16-byte chunks when vec, else
// elementwise.  The caller synchronises the block afterwards.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ table,
                                           long long n, int d,
                                           const int* __restrict__ ids,
                                           int n_rows, bool vec) {
  if (vec) {
    const int chunks = d * static_cast<int>(sizeof(T)) / 16;
    for (int k = threadIdx.x; k < n_rows * chunks; k += blockDim.x) {
      const int r = k / chunks;
      const int ch = k - r * chunks;
      const int id = ids[r];
      if (id >= n) continue;
      const char* src = reinterpret_cast<const char*>(table + safe_row(id) * d) + ch * 16;
      char* out = reinterpret_cast<char*>(dst + (long long)r * d) + ch * 16;
      cp_async16(out, src);
    }
    cp_async_wait_all();
  } else {
    for (int k = threadIdx.x; k < n_rows * d; k += blockDim.x) {
      const int r = k / d;
      const int e = k - r * d;
      const int id = ids[r];
      if (id >= n) continue;
      dst[(long long)r * d + e] = table[safe_row(id) * d + e];
    }
  }
}

// The most blocks of a 1-D grid (gridDim.x).
constexpr long long kMaxBlocks = 2147483647LL;

// Launch `blocks` blocks (any count >= 1) as 1-D grids of at most kMaxBlocks:
// go(first, count) launches blocks [first, first + count), and the kernel
// adds `first` to blockIdx.x.  Returns the first CUDA error, else 0.
template <typename Launch>
inline int launch_blocks(long long blocks, Launch go) {
  for (long long first = 0; first < blocks; first += kMaxBlocks) {
    const long long count = blocks - first < kMaxBlocks ? blocks - first : kMaxBlocks;
    go(first, static_cast<unsigned>(count));
    if (int rc = static_cast<int>(cudaGetLastError())) return rc;
  }
  return 0;
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace repro_torch
