// Fused gather + distance, four candidates a warp, two round trips a call.
//
// Replaces: src/repro/kernels/l2dist.py::l2dist_rowgather (the Pallas
// _rowgather_kernel, one (1, d) row per grid step addressed by a
// scalar-prefetched id).
//
// Computes out[b, c] = dist(table[ids[b, c]], queries[b]) for a (N, d) f32 or
// bf16 table, (B, C) int32 ids and (B, d) f32 queries; l2 is sum (x - q)^2,
// ip (and cosine) is -sum x*q; ids >= N give +inf and negative ids read
// row 0, as the plain version (kernels/ref.py) clamps them.
//
// Bound on an H100: device-memory bytes.  Each pair reads one d-element row
// (512 B at d = 128 f32) and does 2-3 flops per element, ~0.75 flop/byte
// against the card's ~20 f32 flop/byte balance point, so the gather of
// B*C scattered rows is the whole cost; what holds one call back is the
// chain of dependent memory round trips, not the bytes.
//
// Design: the chain is two round trips, with no shared memory and no
// barrier.  A warp takes `rows` (<= kRows) consecutive candidates of one
// query (kernels/l2dist.py::rowgather_plan; a block is kWarps such tasks and
// the grid is 1-D, so no grid dimension limits B).  Step 1: lanes
// 0..rows-1 load the warp's ids in one instruction while every lane loads
// the query chunks it owns straight into registers; the ids reach the other
// lanes by shuffle.  Step 2: every lane issues the 16-byte loads of all the
// warp's rows (chunks lane, lane + 32, ...: one float4 a lane for each of
// four rows at d = 128 f32, up to kWords chunks a row at a time for wider
// rows) before the first FMA, then the rows are reduced together by
// interleaved butterflies.  Each lane accumulates its chunks in pair_dist()'s
// order (pair_dist.cuh) and each row takes warp_sum()'s tree, so the
// distances equal dedup.cu's bit for bit.  Padding ids (>= N) are never
// loaded.  Rows that are not whole 16-byte chunks, or a table or queries
// that are not 16-byte aligned (vec = 0), are read element by element,
// lane l taking elements l, l + 32, ..., as pair_dist() does.
#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;   // candidates of a warp, at most
constexpr int kWords = 2;  // 16-byte chunks of a row a lane loads at once

// 16 raw bytes of a row widened to f32 (Vec<T>::n values; a bf16 is the
// high half of its f32)
__device__ __forceinline__ void widen(const uint4 w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void widen(const uint4 w, float (&x)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(u[j] << 16);
    x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void accumulate(float& acc, float x, float q, bool ip) {
  if (ip) {
    acc = fmaf(x, q, acc);
  } else {
    const float t = x - q;
    acc = fmaf(t, t, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowgather_kernel(const T* __restrict__ table, long long n, int d, const int* __restrict__ ids,
                 long long bsz, long long c, const float* __restrict__ queries,
                 float* __restrict__ out, bool ip, bool vec, int rows, long long tasks,
                 long long first) {
  const int lane = threadIdx.x & 31;
  const long long task = (first + blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (task >= bsz * tasks) return;
  const long long b = task / tasks;
  const long long c0 = (task - b * tasks) * rows;
  const int nr = static_cast<int>(c - c0 < rows ? c - c0 : rows);
  const long long base = b * c + c0;
  const float* q = queries + b * d;

  // step 1: the warp's ids (one load) ...
  const int my_id = lane < nr ? ids[base + lane] : 0;
  float acc[kRows] = {};
  if (vec) {
    constexpr int V = Vec<T>::n;
    const int n_ch = d / V;  // 16-byte chunks of a row
    for (int w0 = 0; w0 < n_ch; w0 += 32 * kWords) {
      // ... and the query chunks this lane owns, into registers
      float qv[kWords][V];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const int ch = w0 + lane + 32 * k;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          float t[4] = {};
          if (ch < n_ch) load16(q + ch * V + j, t);
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[k][j + i] = t[i];
        }
      }
      // step 2: every row's chunks in flight before the first FMA
      uint4 x[kRows][kWords];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int id = __shfl_sync(kFullMask, my_id, r);
        const T* row = table + safe_row(id) * d;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int ch = w0 + lane + 32 * k;
          x[r][k] = make_uint4(0, 0, 0, 0);
          if (r < nr && id < n && ch < n_ch)
            x[r][k] = *reinterpret_cast<const uint4*>(row + ch * V);
        }
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        if (w0 + lane + 32 * k >= n_ch) break;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float xv[V];
          widen(x[r][k], xv);
#pragma unroll
          for (int j = 0; j < V; ++j) accumulate(acc[r], xv[j], qv[k][j], ip);
        }
      }
    }
  } else {
    int id[kRows];
    bool ok[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      id[r] = __shfl_sync(kFullMask, my_id, r);
      ok[r] = r < nr && id[r] < n;
    }
    for (int i = lane; i < d; i += 32) {
      const float qi = q[i];
      float xv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) xv[r] = ok[r] ? to_f32(table[safe_row(id[r]) * d + i]) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) accumulate(acc[r], xv[r], qi, ip);
    }
  }
  warp_sums(acc);
  // lane r stores row r's distance: one coalesced store for the warp
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (lane == r) mine = acc[r];
  if (lane < nr) out[base + lane] = my_id >= n ? f32_inf() : ip ? -mine : mine;
}

template <typename T>
int launch(const void* table, long long n, int d, const int* ids, long long b, long long c,
           const float* queries, float* out, int ip, int vec, long long blocks, int rows,
           long long tasks, long long smem, cudaStream_t stream) {
  // the plan (kernels/l2dist.py::rowgather_plan) must cover C exactly once
  // and agree with this layout
  const bool ok = b >= 1 && c >= 1 && rows >= 1 && rows <= kRows &&
                  tasks == (c + rows - 1) / rows && blocks == (b * tasks + kWarps - 1) / kWarps &&
                  smem == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return launch_blocks(blocks, [&](long long first, unsigned count) {
    rowgather_kernel<T><<<count, kThreads, 0, stream>>>(
        static_cast<const T*>(table), n, d, ids, b, c, queries, out, ip != 0, vec != 0, rows,
        tasks, first);
  });
}

}  // namespace repro_torch

extern "C" int rowgather_launch(const void* table, int table_bf16, long long n, int d,
                                const void* ids, long long b, long long c,
                                const void* queries, void* out, int ip, int vec,
                                long long blocks, int rows, long long tasks, long long smem,
                                void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return repro_torch::launch<__nv_bfloat16>(table, n, d, i, b, c, q, o, ip, vec, blocks, rows,
                                              tasks, smem, s);
  return repro_torch::launch<float>(table, n, d, i, b, c, q, o, ip, vec, blocks, rows, tasks,
                                    smem, s);
}
