// Batch-deduplicating gather + distance: each distinct row of a step once.
//
// Replaces: src/repro/kernels/dedup.py::dedupdist (the Pallas _dedup_kernel
// on a (T, B) grid: every unique row against every query of the batch,
// then a scatter back to (B, C)).
//
// Computes the same (B, C) distances as rowgather.cu, bit for bit: the
// caller (kernels/dedup.py) sorts the flattened B*C ids stably, so equal ids
// form contiguous runs; `sorted_ids[p]` is the p-th id in that order,
// `order[p]` its flat lane b*C + c, and `run_start[u]`..`run_start[u + 1]`
// the run of the u-th distinct id (empty for u past the last one).
//
// Bound on an H100: device-memory bytes of the DISTINCT rows, which is the
// saving over rowgather when queries or walkers share candidates.
//
// Design: one block per distinct id.  It stages the row in shared memory
// once (cp.async) and then reduces it against exactly the lanes that named
// it — the id's run — one warp per lane, writing out[b, c] directly.  The
// TPU grid's (T, B) matrix is not built: at 512 walker lanes it would
// reduce ~500x the needed pairs.  The per-pair reduction is pair_dist(),
// shared with rowgather.cu.  The run of the padding sentinel (ids >= N)
// writes +inf; a negative id's run reads row 0, as rowgather.cu does.
#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kThreads = 128;  // 4 warps

template <typename T>
__global__ void __launch_bounds__(kThreads)
dedup_kernel(const T* __restrict__ table, long long n, int d,
             const int* __restrict__ sorted_ids, const int* __restrict__ run_start,
             const int* __restrict__ order, long long c,
             const float* __restrict__ queries, float* __restrict__ out, bool ip,
             bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);
  const int start = run_start[blockIdx.x];
  const int end = run_start[blockIdx.x + 1];
  if (start >= end) return;
  const int id = sorted_ids[start];
  if (id >= n) {
    for (int p = start + threadIdx.x; p < end; p += blockDim.x) out[order[p]] = f32_inf();
    return;
  }
  stage_rows(row, table, n, d, &sorted_ids[start], 1, vec);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int p = start + warp; p < end; p += n_warps) {
    const long long flat = order[p];
    const long long b = flat / c;
    const float dist = pair_dist(row, queries + b * d, d, ip, vec, lane);
    if (lane == 0) out[flat] = dist;
  }
}

template <typename T>
int launch(const void* table, long long n, int d, const int* sorted_ids,
           const int* run_start, const int* order, long long t, long long c,
           const float* queries, float* out, int ip, int vec, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(T);
  if (int rc = set_smem(reinterpret_cast<const void*>(&dedup_kernel<T>), smem)) return rc;
  dedup_kernel<T><<<static_cast<unsigned>(t), kThreads, smem, stream>>>(
      static_cast<const T*>(table), n, d, sorted_ids, run_start, order, c, queries, out,
      ip != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int dedup_launch(const void* table, int table_bf16, long long n, int d,
                            const void* sorted_ids, const void* run_start,
                            const void* order, long long t, long long c,
                            const void* queries, void* out, int ip, int vec,
                            void* stream) {
  const int* s_ids = static_cast<const int*>(sorted_ids);
  const int* starts = static_cast<const int*>(run_start);
  const int* ord = static_cast<const int*>(order);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return repro_torch::launch<__nv_bfloat16>(table, n, d, s_ids, starts, ord, t, c, q, o,
                                              ip, vec, s);
  return repro_torch::launch<float>(table, n, d, s_ids, starts, ord, t, c, q, o, ip, vec, s);
}
