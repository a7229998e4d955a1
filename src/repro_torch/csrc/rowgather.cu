// Fused gather + distance, one warp per candidate.
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
// B*C scattered rows is the whole cost.
//
// Design: a block serves one query b and a run of kCandsPerBlock candidates;
// the query row is staged once in shared memory and reused by all of them.
// Each warp takes one candidate at a time: its 32 lanes read the row with
// coalesced 16-byte loads (a 512 B row is one load per lane) and reduce by
// warp shuffle, so every row crosses memory exactly once and no warp waits
// on another.  Padding ids (>= N) skip the load entirely.  The per-pair
// reduction is pair_dist(), shared with dedup.cu so the two kernels agree
// bit for bit.
#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kThreads = 256;       // 8 warps
constexpr int kCandsPerBlock = 32;  // 4 candidates per warp

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowgather_kernel(const T* __restrict__ table, long long n, int d,
                 const int* __restrict__ ids, long long c,
                 const float* __restrict__ queries, float* __restrict__ out,
                 bool ip, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  const long long b = blockIdx.y;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = queries[b * d + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * kCandsPerBlock;
  const long long c1 = c0 + kCandsPerBlock < c ? c0 + kCandsPerBlock : c;
  for (long long cc = c0 + warp; cc < c1; cc += n_warps) {
    const int id = ids[b * c + cc];
    if (id >= n) {
      if (lane == 0) out[b * c + cc] = f32_inf();
      continue;
    }
    const float dist = pair_dist(table + safe_row(id) * d, qs, d, ip, vec, lane);
    if (lane == 0) out[b * c + cc] = dist;
  }
}

template <typename T>
int launch(const void* table, long long n, int d, const int* ids, long long b,
           long long c, const float* queries, float* out, int ip, int vec,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (int rc = set_smem(reinterpret_cast<const void*>(&rowgather_kernel<T>), smem)) return rc;
  const dim3 grid(static_cast<unsigned>((c + kCandsPerBlock - 1) / kCandsPerBlock),
                  static_cast<unsigned>(b));
  rowgather_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(table), n, d, ids, c, queries, out, ip != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int rowgather_launch(const void* table, int table_bf16, long long n, int d,
                                const void* ids, long long b, long long c,
                                const void* queries, void* out, int ip, int vec,
                                void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return repro_torch::launch<__nv_bfloat16>(table, n, d, i, b, c, q, o, ip, vec, s);
  return repro_torch::launch<float>(table, n, d, i, b, c, q, o, ip, vec, s);
}
