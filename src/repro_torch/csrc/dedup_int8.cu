// Batch-deduplicating gather + int8 distance: each distinct code row of a
// step once.
//
// Replaces: src/repro/kernels/dedup.py::dedupdist_int8 (the Pallas
// _dedup_int8_kernel on a (T, B) grid: every unique int8 row and its scale
// against every query of the batch, then a scatter back to (B, C)).
//
// Computes the same (B, C) distances as rowgather_int8.cu, bit for bit, on
// the plan of dedup.cu (kernels/dedup.py::dedup_plan): `sorted_ids` the
// stably sorted flat ids, `order[p]` the flat lane b*C + c of sorted slot p,
// `run_start[u]`..`run_start[u + 1]` the run of the u-th distinct id.  The
// query side (qc, qs, q2) is quant/kernels.py::query_meta's, as for
// rowgather_int8.
//
// Bound on an H100: device-memory bytes of the DISTINCT code rows (d bytes
// each plus a 4-byte scale), so the 4x payload cut of int8 compounds with
// the dedup factor.
//
// Design: one block per distinct id.  It stages the d-byte code row
// (cp.async 16-byte chunks when aligned) and its scale in shared memory once,
// then reduces them against exactly the lanes of the id's run, one warp per
// lane, through the same int8_pair() / int8_epilogue() as rowgather_int8.cu.
// The run of the padding sentinel (ids >= N) writes +inf; a negative id's
// run reads row 0.
#include "int8_dist.cuh"

namespace repro_torch {

constexpr int kThreads = 128;  // 4 warps

__global__ void __launch_bounds__(kThreads)
dedup_int8_kernel(const int8_t* __restrict__ codes, long long n, int d,
                  const float* __restrict__ scales, const int* __restrict__ sorted_ids,
                  const int* __restrict__ run_start, const int* __restrict__ order,
                  long long c, const int* __restrict__ qc, const float* __restrict__ qs,
                  const float* __restrict__ q2, float* __restrict__ out, bool ip,
                  bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float scale;
  int8_t* row = reinterpret_cast<int8_t*>(smem_raw);
  const int start = run_start[blockIdx.x];
  const int end = run_start[blockIdx.x + 1];
  if (start >= end) return;
  const int id = sorted_ids[start];
  if (id >= n) {
    for (int p = start + threadIdx.x; p < end; p += blockDim.x) out[order[p]] = f32_inf();
    return;
  }
  stage_rows(row, codes, n, d, &sorted_ids[start], 1, vec);
  if (threadIdx.x == 0) scale = scales[safe_row(id)];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int p = start + warp; p < end; p += n_warps) {
    const long long flat = order[p];
    const long long b = flat / c;
    int acc, rn2;
    int8_pair(row, qc + b * d, d, vec, lane, acc, rn2);
    if (lane == 0) out[flat] = int8_epilogue(acc, rn2, scale, qs[b], q2[b], ip);
  }
}

}  // namespace repro_torch

extern "C" int dedup_int8_launch(const void* codes, long long n, int d, const void* scales,
                                 const void* sorted_ids, const void* run_start,
                                 const void* order, long long t, long long c,
                                 const void* qc, const void* qs, const void* q2,
                                 void* out, int ip, int vec, void* stream) {
  using namespace repro_torch;
  const size_t smem = (static_cast<size_t>(d) + 15) / 16 * 16;
  if (int rc = set_smem(reinterpret_cast<const void*>(&dedup_int8_kernel), smem)) return rc;
  dedup_int8_kernel<<<static_cast<unsigned>(t), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, d, static_cast<const float*>(scales),
      static_cast<const int*>(sorted_ids), static_cast<const int*>(run_start),
      static_cast<const int*>(order), c, static_cast<const int*>(qc),
      static_cast<const float*>(qs), static_cast<const float*>(q2),
      static_cast<float*>(out), ip != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
