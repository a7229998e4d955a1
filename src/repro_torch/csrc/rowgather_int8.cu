// Fused gather + int8 distance, one warp per candidate.
//
// Replaces: src/repro/quant/kernels.py::int8dist_rowgather (the Pallas
// _rowgather_int8_kernel: one (1, d) int8 code row and its (1, 1) scale per
// grid step, both addressed by a scalar-prefetched candidate id).
//
// Computes out[b, c] for a (N, d) int8 codes table with (N, 1) f32
// per-vector scales, (B, C) int32 ids and the query side prepared once per
// call by the wrapper (quant/kernels.py::query_meta): int32 query codes
// qc (B, d), their scale qs (B, 1) and ||q||^2 q2 (B, 1).  The code dot
// c . qc and ||c||^2 accumulate in int32 (exact), then int8_epilogue()
// rescales once: ip -> -(s qs) acc, l2 -> max(s^2 ||c||^2 - 2 xq + q2, 0).
// Ids >= N give +inf; negative ids read row 0.
//
// Bound on an H100: device-memory bytes.  Each candidate reads a d-byte
// code row (128 B at d = 128, a quarter of the f32 row) plus a 4-byte scale,
// and does ~4 integer ops per byte: the scattered row gather is the cost.
//
// Design: rowgather.cu's, with int8 rows.  A block serves one query b and
// kCandsPerBlock candidates; the query's int32 codes are staged once in
// shared memory.  Each warp takes one candidate at a time: at d = 128 its
// 32 lanes read the 128-byte row with one 4-byte load each, reduce the two
// integer sums by warp shuffle, and lane 0 reads the scale and writes the
// distance.  Padding ids skip the row load.
#include "int8_dist.cuh"

namespace repro_torch {

constexpr int kThreads = 256;       // 8 warps
constexpr int kCandsPerBlock = 32;  // 4 candidates per warp

__global__ void __launch_bounds__(kThreads)
rowgather_int8_kernel(const int8_t* __restrict__ codes, long long n, int d,
                      const float* __restrict__ scales, const int* __restrict__ ids,
                      long long c, const int* __restrict__ qc,
                      const float* __restrict__ qs, const float* __restrict__ q2,
                      float* __restrict__ out, bool ip, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* qsh = reinterpret_cast<int*>(smem_raw);
  const long long b = blockIdx.y;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qsh[i] = qc[b * d + i];
  __syncthreads();

  const float qscale = qs[b];
  const float qnorm = q2[b];
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
    const long long r = safe_row(id);
    int acc, rn2;
    int8_pair(codes + r * d, qsh, d, vec, lane, acc, rn2);
    if (lane == 0) out[b * c + cc] = int8_epilogue(acc, rn2, scales[r], qscale, qnorm, ip);
  }
}

}  // namespace repro_torch

extern "C" int rowgather_int8_launch(const void* codes, long long n, int d,
                                     const void* scales, const void* ids, long long b,
                                     long long c, const void* qc, const void* qs,
                                     const void* q2, void* out, int ip, int vec,
                                     void* stream) {
  using namespace repro_torch;
  const size_t smem = static_cast<size_t>(d) * sizeof(int);
  if (int rc = set_smem(reinterpret_cast<const void*>(&rowgather_int8_kernel), smem))
    return rc;
  const dim3 grid(static_cast<unsigned>((c + kCandsPerBlock - 1) / kCandsPerBlock),
                  static_cast<unsigned>(b));
  rowgather_int8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, d, static_cast<const float*>(scales),
      static_cast<const int*>(ids), c, static_cast<const int*>(qc),
      static_cast<const float*>(qs), static_cast<const float*>(q2),
      static_cast<float*>(out), ip != 0, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
