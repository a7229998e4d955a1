// Batch-deduplicating gather + int8 distance: each distinct code row of a
// tile once.
//
// Replaces: src/repro/kernels/dedup.py::dedupdist_int8 (the Pallas
// _dedup_int8_kernel on a (T, B) grid: every unique int8 row and its scale
// against every query of the batch, then a scatter back to (B, C), on a
// sort/unique plan built outside the kernel).
//
// Computes the same (B, C) distances as rowgather_int8.cu, bit for bit, from
// the (B, C) int32 ids themselves (ids >= N give +inf, a negative id reads
// row 0) and the query side (qc, qs, q2) of quant/kernels.py::query_meta,
// which the caller computes once per queries tensor.  One launch per call.
//
// Bound on an H100: device-memory bytes of the DISTINCT code rows (d bytes
// each plus a 4-byte scale), the ids, the query side and the output, so the
// 4x payload cut of int8 compounds with the dedup factor.
//
// Design: dedup.cu's tile-local dedup in shared memory (dedup_tile.cuh).  A
// block dedups its tile's ids in a shared-memory hash table, stages each
// distinct code row and its scale once, and the tile's query codes, scales and
// norms, all with cp.async, takes one barrier, and its warps take the lanes
// round-robin through int8_pair() / int8_epilogue(), the reduction and the
// rescale of rowgather_int8.cu.  No plan, no global workspace.
#include "dedup_tile.cuh"
#include "int8_dist.cuh"

namespace repro_torch {

// dynamic shared memory, in order: the tile's query codes (int32), their
// scales and norms (f32), the distinct rows' scales (f32), the distinct code
// rows (d bytes each, from a 16-byte boundary)
struct Int8Layout {
  size_t qs, q2, scale, rows, total;
  __host__ __device__ Int8Layout(int nq, int tile, int d) {
    qs = static_cast<size_t>(nq) * d * sizeof(int);
    q2 = qs + nq * sizeof(float);
    scale = q2 + nq * sizeof(float);
    rows = align16(scale + tile * sizeof(float));
    total = rows + static_cast<size_t>(tile) * d;
  }
};

__global__ void __launch_bounds__(kDedupThreads)
dedup_int8_kernel(const int8_t* __restrict__ codes, long long n, int d,
                  const float* __restrict__ scales, const int* __restrict__ ids,
                  long long total, long long c, int tile, int nq_max,
                  const int* __restrict__ qc, const float* __restrict__ qs,
                  const float* __restrict__ q2, float* __restrict__ out, bool ip, bool vec,
                  long long first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ TileTable t;
  const Int8Layout lay(nq_max, tile, d);
  int* qc_s = reinterpret_cast<int*>(smem_raw);
  float* qs_s = reinterpret_cast<float*>(smem_raw + lay.qs);
  float* q2_s = reinterpret_cast<float*>(smem_raw + lay.q2);
  float* scale_s = reinterpret_cast<float*>(smem_raw + lay.scale);
  int8_t* rows_s = reinterpret_cast<int8_t*>(smem_raw + lay.rows);

  const long long p0 = (first + blockIdx.x) * tile;
  const int cnt = static_cast<int>(total - p0 < tile ? total - p0 : tile);
  const int slot = dedup_tile(t, ids, p0, cnt, n);
  const long long b0 = p0 / c;
  const int nq = static_cast<int>((p0 + cnt - 1) / c - b0 + 1);
  stage_span(qc_s, qc + b0 * d, static_cast<long long>(nq) * d * sizeof(int), vec);
  stage_span(qs_s, qs + b0, nq * sizeof(float), false);
  stage_span(q2_s, q2 + b0, nq * sizeof(float), false);
  for (int u = threadIdx.x; u < t.n_rows; u += blockDim.x) cp_async4(&scale_s[u], &scales[t.rows[u]]);
  stage_rows(rows_s, codes, n, d, t.rows, t.n_rows, vec);
  cp_async_wait_all();
  if (threadIdx.x < cnt) t.lane_row[threadIdx.x] = slot < 0 ? -1 : t.val[slot];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < cnt; i += kDedupThreads / 32) {
    const int u = t.lane_row[i];
    const long long p = p0 + i;
    float dist = f32_inf();
    if (u >= 0) {
      const int qi = static_cast<int>(p / c - b0);
      int acc, rn2;
      int8_pair(rows_s + static_cast<long long>(u) * d, qc_s + static_cast<long long>(qi) * d,
                d, vec, lane, acc, rn2);
      dist = int8_epilogue(acc, rn2, scale_s[u], qs_s[qi], q2_s[qi], ip);
    }
    if (lane == 0) out[p] = dist;
  }
}

}  // namespace repro_torch

extern "C" int dedup_int8_launch(const void* codes, long long n, int d, const void* scales,
                                 const void* ids, long long b, long long c, int tile,
                                 const void* qc, const void* qs, const void* q2, void* out,
                                 int ip, int vec, void* stream) {
  using namespace repro_torch;
  const int nq = tile_query_rows(tile, b, c);
  const size_t smem = Int8Layout(nq, tile, d).total;
  static size_t allowed = 0;
  if (int rc = dedup_prepare(reinterpret_cast<const void*>(&dedup_int8_kernel), tile, smem,
                             allowed))
    return rc;
  const long long total = b * c;
  return launch_blocks((total + tile - 1) / tile, [&](long long first, unsigned count) {
    dedup_int8_kernel<<<count, kDedupThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes), n, d, static_cast<const float*>(scales),
        static_cast<const int*>(ids), total, c, tile, nq, static_cast<const int*>(qc),
        static_cast<const float*>(qs), static_cast<const float*>(q2), static_cast<float*>(out),
        ip != 0, vec != 0, first);
  });
}
