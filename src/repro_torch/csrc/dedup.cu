// Batch-deduplicating gather + distance: each distinct row of a tile once.
//
// Replaces: src/repro/kernels/dedup.py::dedupdist (the Pallas _dedup_kernel
// on a (T, B) grid: every unique row against every query of the batch, then a
// scatter back to (B, C), on a sort/unique plan built outside the kernel).
//
// Computes the same (B, C) distances as rowgather.cu, bit for bit, from the
// (B, C) int32 ids themselves: ids >= N give +inf, a negative id reads row 0.
// One launch per call; nothing is prepared outside it.
//
// Bound on an H100: device-memory bytes of the DISTINCT rows, the ids, the
// queries and the output (at the speedann step, 512 x 32 lanes with ~12k
// distinct 512-byte rows: ~6.6 MB, ~2 us at 3.35 TB/s).
//
// Design: tile-local dedup in shared memory (dedup_tile.cuh).  A block takes
// `tile` consecutive flat lanes b*C + c: whole rows of the grid when C <= tile
// (consecutive walkers of one query), a part of one row otherwise.  It saves
// reads only where ids repeat within a tile; on the speedann step a 32-lane
// tile is one walker's 32 distinct neighbours, so it finds almost none there
// (PERF.md, open questions).  It dedups the tile's ids in a
// shared-memory hash table, then stages each distinct row once and the tile's
// query rows, all with cp.async, and takes one barrier.  Its warps then take
// the tile's lanes round-robin, each reducing its row against its query from
// shared memory with pair_dist(), whose per-lane order rowgather.cu keeps.  The
// work of a block is bounded by its tile, so a hot id with hundreds of lanes
// cannot serialise one warp; the kernel needs no global workspace, atomics in
// device memory or plan.  Duplicates across tiles are left to the 50 MB L2.
// The wrapper (kernels/dedup.py::tile_lanes) sizes the tile: 32 lanes, the
// most the 64-slot table takes (on an H100, 32-lane tiles ran faster than
// 64- or 128-lane ones at the speedann step: 512 blocks keep more warps in
// flight than 128 on 132 SMs, for ~10% more staged rows), fewer when its rows
// and query rows would not fit the block's dynamic shared memory with at
// least two blocks per SM.
#include "dedup_tile.cuh"

namespace repro_torch {

// dynamic shared memory: the tile's query rows (f32), then its distinct rows
__host__ __device__ inline size_t rows_offset(int nq, int d) {
  return align16(static_cast<size_t>(nq) * d * sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kDedupThreads)
dedup_kernel(const T* __restrict__ table, long long n, int d, const int* __restrict__ ids,
             long long total, long long c, int tile, int nq_max,
             const float* __restrict__ queries, float* __restrict__ out, bool ip, bool vec,
             long long first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ TileTable t;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  T* rows_s = reinterpret_cast<T*>(smem_raw + rows_offset(nq_max, d));

  const long long p0 = (first + blockIdx.x) * tile;
  const int cnt = static_cast<int>(total - p0 < tile ? total - p0 : tile);
  const int slot = dedup_tile(t, ids, p0, cnt, n);
  const long long b0 = p0 / c;
  const int nq = static_cast<int>((p0 + cnt - 1) / c - b0 + 1);
  stage_span(q_s, queries + b0 * d, static_cast<long long>(nq) * d * sizeof(float), vec);
  stage_rows(rows_s, table, n, d, t.rows, t.n_rows, vec);
  cp_async_wait_all();
  if (threadIdx.x < cnt) t.lane_row[threadIdx.x] = slot < 0 ? -1 : t.val[slot];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < cnt; i += kDedupThreads / 32) {
    const int u = t.lane_row[i];
    const long long p = p0 + i;
    float dist = f32_inf();
    if (u >= 0)
      dist = pair_dist(rows_s + static_cast<long long>(u) * d, q_s + (p / c - b0) * d, d, ip,
                       vec, lane);
    if (lane == 0) out[p] = dist;
  }
}

template <typename T>
int launch(const void* table, long long n, int d, const int* ids, long long b, long long c,
           int tile, const float* queries, float* out, int ip, int vec, cudaStream_t stream) {
  const int nq = tile_query_rows(tile, b, c);
  const size_t smem = rows_offset(nq, d) + static_cast<size_t>(tile) * d * sizeof(T);
  static size_t allowed = 0;
  if (int rc = dedup_prepare(reinterpret_cast<const void*>(&dedup_kernel<T>), tile, smem,
                             allowed))
    return rc;
  const long long total = b * c;
  return launch_blocks((total + tile - 1) / tile, [&](long long first, unsigned count) {
    dedup_kernel<T><<<count, kDedupThreads, smem, stream>>>(
        static_cast<const T*>(table), n, d, ids, total, c, tile, nq, queries, out, ip != 0,
        vec != 0, first);
  });
}

}  // namespace repro_torch

extern "C" int dedup_launch(const void* table, int table_bf16, long long n, int d,
                            const void* ids, long long b, long long c, int tile,
                            const void* queries, void* out, int ip, int vec, void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return repro_torch::launch<__nv_bfloat16>(table, n, d, i, b, c, tile, q, o, ip, vec, s);
  return repro_torch::launch<float>(table, n, d, i, b, c, tile, q, o, ip, vec, s);
}
