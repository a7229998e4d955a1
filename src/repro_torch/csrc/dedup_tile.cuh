// Shared device code of the two dedup kernels (dedup.cu, dedup_int8.cu): the
// block's tile of lanes, deduplicated in shared memory, and the asynchronous
// copies that stage the tile's distinct rows and query rows.
//
// A block owns the contiguous flat lanes [p0, p0 + cnt) of the (B, C) id grid
// (cnt <= tile <= kMaxTile, one thread per lane).  Each lane with a valid id
// (id < n) claims its table row (safe_row(id): a negative id reads row 0) in
// an open-addressing table of kSlots slots in shared memory: atomicCAS on the
// slot's key, linear probing, and the claimer takes the row's index among the
// tile's distinct rows with an atomicAdd.  Which lane claims, and so where a
// row sits in shared memory, depends on scheduling; the distances do not,
// because every lane reduces the same row bytes with the same per-pair code.
#pragma once

#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kDedupThreads = 256;  // 8 warps; at least kMaxTile
constexpr int kMaxTile = 32;        // lanes per block, at most (kernels/dedup.py TILE_LANES)
constexpr int kSlotBits = 6;
constexpr int kSlots = 1 << kSlotBits;  // load factor <= 1/2

// The slot a row's probe starts at (Fibonacci hashing: the top kSlotBits bits
// of row * 2654435761 mod 2^32).
__device__ __forceinline__ int home_slot(int row) {
  return static_cast<int>((static_cast<unsigned>(row) * 2654435761u) >> (32 - kSlotBits));
}

struct TileTable {
  int key[kSlots];         // the table row in the slot, -1 when empty
  int val[kSlots];         // its index among the tile's distinct rows
  int lane_row[kMaxTile];  // per lane: the index of its row, -1 for padding
  int rows[kMaxTile];      // the tile's distinct table rows, in claim order
  int n_rows;
};

// Deduplicate the ids of lanes [p0, p0 + cnt).  On return (after a barrier)
// t.rows[0, t.n_rows) are the tile's distinct table rows; each thread i < cnt
// holds in `slot` the slot of its lane's row (-1 when id >= n).  The caller
// writes t.lane_row from t.val[slot] and synchronises before reading it.
__device__ __forceinline__ int dedup_tile(TileTable& t, const int* __restrict__ ids,
                                          long long p0, int cnt, long long n) {
  const int id = threadIdx.x < cnt ? ids[p0 + threadIdx.x] : -1;
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) t.key[s] = -1;
  if (threadIdx.x == 0) t.n_rows = 0;
  __syncthreads();
  int slot = -1;
  if (threadIdx.x < cnt && id < n) {
    const int row = static_cast<int>(safe_row(id));
    slot = home_slot(row);
    for (;;) {
      const int prev = atomicCAS(&t.key[slot], -1, row);
      if (prev == -1) {
        const int u = atomicAdd(&t.n_rows, 1);
        t.val[slot] = u;
        t.rows[u] = row;
        break;
      }
      if (prev == row) break;
      slot = (slot + 1) & (kSlots - 1);
    }
  }
  __syncthreads();
  return slot;
}

// 4-byte asynchronous global -> shared copy (through L1)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Start the copy of `bytes` contiguous bytes (a multiple of 4; of 16 with both
// ends 16-byte aligned when vec) into shared memory, by the whole block.  The
// caller waits with cp_async_wait_all().
__device__ __forceinline__ void stage_span(void* dst, const void* src, long long bytes,
                                           bool vec) {
  const int step = vec ? 16 : 4;
  for (long long k = static_cast<long long>(threadIdx.x) * step; k < bytes;
       k += static_cast<long long>(blockDim.x) * step) {
    char* to = static_cast<char*>(dst) + k;
    const char* from = static_cast<const char*>(src) + k;
    if (vec)
      cp_async16(to, from);
    else
      cp_async4(to, from);
  }
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Query rows a tile of `tile` lanes can span in a grid of C columns and B rows.
__host__ __device__ inline int tile_query_rows(int tile, long long b, long long c) {
  const long long q = (tile + c - 2) / c + 1;
  return static_cast<int>(q < b ? q : b);
}

// Check a launch's tile and let `kernel` take `smem` bytes of dynamic shared
// memory beside its static TileTable (raised only when a launch needs more than
// `allowed`, the most granted so far): 0, or the CUDA error that refuses it.
inline int dedup_prepare(const void* kernel, int tile, size_t smem, size_t& allowed) {
  if (tile < 1 || tile > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= allowed) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc == 0) allowed = smem;
  return rc;
}

}  // namespace repro_torch
