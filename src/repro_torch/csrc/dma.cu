// Tile gather with cp.async + FMA matvec in the expanded form.
//
// Replaces: src/repro/kernels/l2dist.py::l2dist_dma (the Pallas _dma_kernel:
// G explicit row DMAs into a VMEM tile, then an MXU (G, d) x (d,) matvec).
//
// Computes, per (query b, tile of G candidates), l2 as
// max(|x|^2 - 2 x.q + |q|^2, 0) and ip (and cosine) as -x.q, all in f32;
// ids >= N give +inf and negative ids read row 0, as in rowgather.cu.  A
// ragged last tile (C % G != 0) is masked here, so callers need not pad.
//
// Bound on an H100: device-memory bytes, as for rowgather (0.75-1.1 flop
// per byte gathered).  No tensor cores: a (G, d) x (d,) matvec has nothing
// for wgmma to reuse, and TF32 would miss the 1e-5 parity bar.
//
// Design: one block per (b, tile).  All threads issue the tile's row copies
// as 16-byte cp.async transfers into shared memory at once (the Hopper
// counterpart of the TPU's async DMAs: every row of the tile is in flight
// together, and the copies bypass registers), wait once, then each warp
// reduces one row against the query staged beside it: x.q, |x|^2 and |q|^2
// as three FMA chains and three warp-shuffle sums.  Padding rows are never
// copied.
#include "pair_dist.cuh"

namespace repro_torch {

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) & ~15; }

template <typename T>
__global__ void dma_kernel(const T* __restrict__ table, long long n, int d,
                           const int* __restrict__ ids, long long c,
                           const float* __restrict__ queries, float* __restrict__ out,
                           bool ip, bool vec, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  T* rows = reinterpret_cast<T*>(smem_raw + align16(d * static_cast<int>(sizeof(float))));
  const long long b = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * g;
  const int n_rows = static_cast<int>(c - c0 < g ? c - c0 : g);
  const int* tile_ids = ids + b * c + c0;

  stage_rows(rows, table, n, d, tile_ids, n_rows, vec);
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = queries[b * d + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < n_rows; r += n_warps) {
    const int id = tile_ids[r];
    float dist = f32_inf();
    if (id < n) {
      const T* x = rows + static_cast<long long>(r) * d;
      float xq = 0.f, x2 = 0.f, q2 = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float xv = to_f32(x[i]);
        const float qv = qs[i];
        xq = fmaf(xv, qv, xq);
        x2 = fmaf(xv, xv, x2);
        q2 = fmaf(qv, qv, q2);
      }
      xq = warp_sum(xq);
      if (ip) {
        dist = -xq;
      } else {
        x2 = warp_sum(x2);
        q2 = warp_sum(q2);
        dist = fmaxf(x2 - 2.f * xq + q2, 0.f);
      }
    }
    if (lane == 0) out[b * c + c0 + r] = dist;
  }
}

template <typename T>
int launch(const void* table, long long n, int d, const int* ids, long long b,
           long long c, const float* queries, float* out, int ip, int vec, int g,
           cudaStream_t stream) {
  const size_t smem = align16(d * static_cast<int>(sizeof(float))) +
                      static_cast<size_t>(g) * d * sizeof(T);
  if (int rc = set_smem(reinterpret_cast<const void*>(&dma_kernel<T>), smem)) return rc;
  const int threads = 32 * (g < 16 ? g : 16);
  const dim3 grid(static_cast<unsigned>((c + g - 1) / g), static_cast<unsigned>(b));
  dma_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(table), n, d, ids, c, queries, out, ip != 0, vec != 0, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int dma_launch(const void* table, int table_bf16, long long n, int d,
                          const void* ids, long long b, long long c, const void* queries,
                          void* out, int ip, int vec, int g, void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return repro_torch::launch<__nv_bfloat16>(table, n, d, i, b, c, q, o, ip, vec, g, s);
  return repro_torch::launch<float>(table, n, d, i, b, c, q, o, ip, vec, g, s);
}
