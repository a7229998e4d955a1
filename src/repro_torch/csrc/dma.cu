// Bulk-copy gather of a query's candidate rows + FMA reduction in the
// expanded form.
//
// Replaces: src/repro/kernels/l2dist.py::l2dist_dma (the Pallas _dma_kernel:
// G explicit row DMAs into a VMEM tile, then an MXU (G, d) x (d,) matvec).
//
// Computes, per (query b, candidate c), l2 as max(|x|^2 - 2 x.q + |q|^2, 0)
// and ip (and cosine) as -x.q, all in f32; ids >= N give +inf and negative
// ids read row 0, as in rowgather.cu.  Any C is taken: the wrapper's tile g
// (the registry pads C to dma_group, as the reference does) does not shape
// this kernel, which masks its own ragged edge.
//
// Bound on an H100: device-memory bytes, as for rowgather (0.75-1.1 flop
// per byte gathered).  No tensor cores: a (G, d) x (d,) matvec has nothing
// for wgmma to reuse, and TF32 would miss the 1e-5 parity bar.
//
// Design: the whole call is one wave of blocks, and a block's only wait is
// the chain ids -> rows -> reduce -> store.  A block takes a run of at most
// 32 consecutive candidates of one query (kernels/l2dist.py::dma_plan sizes
// the runs so that the grid covers the SMs; at the speedann and topm steps
// it is 512 blocks, one wave); the grid is 1-D, `runs` blocks a query, so
// no grid dimension limits B.  It loads the run's ids once, coalesced, into
// shared memory while the query is staged beside them by cp.async and warp
// 0 sums |q|^2 once for the block.  Then one thread per valid row issues
// Hopper's 1-D bulk copy (cp.async.bulk ... complete_tx) of that row into
// shared memory, and all of a chunk's copies complete on one mbarrier armed
// with the valid rows' bytes: the card's counterpart of the TPU's per-row
// make_async_copy and semaphore.  Padding rows are never copied.  A run
// wider than one buffer is copied in chunks through two buffers, the next
// chunk in flight while the block reduces the current one (only wide rows
// need it: d = 960 f32).  Each warp reduces its four rows together, so the
// reduction after the wait is one pass: for each row lane l sums elements
// l, l + 32, ... as two FMA chains (x.q, |x|^2), then a warp-shuffle tree,
// the per-lane order of the earlier cp.async design, so the distances are
// the same bits.  Rows that are not whole 16-byte chunks, or a table or
// query that is not 16-byte aligned (vec = 0), are staged element by
// element.
#include "pair_dist.cuh"

namespace repro_torch {

constexpr int kDmaThreads = 256;   // 8 warps; also the most rows of a chunk
constexpr int kWarps = kDmaThreads / 32;
constexpr int kRowsPerWarp = 4;    // rows a warp reduces together
constexpr int kDmaHeader = 32;     // two mbarriers and |q|^2

__host__ __device__ inline long long dma_align16(long long x) { return (x + 15) / 16 * 16; }

// Shared memory of a block: the query (f32), the run's ids, the header,
// then `buffers` buffers of `chunk` rows of d elements.  Mirrored by
// kernels/l2dist.py::dma_plan.
__host__ __device__ inline long long dma_smem(int d, int elt, int run, int chunk, int buffers) {
  return dma_align16(4LL * d) + dma_align16(4LL * run) + kDmaHeader +
         static_cast<long long>(buffers) * chunk * d * elt;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kDmaThreads)
dma_kernel(const T* __restrict__ table, long long n, int d, const int* __restrict__ ids,
           long long c, const float* __restrict__ queries, float* __restrict__ out, bool ip,
           bool vec, long long runs, int run, int chunk, long long first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  int* run_ids = reinterpret_cast<int*>(smem_raw + dma_align16(4LL * d));
  unsigned char* header = reinterpret_cast<unsigned char*>(run_ids) + dma_align16(4LL * run);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(header);  // [2]
  float* q2_sh = reinterpret_cast<float*>(header + 16);
  T* buf = reinterpret_cast<T*>(header + kDmaHeader);
  const long long buf_elems = static_cast<long long>(chunk) * d;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long blk = first + blockIdx.x;  // run blk % runs of query blk / runs
  const long long b = blk / runs;
  const long long c0 = (blk - b * runs) * run;
  const int rows = static_cast<int>(c - c0 < run ? c - c0 : run);
  const float* q = queries + b * d;

  // step 1, all in flight together: the run's ids, the query, |q|^2
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int my_id = static_cast<int>(n);  // this thread's id of chunk 0
  for (int i = tid; i < rows; i += kDmaThreads) {
    const int id = ids[b * c + c0 + i];
    run_ids[i] = id;
    if (i == tid) my_id = id;
  }
  if (vec) {
    for (int k = tid * 4; k < d; k += kDmaThreads * 4) cp_async16(qs + k, q + k);
    cp_async_wait_all();
  } else {
    for (int k = tid; k < d; k += kDmaThreads) qs[k] = q[k];
  }
  if (!ip && warp == 0) {
    float q2 = 0.f;
    for (int i = lane; i < d; i += 32) q2 = fmaf(q[i], q[i], q2);
    q2 = warp_sum(q2);
    if (lane == 0) *q2_sh = q2;
  }

  const int n_chunks = (rows + chunk - 1) / chunk;
  const unsigned row_bytes = static_cast<unsigned>(d) * sizeof(T);
  // Issue chunk k into buffer k & 1: one bulk copy per valid row, by the
  // row's thread; thread 0 arms the buffer's mbarrier with the chunk's
  // bytes.  The count's barrier also retires every read of that buffer's
  // previous chunk (and, for chunk 0, publishes step 1).
  auto issue = [&](int k, int id) {
    const int base = k * chunk;
    const int n_rows = rows - base < chunk ? rows - base : chunk;
    const bool mine = tid < n_rows && id < n;
    const int n_valid = __syncthreads_count(mine);
    T* dst = buf + (k & 1) * buf_elems;
    if (mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(dst + static_cast<long long>(tid) * d, table + safe_row(id) * d, row_bytes,
                &bar[k & 1]);
    }
    if (tid == 0) mbar_arrive_expect_tx(&bar[k & 1], static_cast<unsigned>(n_valid) * row_bytes);
  };

  for (int k = 0; k < n_chunks; ++k) {
    const int base = k * chunk;
    const int n_rows = rows - base < chunk ? rows - base : chunk;
    T* x_buf = buf + (vec ? (k & 1) * buf_elems : 0);
    if (vec) {
      if (k == 0) issue(0, my_id);
      if (k + 1 < n_chunks) {
        const int nb = base + chunk;
        issue(k + 1, tid < rows - nb ? run_ids[nb + tid] : static_cast<int>(n));
      }
      mbar_wait(&bar[k & 1], (k >> 1) & 1);
    } else {
      __syncthreads();  // step 1 published; the previous chunk's reads done
      for (long long e = tid; e < static_cast<long long>(n_rows) * d; e += kDmaThreads) {
        const int r = static_cast<int>(e / d);
        const int id = run_ids[base + r];
        if (id < n) x_buf[e] = table[safe_row(id) * d + (e - static_cast<long long>(r) * d)];
      }
      __syncthreads();
    }
    // warp w reduces rows w, w + 8, w + 16, w + 24 of a pass together
    // (plans of up to 32-row chunks need one pass)
    for (int r0 = warp; r0 < n_rows; r0 += kWarps * kRowsPerWarp) {
      int id[kRowsPerWarp];
      float xq[2 * kRowsPerWarp] = {};  // x.q of each row, then |x|^2
      float* x2 = xq + kRowsPerWarp;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = r0 + kWarps * j;
        id[j] = r < n_rows ? run_ids[base + r] : static_cast<int>(n);
      }
      for (int i = lane; i < d; i += 32) {
        const float qv = qs[i];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (id[j] < n) {
            const float xv = to_f32(x_buf[static_cast<long long>(r0 + kWarps * j) * d + i]);
            xq[j] = fmaf(xv, qv, xq[j]);
            x2[j] = fmaf(xv, xv, x2[j]);
          }
        }
      }
      warp_sums(xq);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = r0 + kWarps * j;
        if (lane == 0 && r < n_rows)
          out[b * c + c0 + base + r] =
              id[j] >= n ? f32_inf() : ip ? -xq[j] : fmaxf(x2[j] - 2.f * xq[j] + *q2_sh, 0.f);
      }
    }
  }
}

template <typename T>
int launch(const void* table, long long n, int d, const int* ids, long long b, long long c,
           const float* queries, float* out, int ip, int vec, long long blocks, long long runs,
           int run, int chunk, int buffers, long long smem, cudaStream_t stream) {
  // the plan (kernels/l2dist.py::dma_plan) must cover C exactly once and
  // agree with this layout: a 1-D grid of `runs` blocks for each query
  const bool ok = run >= 1 && runs >= 1 && runs * run >= c && (runs - 1) * run < c &&
                  chunk >= 1 && chunk <= kDmaThreads &&
                  (buffers == 2 || (buffers == 1 && chunk >= run)) &&
                  smem == dma_smem(d, sizeof(T), run, chunk, buffers) && smem <= 232448 &&
                  b >= 1 && blocks == runs * b;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = set_smem(reinterpret_cast<const void*>(&dma_kernel<T>), static_cast<size_t>(smem)))
    return rc;
  return launch_blocks(blocks, [&](long long first, unsigned count) {
    dma_kernel<T><<<count, kDmaThreads, static_cast<size_t>(smem), stream>>>(
        static_cast<const T*>(table), n, d, ids, c, queries, out, ip != 0, vec != 0, runs, run,
        chunk, first);
  });
}

}  // namespace repro_torch

extern "C" int dma_launch(const void* table, int table_bf16, long long n, int d, const void* ids,
                          long long b, long long c, const void* queries, void* out, int ip,
                          int vec, long long blocks, long long runs, int run, int chunk,
                          int buffers, long long smem, void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return repro_torch::launch<__nv_bfloat16>(table, n, d, i, b, c, q, o, ip, vec, blocks, runs,
                                              run, chunk, buffers, smem, s);
  return repro_torch::launch<float>(table, n, d, i, b, c, q, o, ip, vec, blocks, runs, run,
                                    chunk, buffers, smem, s);
}
