// Fused gather + int8 distance, eight lanes per candidate, every row of a
// block in flight at once.
//
// Replaces: src/repro/quant/kernels.py::int8dist_rowgather (the Pallas
// _rowgather_int8_kernel: one (1, d) int8 code row and its (1, 1) scale per
// grid step, both addressed by a scalar-prefetched candidate id).
//
// Computes out[b, c] for a (N, d) int8 codes table with (N, 1) f32
// per-vector scales, (B, C) int32 ids and the query side prepared once per
// call by the wrapper (quant/kernels.py::query_meta): int32 query codes
// qc (B, d), their scale qs (B, 1) and ||q||^2 q2 (B, 1).  The code dot
// c . qc and ||c||^2 accumulate in int32 (exact in any order), then
// int8_epilogue() rescales once: ip -> -(s qs) acc, l2 ->
// max(s^2 ||c||^2 - 2 xq + q2, 0), so the kernel equals int8dist_ref and
// dedupdist_int8 bit for bit.  Ids >= N give +inf; negative ids read row 0.
//
// Bound on an H100: device-memory bytes.  Each candidate reads a d-byte
// code row (128 B at d = 128, a quarter of the f32 row) plus a 4-byte scale,
// and does ~4 integer ops per byte.  What holds a call back is the chain of
// dependent memory round trips, not the bytes.
//
// Design: the chain is two round trips.  A block serves kRows = 32
// candidates: a slice of 32 of one query's candidates, or, for C < 32, the
// whole rows of a few queries (quant/kernels.py::rowgather_int8_plan), so
// its ids are one contiguous span; the grid is 1-D, so no grid dimension
// limits B.  Each run of 8 lanes (a segment) owns one
// candidate; a warp's four segments load four consecutive ids in one
// instruction.  Step 1 issues together the query codes' cp.async into shared
// memory, the ids and each segment's qs[b] and q2[b].  Step 2, as soon as a
// segment has its id: its 8 lanes load the whole row as 16-byte words
// (8 lanes x 16 B = one 128-byte row, so one warp instruction reads four
// rows; up to kWords words a lane are in flight before any reduction) and
// lane 0 of the segment loads the row's scale.  Only then does the block
// wait for the query codes, reduce the integer sums (||c||^2 by __dp4a) and
// add them across the segment by three shuffles.  Tables whose d is not a
// multiple of 16, or that are not 16-byte aligned (vec = 0), are read one
// code at a time with the same layout.
#include "int8_dist.cuh"

namespace repro_torch {

constexpr int kThreads = 256;  // 8 warps
constexpr int kSegLanes = 8;   // lanes per candidate
constexpr int kRows = kThreads / kSegLanes;  // candidates per block
constexpr int kWords = 8;      // 16-byte code words a lane holds at once

__device__ __forceinline__ int seg_sum(int v) {
#pragma unroll
  for (int off = kSegLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// acc += the 4 codes packed in v against q; rn2 += their squares
__device__ __forceinline__ void quad_dot(int v, const int4 q, int& acc, int& rn2) {
  acc += static_cast<signed char>(v) * q.x + static_cast<signed char>(v >> 8) * q.y +
         static_cast<signed char>(v >> 16) * q.z + (v >> 24) * q.w;
  rn2 = __dp4a(v, v, rn2);
}

// acc += the 16 codes of word w against qc[0, 16); rn2 += their squares
__device__ __forceinline__ void word_dot(const int4 w, const int* qc, int& acc, int& rn2) {
  const int4* q = reinterpret_cast<const int4*>(qc);
  quad_dot(w.x, q[0], acc, rn2);
  quad_dot(w.y, q[1], acc, rn2);
  quad_dot(w.z, q[2], acc, rn2);
  quad_dot(w.w, q[3], acc, rn2);
}

__global__ void __launch_bounds__(kThreads)
rowgather_int8_kernel(const int8_t* __restrict__ codes, long long n, int d,
                      const float* __restrict__ scales, const int* __restrict__ ids,
                      long long bsz, long long c, const int* __restrict__ qc,
                      const float* __restrict__ qs, const float* __restrict__ q2,
                      float* __restrict__ out, bool ip, bool vec, long long slices, int slice,
                      int qpb, long long first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* qsh = reinterpret_cast<int*>(smem_raw);  // qpb rows of d query codes
  const int lane = threadIdx.x & 31;
  const int sl = lane & (kSegLanes - 1);
  const int t = threadIdx.x / kSegLanes;  // the block's candidate of this segment
  const int qi = t / slice;
  const long long blk = first + blockIdx.x;  // slice blk % slices of query group blk / slices
  const long long gy = blk / slices;
  const long long b0 = gy * qpb;
  const long long b = b0 + qi;
  const long long cc = (blk - gy * slices) * slice + (t - qi * slice);
  const bool live = qi < qpb && b < bsz && cc < c;

  // step 1: query codes -> shared memory, ids, query scales and norms
  const long long nq = bsz - b0 < qpb ? bsz - b0 : qpb;
  if (vec) {
    for (long long k = threadIdx.x * 4LL; k < nq * d; k += kThreads * 4LL)
      cp_async16(qsh + k, qc + b0 * d + k);
  } else {
    for (long long k = threadIdx.x; k < nq * d; k += kThreads) qsh[k] = qc[b0 * d + k];
  }
  const int id = live ? ids[b * c + cc] : static_cast<int>(n);
  const float qscale = live ? qs[b] : 0.f;
  const float qnorm = live ? q2[b] : 0.f;

  // step 2: the whole row and its scale, then the reduction
  const bool valid = id < n;
  const int8_t* row = codes + safe_row(id) * d;
  const float scale = valid && sl == 0 ? scales[safe_row(id)] : 0.f;
  const int* qrow = qsh + static_cast<long long>(qi < qpb ? qi : 0) * d;
  int acc = 0, rn2 = 0;
  if (vec) {
    const int n_words = d / 16;
    for (int w0 = 0;; w0 += kSegLanes * kWords) {
      int4 x[kWords] = {};
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int w = w0 + sl + kSegLanes * j;
        if (valid && w < n_words) x[j] = *reinterpret_cast<const int4*>(row + 16 * w);
      }
      if (w0 == 0) {
        cp_async_wait_all();
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int w = w0 + sl + kSegLanes * j;
        if (valid && w < n_words) word_dot(x[j], qrow + 16 * w, acc, rn2);
      }
      if (w0 + kSegLanes * kWords >= n_words) break;
    }
  } else {
    __syncthreads();
    if (valid) {
      for (int i = sl; i < d; i += kSegLanes) {
        const int x = row[i];
        acc += x * qrow[i];
        rn2 += x * x;
      }
    }
  }
  acc = seg_sum(acc);
  rn2 = seg_sum(rn2);
  if (live && sl == 0)
    out[b * c + cc] = valid ? int8_epilogue(acc, rn2, scale, qscale, qnorm, ip) : f32_inf();
}

}  // namespace repro_torch

extern "C" int rowgather_int8_launch(const void* codes, long long n, int d,
                                     const void* scales, const void* ids, long long b,
                                     long long c, const void* qc, const void* qs,
                                     const void* q2, void* out, int ip, int vec, long long blocks,
                                     long long slices, int slice, int qpb, long long smem,
                                     void* stream) {
  using namespace repro_torch;
  // the plan (quant/kernels.py::rowgather_int8_plan) must fit a block's
  // kRows candidates and this layout: a 1-D grid of `slices` blocks for each
  // group of qpb queries
  const bool ok = slice >= 1 && qpb >= 1 && slice * qpb <= kRows && (qpb == 1 || slice == c) &&
                  slices == (c + slice - 1) / slice && blocks == slices * ((b + qpb - 1) / qpb) &&
                  smem == static_cast<long long>(qpb) * d * 4 && smem <= 232448 && b >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = set_smem(reinterpret_cast<const void*>(&rowgather_int8_kernel),
                        static_cast<size_t>(smem)))
    return rc;
  return launch_blocks(blocks, [&](long long first, unsigned count) {
    rowgather_int8_kernel<<<count, kThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes), n, d, static_cast<const float*>(scales),
        static_cast<const int*>(ids), b, c, static_cast<const int*>(qc),
        static_cast<const float*>(qs), static_cast<const float*>(q2), static_cast<float*>(out),
        ip != 0, vec != 0, slices, slice, qpb, first);
  });
}
