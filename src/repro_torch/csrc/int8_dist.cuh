// Shared device code of the int8 gather-distance kernels (rowgather_int8.cu,
// dedup_int8.cu): the warp's integer reduction of one int8 code row against
// int32 query codes (dedup_int8.cu; rowgather_int8.cu reduces a row over 8
// lanes), and the one f32 rescale that turns it into a distance.
//
// The integer sums (c . c_q and ||c||^2) are exact in any order: the query
// codes live on codec.query_levels(d), which keeps 127 * levels * d below
// 2^31.  So the only place two kernels, or a kernel and the plain torch
// version (quant/kernels.py::int8dist_ref), could part is the float
// epilogue.  int8_epilogue() rounds each operation on its own with the _rn
// intrinsics, in the reference's order, so nvcc cannot contract any of it
// into an FMA; both kernels call it and agree bit for bit with the plain
// version, whose torch ops each round once.
#pragma once

#include "pair_dist.cuh"

namespace repro_torch {

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// c . c_q and ||c||^2 of one int8 row against int32 query codes, reduced by
// the whole warp; every lane returns both.  vec: d is a multiple of 16 and
// row and qc are 16-byte aligned, so each lane reads 4 codes (one 32-bit
// word) and 4 query codes (16 bytes) at a time; otherwise one element each.
__device__ __forceinline__ void int8_pair(const int8_t* row, const int* qc, int d,
                                          bool vec, int lane, int& acc_out,
                                          int& rn2_out) {
  int acc = 0;
  int rn2 = 0;
  if (vec) {
    for (int i = lane * 4; i < d; i += 32 * 4) {
      const char4 x = *reinterpret_cast<const char4*>(row + i);
      const int4 q = *reinterpret_cast<const int4*>(qc + i);
      acc += x.x * q.x + x.y * q.y + x.z * q.z + x.w * q.w;
      rn2 += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const int x = row[i];
      acc += x * qc[i];
      rn2 += x * x;
    }
  }
  acc_out = warp_sum_int(acc);
  rn2_out = warp_sum_int(rn2);
}

// xq = (s * qs) * acc; ip -> -xq; l2 -> max(((s * s) * rn2 - 2 * xq) + q2, 0).
// The reference's op order (src/repro/quant/kernels.py, _rowgather_int8_kernel),
// every product and sum rounded separately.
__device__ __forceinline__ float int8_epilogue(int acc, int rn2, float s, float qs,
                                               float q2, bool ip) {
  const float xq = __fmul_rn(__fmul_rn(s, qs), __int2float_rn(acc));
  if (ip) return -xq;
  const float x2 = __fmul_rn(__fmul_rn(s, s), __int2float_rn(rn2));
  const float t = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xq)), q2);
  return t < 0.f ? 0.f : t;
}

}  // namespace repro_torch
