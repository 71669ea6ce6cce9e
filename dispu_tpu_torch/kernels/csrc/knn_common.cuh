// The distance row and the selection round shared by knn.cu and
// knn_group.cu, so that the two kernels return the same bits for the same
// inputs (knn_group_pallas's contract: its dists and idx are knn_pallas's).
//
// Layout: one warp per query row; the row's n distances and the query's c
// coordinates live in shared memory, (n + c) floats a warp.  The distance
// keeps the JAX association max((q2 - 2 q.p) + p2, 0) + bias[j] with
// explicit round-to-nearest intrinsics and explicit FMAs in the dot
// products, so nvcc has no contraction left to choose: every kernel that
// includes this header computes the same bits.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace knn_common {

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

// Distances of query row ``qrow`` to the cloud's n points into d[0, n); q
// (c floats of shared memory) receives the query.  Ends with a __syncwarp.
__device__ __forceinline__ void row_distances(const float* __restrict__ qrow,
                                              const float* __restrict__ pts,
                                              const float* __restrict__ bs,
                                              float* d, float* q, int n,
                                              int c, int lane) {
  for (int t = lane; t < c; t += 32) q[t] = qrow[t];
  __syncwarp();
  float q2 = 0.f;
  for (int t = 0; t < c; ++t) q2 = fmaf(q[t], q[t], q2);
  for (int j = lane; j < n; j += 32) {
    const float* p = pts + (size_t)j * c;
    float qp = 0.f, p2 = 0.f;
    for (int t = 0; t < c; ++t) {
      const float pv = p[t];
      qp = fmaf(q[t], pv, qp);
      p2 = fmaf(pv, pv, p2);
    }
    const float e = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, qp)), p2);
    d[j] = __fadd_rn(fmaxf(e, 0.f), bs[j]);
  }
  __syncwarp();
}

// One selection round: the lexicographic (distance, index) minimum of the
// row, the same in every lane after the butterfly.  Consumed entries hold
// +inf; bj stays INT_MAX only when every remaining distance is +inf (an
// overflowed input).
__device__ __forceinline__ void select_min(const float* d, int n, int lane,
                                           float& bv, int& bj) {
  bv = __int_as_float(0x7f800000);
  bj = INT_MAX;
  for (int j = lane; j < n; j += 32) {  // ascending j: strict < keeps the lowest
    const float v = d[j];
    if (v < bv) { bv = v; bj = j; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (lex_less(ov, oj, bv, bj)) { bv = ov; bj = oj; }
  }
}

// Knock the round's winner out of the row (lane 0), then meet the warp.
__device__ __forceinline__ void knock_out(float* d, int n, int lane, int bj) {
  if (lane == 0 && bj < n) d[bj] = __int_as_float(0x7f800000);
  __syncwarp();
}

// Warps per block and dynamic shared memory for rows of (n + c) floats;
// false when one row does not fit a block.
inline bool row_launch(int n, int c, int& warps, size_t& smem) {
  const size_t per_warp = (size_t)(n + c) * sizeof(float);
  if (per_warp > kMaxSmem) return false;
  warps = (int)(kMaxSmem / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  smem = per_warp * warps;
  return true;
}

}  // namespace knn_common
