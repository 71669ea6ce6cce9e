// Ball query: the first nsample dataset points, in index order, within a
// radius of each query, with optional distances and an in-kernel choice of
// the select_smallest nearest of them.
//
// Replaces query_ball_pallas (dispu_tpu/ops/pallas_kernels.py).  For each
// query q of cloud b, point j is a hit when d < r2[b], with
// d = max((q2 - 2 q.p) + p2, 0) in the JAX association.  Slots take the
// hits in ascending j; slots past the hit count repeat the first hit (index
// 0 and distance 0 for an empty ball); the count is capped at nsample.
// select_smallest = s returns idx[slot] for the s lexicographically
// smallest (d, slot) over all nsample slots, pad slots included, which is
// the order of top_k(-dists, s) followed by take_along(idx, .).
//
// What bounds it on an H100: by the card's rates, its operations.  At the
// repulsion loss's shape (28 clouds x 1024 queries x 1024 points, c = 3,
// r = 0.07, nsample 20) a ball holds a few points, so every query scans
// the whole cloud: 29 M distances, 0.35 GFLOP (5 us at the f32 rate),
// against 0.7 MB in and 3 MB out.  This first kernel is far from that
// bound: each warp walks its query's points in order.
// Design: one block per (cloud, tile of 16 queries), one warp per query.
// The block stages the cloud's points in shared memory when they fit
// (48 KB at n = 4096, c = 3) and reads them from device memory (through
// L1/L2) when they do not.  The warp walks the points 32 at a time;
// __ballot_sync and the popcount of the lanes below give each hit its
// slot, so hits land in index order, and the warp stops once nsample hits
// are found (the count is capped, so nothing later can change the
// result).  The selection is s rounds of a lexicographic (d, slot) minimum
// over the <= 128 slots held in shared memory, reduced with shuffles.
//
// Distances use round-to-nearest intrinsics for the final association, as
// knn.cu does, so nvcc cannot contract q2 - 2qp + p2 into an FMA.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 4096;
constexpr int kMaxC = 128;
constexpr int kMaxNsample = 128;  // 4 slots a lane in the selection
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

__global__ void __launch_bounds__(kThreads)
ball_kernel(const float* __restrict__ points, const float* __restrict__ queries,
            const float* __restrict__ r2, int* __restrict__ idx,
            int* __restrict__ cnt, float* __restrict__ dists,
            int* __restrict__ sel, int n, int m, int c, int nsample, int s,
            int staged) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cloud = blockIdx.y;
  const float* pts = points + cloud * n * c;
  if (staged) {
    for (int e = threadIdx.x; e < n * c; e += kThreads) smem[e] = pts[e];
    __syncthreads();  // the only block barrier: before any warp leaves
    pts = smem;
  }
  float* q = smem + (staged ? n * c : 0) + warp * (c + 2 * nsample);
  int* s_idx = reinterpret_cast<int*>(q + c);
  float* s_d = q + c + nsample;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= m) return;
  const long long qrow = cloud * m + row;

  for (int t = lane; t < c; t += 32) q[t] = queries[qrow * c + t];
  __syncwarp();
  float q2 = 0.f;
  for (int t = 0; t < c; ++t) q2 = fmaf(q[t], q[t], q2);
  const float rr = r2[cloud];

  int found = 0;  // hits so far, the same in every lane
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    bool hit = false;
    float d = 0.f;
    if (j < n) {
      const float* p = pts + (size_t)j * c;
      float qp = 0.f, p2 = 0.f;
      for (int t = 0; t < c; ++t) {
        const float pv = p[t];
        qp = fmaf(q[t], pv, qp);
        p2 = fmaf(pv, pv, p2);
      }
      d = fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, qp)), p2), 0.f);
      hit = d < rr;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int slot = found + __popc(ballot & ((1u << lane) - 1u));
      if (slot < nsample) {
        s_idx[slot] = j;
        s_d[slot] = d;
      }
    }
    found += __popc(ballot);
    if (found >= nsample) break;
  }
  __syncwarp();
  const int got = found < nsample ? found : nsample;
  // slot 0 is a hit whenever got > 0, so no lane writes it below
  const int first = got > 0 ? s_idx[0] : 0;
  const float d_first = got > 0 ? s_d[0] : 0.f;
  __syncwarp();
  for (int t = got + lane; t < nsample; t += 32) {
    s_idx[t] = first;
    s_d[t] = d_first;
  }
  __syncwarp();
  for (int t = lane; t < nsample; t += 32) {
    idx[qrow * nsample + t] = s_idx[t];
    if (dists) dists[qrow * nsample + t] = s_d[t];
  }
  if (lane == 0) cnt[qrow] = got;
  if (!sel) return;

  unsigned taken = 0;  // bit u: slot lane + 32u is already selected
  for (int r = 0; r < s; ++r) {
    float bv = __int_as_float(0x7f800000);
    int bt = INT_MAX;
#pragma unroll
    for (int u = 0; u < kMaxNsample / 32; ++u) {
      const int t = lane + 32 * u;
      if (t < nsample && !((taken >> u) & 1u)) {
        const float v = s_d[t];
        if (v < bv) { bv = v; bt = t; }  // ascending t: strict < keeps the lowest
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ot = __shfl_xor_sync(0xffffffffu, bt, off);
      if (lex_less(ov, ot, bv, bt)) { bv = ov; bt = ot; }
    }
    // bt == INT_MAX only when every distance left is +inf or NaN (an
    // overflowed input): then nothing is marked and index 0 is written
    if (bt < nsample && (bt & 31) == lane) taken |= 1u << (bt >> 5);
    if (lane == 0) sel[qrow * s + r] = bt < nsample ? s_idx[bt] : 0;
  }
}

}  // namespace

// points (b, n, c), queries (b, m, c), r2 (b,): f32, contiguous.  idx
// (b, m, nsample) and cnt (b, m) int32; dists (b, m, nsample) f32 or null;
// sel (b, m, s) int32, null exactly when s == 0.
extern "C" int dispu_query_ball(const float* points, const float* queries,
                                const float* r2, int* idx, int* cnt,
                                float* dists, int* sel, int b, int n, int m,
                                int c, int nsample, int s, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || n > kMaxN || m < 1 || c < 1 ||
      c > kMaxC || nsample < 1 || nsample > kMaxNsample || s < 0 ||
      s > nsample || ((sel == nullptr) != (s == 0)))
    return (int)cudaErrorInvalidValue;
  const size_t per_warp = (size_t)(c + 2 * nsample) * sizeof(float);
  const size_t stage = (size_t)n * c * sizeof(float);
  const int staged = stage + kWarps * per_warp <= kMaxSmem ? 1 : 0;
  const size_t smem = (staged ? stage : 0) + kWarps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      ball_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + kWarps - 1) / kWarps), (unsigned)b);
  ball_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      points, queries, r2, idx, cnt, dists, sel, n, m, c, nsample, s, staged);
  return (int)cudaGetLastError();
}
