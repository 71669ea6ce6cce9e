// Ball query: the first nsample dataset points, in index order, within a
// radius of each query, with optional distances and an in-kernel choice of
// the select_smallest nearest of them.
//
// Replaces query_ball_pallas (dispu_tpu/ops/pallas_kernels.py).  For each
// query q of cloud b, point j is a hit when d < r2[b], with
// d = max((q2 - 2 q.p) + p2, 0) in the JAX association: q2, q.p and p2
// each one fmaf chain over the coordinates t = 0 .. c-1 in ascending order
// from 0.f, then round-to-nearest intrinsics, so nvcc has no contraction
// left to choose.  Slots take the hits in ascending j; slots past the hit
// count repeat the first hit (index 0 and distance 0 for an empty ball);
// the count is capped at nsample.  select_smallest = s returns idx[slot]
// for the s lexicographically smallest (d, slot) over all nsample slots,
// pad slots included, which is the order of top_k(-dists, s) followed by
// take_along(idx, .).
//
// What bounds it on an H100: by the card's rates, its operations.  At the
// repulsion loss's shape (28 clouds x 1024 queries x 1024 points, c = 3,
// r = 0.07, nsample 20, select 5) a ball holds a few points, so every
// query scans the whole cloud: 29 M distances, 0.35 GFLOP (5 us at the
// f32 rate), against 0.7 MB in and 3 MB out.  One thread a query with the
// cloud streamed past it is latency-bound: a thread's scan is a chain of n
// dependent steps, and the uniform metric's 28 x 51 queries are too few
// threads to hide it (0.083 ms there on an H100 80GB HBM3 at 700 W, where
// a warp a query took 0.0135).
//
// Design: knn_common.cuh's tiled stream (stream_tiles), the kNN kernels'
// distance code.  A block of 4 warps takes 32 queries of one cloud and
// streams the cloud through shared memory in coalesced tiles of 128
// points, p2 computed once a point of a tile; each lane holds a register
// tile of 8 queries (its warp's) by 4 points, 32 FMAs for every two
// broadcast float4 loads and four scalar loads a coordinate.  For each
// query one vote says whether the tile holds a hit (most tiles of a small
// ball do not); where it does, one ballot a column of 32 points gives the
// hits and the popcount of the lanes below a hit its slot, so hits land
// in ascending j in the query's column of the slot arrays ([slot][32 + 1]
// in shared memory); a warp skips its full queries, and the block stops
// after the load at which every query holds nsample hits
// (__syncthreads_and).  Then one thread a query takes the s smallest by
// insertion in registers over the slots in ascending order (s <= 8;
// beyond, no caller, a warp a query ranks its slots), and every output is
// written from shared memory with consecutive
// threads on consecutive addresses.  r2 is a (b,) device array or, when
// it is null, one value passed by value, so a scalar radius costs no
// host-to-device copy.

#include "knn_common.cuh"

namespace {

using namespace knn_common;

constexpr int kMaxN = 4096;
constexpr int kMaxC = 128;
constexpr int kMaxNsample = 128;
constexpr int kSelRegs = 8;  // select_smallest kept in registers
constexpr int kLd = kTQ + 1;  // a slot row: one column a query

// Dynamic shared memory in 4-byte words: the slots' indices and
// distances, each query's count, the selection.
__host__ __device__ inline int dyn_words(int ns, int s) {
  return 2 * ns * kLd + kTQ + s * kLd;
}

__global__ void __launch_bounds__(kTileThreads)
    ball_kernel(const float* __restrict__ points,
                const float* __restrict__ queries,
                const float* __restrict__ r2, float r2_value,
                int* __restrict__ idx, int* __restrict__ cnt,
                float* __restrict__ dists, int* __restrict__ sel, int n,
                int m, int c, int ns, int s) {
  __shared__ TileSmem sm;
  extern __shared__ float dyn[];
  int* s_idx = reinterpret_cast<int*>(dyn);  // [ns][kLd]
  float* s_d = dyn + ns * kLd;                // [ns][kLd]
  int* s_cnt = reinterpret_cast<int*>(dyn + 2 * ns * kLd);  // [kTQ]
  int* s_sel = s_cnt + kTQ;                   // [s][kLd]

  const int tiles = (m + kTQ - 1) / kTQ;
  const int cloud = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - cloud * tiles) * kTQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qw = q0 + warp * kRQ;  // this warp's first query
  const float rr = r2 != nullptr ? r2[cloud] : r2_value;
  const unsigned below = (1u << lane) - 1u;

  int found[kRQ];  // hits of the warp's queries so far, at most ns
#pragma unroll
  for (int i = 0; i < kRQ; ++i) found[i] = qw + i < m ? 0 : ns;

  stream_tiles<true>(
      sm, points + (size_t)cloud * n * c,
      queries + (size_t)cloud * m * c, nullptr, n, m, c, q0,
      [&](int g, int p0, const float(&acc)[kRQ][kRP],
          const float(&q2)[kRQ]) {
        float pp2[kRP];
#pragma unroll
        for (int r = 0; r < kRP; ++r) pp2[r] = sm.p2[g][lane + 32 * r];
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          if (found[i] >= ns) continue;  // warp-uniform
          const int col = warp * kRQ + i;
          float d[kRP];
          bool hit[kRP], any = false;
#pragma unroll
          for (int r = 0; r < kRP; ++r) {
            d[r] = fmaxf(
                __fadd_rn(__fsub_rn(q2[i], __fmul_rn(2.f, acc[i][r])),
                          pp2[r]),
                0.f);
            hit[r] = p0 + lane + 32 * r < n && d[r] < rr;
            any = any || hit[r];
          }
          if (!__any_sync(kFull, any)) continue;  // most tiles of a ball
          // the tile's hits in ascending j: column r, then lane
#pragma unroll
          for (int r = 0; r < kRP; ++r) {
            const unsigned mask = __ballot_sync(kFull, hit[r]);
            const int slot = found[i] + __popc(mask & below);
            if (hit[r] && slot < ns) {
              s_idx[slot * kLd + col] = p0 + lane + 32 * r;
              s_d[slot * kLd + col] = d[r];
            }
            found[i] = min(found[i] + __popc(mask), ns);
          }
        }
      },
      [&] {
        bool full = true;
#pragma unroll
        for (int i = 0; i < kRQ; ++i) full = full && found[i] >= ns;
        return full;
      });
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kRQ; ++i) s_cnt[warp * kRQ + i] = found[i];
  __syncthreads();

  const int rows = min(kTQ, m - q0);
  // slot t of query q: its (index, distance); pad slots repeat the first
  // hit's (index 0 and distance 0 for an empty ball)
  auto slot_d = [&](int q, int t) {
    const int got = s_cnt[q];
    return got > 0 ? s_d[(t < got ? t : 0) * kLd + q] : 0.f;
  };
  auto slot_j = [&](int q, int t) {
    const int got = s_cnt[q];
    return got > 0 ? s_idx[(t < got ? t : 0) * kLd + q] : 0;
  };
  if (s > 0 && s <= kSelRegs && tid < rows) {
    // one thread a query: the kSelRegs smallest (d, slot), ascending;
    // slots come in ascending order, so a tie goes to the entry held
    float bv[kSelRegs];
    int bt[kSelRegs];
#pragma unroll
    for (int i = 0; i < kSelRegs; ++i) {
      bv[i] = __int_as_float(0x7f800000);
      bt[i] = 0;
    }
    for (int t = 0; t < ns; ++t) {
      const float v = slot_d(tid, t);
      if (!(v < bv[kSelRegs - 1])) continue;
#pragma unroll
      for (int i = kSelRegs - 1; i > 0; --i) {
        if (v < bv[i - 1]) {
          bv[i] = bv[i - 1];
          bt[i] = bt[i - 1];
        } else if (v < bv[i]) {
          bv[i] = v;
          bt[i] = t;
        }
      }
      if (v < bv[0]) {
        bv[0] = v;
        bt[0] = t;
      }
    }
#pragma unroll
    for (int i = 0; i < kSelRegs; ++i)
      if (i < s) s_sel[i * kLd + tid] = slot_j(tid, bt[i]);
  } else if (s > kSelRegs) {
    // no caller: a warp a query, each lane ranking its slots in (d, slot)
    // order
    for (int q = warp; q < rows; q += kTileWarps)
      for (int t = lane; t < ns; t += 32) {
        const float v = slot_d(q, t);
        int rank = 0;
        for (int u = 0; u < ns; ++u) {
          const float w = slot_d(q, u);
          rank += (w < v) || (w == v && u < t);
        }
        if (rank < s) s_sel[rank * kLd + q] = slot_j(q, t);
      }
  }
  __syncthreads();

  // write-out: the block's rows are consecutive in every output
  const size_t row0 = (size_t)cloud * m + q0;
  for (int e = tid; e < rows * ns; e += kTileThreads) {
    const int r = e / ns, t = e - r * ns;
    idx[row0 * ns + e] = slot_j(r, t);
    if (dists != nullptr) dists[row0 * ns + e] = slot_d(r, t);
  }
  for (int e = tid; e < rows; e += kTileThreads) cnt[row0 + e] = s_cnt[e];
  for (int e = tid; e < rows * s; e += kTileThreads) {
    const int r = e / s, t = e - r * s;
    sel[row0 * s + e] = s_sel[t * kLd + r];
  }
}

}  // namespace

// points (b, n, c), queries (b, m, c): f32, contiguous; r2 (b,) f32, or
// null for r2_value in every cloud.  idx (b, m, nsample) and cnt (b, m)
// int32; dists (b, m, nsample) f32 or null; sel (b, m, s) int32, null
// exactly when s == 0.
extern "C" int dispu_query_ball(const float* points, const float* queries,
                                const float* r2, float r2_value, int* idx,
                                int* cnt, float* dists, int* sel, int b,
                                int n, int m, int c, int nsample, int s,
                                void* stream) {
  if (b < 1 || n < 1 || n > kMaxN || m < 1 || c < 1 || c > kMaxC ||
      nsample < 1 || nsample > kMaxNsample || s < 0 || s > nsample ||
      ((sel == nullptr) != (s == 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)dyn_words(nsample, s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ball_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ball_kernel<<<tile_blocks(b, m), kTileThreads, smem,
                (cudaStream_t)stream>>>(points, queries, r2, r2_value, idx,
                                        cnt, dists, sel, n, m, c, nsample,
                                        s);
  return (int)cudaGetLastError();
}
