// The distance and selection code shared by knn.cu and knn_group.cu, so
// that the two return the same bits for the same inputs (knn_group_pallas's
// contract: its dists and idx are knn_pallas's; refine_block.cu takes
// knn.cu's own launch); query_ball.cu streams its cloud through the same
// tiles (stream_tiles).
//
// Every distance keeps the JAX association max((q2 - 2 q.p) + p2, 0) +
// bias[j], with q2, q.p and p2 each one fmaf chain over the coordinates
// t = 0 .. c-1 in ascending order from 0.f, and explicit round-to-nearest
// intrinsics for the rest, so nvcc has no contraction left to choose.
// Selection is in lexicographic (distance, index) order: equal distances
// go to the lower index; a +inf (or NaN) distance is never selected, and
// a slot left unfilled reports (+inf, INT_MAX).  The k smallest pairs are
// unique, so every form below returns the same bits.
//
// Two forms:
// - the row form (row_distances, select_min, knock_out): one warp per
//   query, its n distances in shared memory, k rounds of a strided pass,
//   a butterfly and a knock-out.  knn_group.cu and knn.cu's packed
//   selection take it for k > kStreamK.
//   One row must fit one block's shared memory: n + c <= 58,112.  (knn.cu's
//   exact selection past k = 32 is a radix select of its own, with the same
//   bits.)
// - the tiled form (stream_topk), for k <= kStreamK = 32 (MAX_STREAM_K in
//   kernels/knn.py, whose wrappers refuse only the row form's n).  A block
//   takes one cloud and kTQ = 32 queries and streams the cloud through shared
//   memory in tiles of kTP = 128 points, loaded coalesced from the row-major
//   input and stored coordinate-major (rows padded, so the lanes read without
//   bank conflicts): kG = 4 tiles a barrier when their coordinates fit kCC =
//   60 rows (c <= 15), else one, in chunks of 60 coordinates past 60.  Each
//   lane keeps a register tile of kRQ = 8 queries (its warp's) by kRP = 4
//   points (lane, lane + 32, ...): per coordinate two broadcast float4 loads
//   and four scalar loads feed 32 FMAs.  q2 is computed once a query, p2 once
//   a point of a tile.  Each query keeps its k best (d, j) sorted across the
//   warp's lanes (lane r holds rank r) and compares a tile's distances with
//   the k-th in registers; the few that pass are inserted one at a time (a
//   ballot gives the rank, a shuffle shifts the tail), all of a column's
//   against the threshold it started with.  No row goes to shared memory, so
//   n is not limited.  The selection costs n compares a query plus about
//   k (1 + ln(n / k)) insertions for points in random order (k = 1: each
//   lane keeps the least of its own pairs, and one butterfly ends the
//   stream).  On an H100 the stream without its insertions (the FMAs, the
//   compares, a ballot a column) takes about two thirds of the time over
//   4,096 points at c = 3 and over 1,024 at c = 48, a third over 1,024 at
//   c = 3; the insertions take the rest (dispu_tpu_torch/time_knn_forms.py).
//   Bitonic merges of a column's passes, in registers or from a buffer in
//   shared memory, and a branch-free pass over a tile's distances before
//   the ballots each needed more registers, fewer blocks an SM, and lost
//   at 1,024 and 4,096 points.
//   The tiled form takes its order as a template parameter: ExactOrder, the
//   (distance, index) pairs above, or PackedOrder, knn.cu's packed (turbo)
//   selection, whose list holds one int key a pair, (bits(d) & ~lmask) | j,
//   compared as ints.  ExactOrder's key is the index itself, so the exact
//   form's code and bits are those it had before the order was a parameter.
// - knn.cu's radix form (k > kStreamK) takes only the distance code
//   (query_sq, point_distance) from here; its selection is its own.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace knn_common {

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

// ------------------------------------------------------------ row form

// |q|^2 of a query of c floats: one fmaf chain over ascending coordinates.
__device__ __forceinline__ float query_sq(const float* q, int c) {
  float q2 = 0.f;
  for (int t = 0; t < c; ++t) q2 = fmaf(q[t], q[t], q2);
  return q2;
}

// The distance of point p (c floats) from query q with |q|^2 = q2 and
// column bias bj: max((q2 - 2 q.p) + p2, 0) + bj.
__device__ __forceinline__ float point_distance(const float* q, float q2,
                                                const float* __restrict__ p,
                                                float bj, int c) {
  float qp = 0.f, p2 = 0.f;
  for (int t = 0; t < c; ++t) {
    const float pv = p[t];
    qp = fmaf(q[t], pv, qp);
    p2 = fmaf(pv, pv, p2);
  }
  const float e = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, qp)), p2);
  return __fadd_rn(fmaxf(e, 0.f), bj);
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
  const float q2 = query_sq(q, c);
  for (int j = lane; j < n; j += 32)
    d[j] = point_distance(q, q2, pts + (size_t)j * c, bs[j], c);
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

// ---------------------------------------------------------- tiled form

constexpr int kStreamK = 32;               // the largest k it selects
constexpr int kTileWarps = 4;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kRQ = 8;                     // queries a warp
constexpr int kRP = 4;                     // points a lane
constexpr int kTQ = kTileWarps * kRQ;      // queries a block
constexpr int kTP = 32 * kRP;              // points a tile
constexpr int kCC = 60;                    // rows of coordinates a load
constexpr int kG = 4;                      // tiles a load, at most
static_assert(kRQ == 8, "two float4 loads of queries a coordinate");

// 43.7 KB: five blocks an SM
struct alignas(16) TileSmem {
  float q[kCC][kTQ + 4];   // the block's queries, coordinate-major
  float p[kCC][kTP + 1];   // the loaded tiles' points, coordinate-major
  float p2[kG][kTP];
  float bias[kG][kTP];
};

// Rows [r0, r0 + R) of a row-major (rows, c) matrix, columns [c0, c0 +
// cc), into dst: row r's column c0 + t at dst[((r / T) * cc + t) * ld +
// r % T], i.e. coordinate-major tiles of T rows one under the other; rows
// at or past ``rows`` read as 0.  The block's threads walk the rows in
// memory order (coalesced; one run when cc == c) and step (r, t) without
// dividing.
template <int T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int r0, int R, int rows, int c,
                                          int c0, int cc, int tid) {
  int r = tid / cc, t = tid - r * cc;
  const int dr = kTileThreads / cc, dt = kTileThreads - dr * cc;
#pragma unroll 4
  for (int e = tid; e < R * cc; e += kTileThreads) {
    const int g = r0 + r;
    dst[((r / T) * cc + t) * ld + r % T] =
        g < rows ? src[(size_t)g * c + c0 + t] : 0.f;
    r += dr;
    t += dt;
    if (t >= cc) {
      t -= cc;
      ++r;
    }
  }
}

__device__ __forceinline__ bool admits(float d, int j, float td, int tj) {
  return d < __int_as_float(0x7f800000) && lex_less(d, j, td, tj);
}

// The orders of the tiled form's lists.  A list entry is (v, i): v the
// pair's distance, i its key(d, j, n) for point j of n.  An unfilled entry
// is (+inf, INT_MAX).
struct ExactOrder {  // (distance, index); +inf never admitted
  __device__ __forceinline__ int key(float, int j, int) const { return j; }
  __device__ __forceinline__ bool less(float v, int i, float ov,
                                       int oi) const {
    return lex_less(v, i, ov, oi);
  }
  __device__ __forceinline__ bool admits(float d, int i, float td,
                                         int ti) const {
    return knn_common::admits(d, i, td, ti);
  }
};

// The packed selection's int keys: distinct, so their int order is total.
// A +inf or NaN distance is a key like any other, as in knn_pallas's int
// order; a point past n (a tile's padding) gets INT_MAX, which is never
// admitted, and so is a negative key (a negative bias), as in the row form.
struct PackedOrder {
  int lmask;
  __device__ __forceinline__ int key(float d, int j, int n) const {
    return j < n ? (__float_as_int(d) & ~lmask) | j : INT_MAX;
  }
  __device__ __forceinline__ bool less(float, int i, float, int oi) const {
    return i < oi;
  }
  __device__ __forceinline__ bool admits(float, int i, float,
                                         int ti) const {
    return i >= 0 && i < ti;
  }
};

// Insert (cd, cj), absent from the list, into the warp's sorted list (lane
// r holds rank r): the ranks below it stay, the rest move up one lane.
template <class Order = ExactOrder>
__device__ __forceinline__ void insert(float& ld, int& lj, float cd, int cj,
                                       int lane, Order order = Order()) {
  const int pos =
      __popc(__ballot_sync(kFull, order.less(ld, lj, cd, cj)));
  const float ud = __shfl_up_sync(kFull, ld, 1);
  const int uj = __shfl_up_sync(kFull, lj, 1);
  if (lane == pos) {
    ld = cd;
    lj = cj;
  } else if (lane > pos) {
    ld = ud;
    lj = uj;
  }
}

// The tiled stream: the block's kTQ queries (rows q0 .. of the cloud's m)
// against every point of the cloud, tile by tile.  For each tile g of a
// load, calls visit(g, p0, acc, q2) with the tile's first point p0,
// acc[i][r] = q.p of this warp's query i and point p0 + lane + 32 r, and
// q2[i] = |q|^2 (each an fmaf chain over ascending coordinates from 0);
// sm.p2[g][col] holds the tile's |p|^2 and, with bs non-null, sm.bias[g]
// its column bias.  Must be called by all kTileThreads threads of the
// block.  With kStop, the stream ends after the first load at which
// done() holds in every thread.
//
// A load brings G = kG tiles of kTP points where their coordinates fit
// kCC rows (c <= 15), else one, so that at small c one barrier serves kG
// tiles; past kCC coordinates a tile comes in chunks of kCC, the products
// and p2 accumulating over the chunks in order.
template <bool kStop, class Visit, class Done>
__device__ __forceinline__ void stream_tiles(TileSmem& sm,
                                             const float* __restrict__ pts,
                                             const float* __restrict__ qry,
                                             const float* __restrict__ bs,
                                             int n, int m, int c, int q0,
                                             Visit visit, Done done) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qw = q0 + warp * kRQ;  // this warp's first query
  const int G = c <= kCC / kG ? kG : 1;

  // q2, once a query: lane i < kRQ takes query qw + i
  float q2[kRQ];
  {
    float s = 0.f;
    if (lane < kRQ && qw + lane < m) {
      const float* q = qry + (size_t)(qw + lane) * c;
      for (int t = 0; t < c; ++t) s = fmaf(q[t], q[t], s);
    }
#pragma unroll
    for (int i = 0; i < kRQ; ++i) q2[i] = __shfl_sync(kFull, s, i);
  }
  float acc[kRQ][kRP];
  // acc += the products over coordinate rows [row, row + cc) of sm.p
  auto accumulate = [&](int row, int cc) {
#pragma unroll 4
    for (int t = 0; t < cc; ++t) {
      const float4 qa = *reinterpret_cast<const float4*>(&sm.q[t][warp * kRQ]);
      const float4 qb =
          *reinterpret_cast<const float4*>(&sm.q[t][warp * kRQ + 4]);
      const float qv[kRQ] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float pv[kRP];
#pragma unroll
      for (int r = 0; r < kRP; ++r) pv[r] = sm.p[row + t][lane + 32 * r];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int r = 0; r < kRP; ++r)
          acc[i][r] = fmaf(qv[i], pv[r], acc[i][r]);
    }
  };
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int r = 0; r < kRP; ++r) acc[i][r] = 0.f;
  };

  for (int l0 = 0; l0 < n; l0 += G * kTP) {
    clear();
    for (int c0 = 0; c0 < c; c0 += kCC) {
      const int cc = min(kCC, c - c0);
      __syncthreads();  // the last load's readers are done
      load_rows<kTP>(&sm.p[0][0], kTP + 1, pts, l0, G * kTP, n, c, c0, cc,
                     tid);
      if (l0 == 0 || c > kCC)
        load_rows<kTQ>(&sm.q[0][0], kTQ + 4, qry, q0, kTQ, m, c, c0, cc,
                       tid);
      if (c0 == 0 && bs != nullptr)
        for (int p = tid; p < G * kTP; p += kTileThreads)
          sm.bias[p / kTP][p % kTP] = l0 + p < n ? bs[l0 + p] : 0.f;
      __syncthreads();
      // p2 of the loaded points, each a thread's own slot, over the
      // chunks in order
      for (int p = tid; p < G * kTP; p += kTileThreads) {
        const int g = p / kTP, col = p % kTP;
        float s = c0 == 0 ? 0.f : sm.p2[g][col];
        for (int t = g * cc; t < (g + 1) * cc; ++t)
          s = fmaf(sm.p[t][col], sm.p[t][col], s);
        sm.p2[g][col] = s;
      }
      if (G == 1) accumulate(0, cc);
    }
    __syncthreads();

    for (int g = 0; g < G; ++g) {
      const int p0 = l0 + g * kTP;
      if (G > 1) {
        clear();
        accumulate(g * c, c);
      }
      visit(g, p0, acc, q2);
    }
    if (kStop && __syncthreads_and(done())) break;
  }
}

// The K <= kStreamK smallest entries, in ``order``, of each of the
// block's queries, which are kTQ rows of the cloud's m starting at q0;
// calls emit(q, v, i) once a valid query q, warp-uniformly, with lane r
// holding rank r (ranks past the filled ones (+inf, INT_MAX)).  Must be
// called by all kTileThreads threads of the block.
template <class Emit, class Order = ExactOrder>
__device__ __forceinline__ void stream_topk(TileSmem& sm,
                                            const float* __restrict__ pts,
                                            const float* __restrict__ qry,
                                            const float* __restrict__ bs,
                                            int n, int m, int c, int q0,
                                            int K, Emit emit,
                                            Order order = Order()) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int qw = q0 + (threadIdx.x >> 5) * kRQ;  // this warp's first query
  // each query's list (lane r holds rank r)
  float ld[kRQ];
  int lj[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    ld[i] = inf;
    lj[i] = INT_MAX;
  }
  stream_tiles<false>(
      sm, pts, qry, bs, n, m, c, q0,
      [&](int g, int p0, const float(&acc)[kRQ][kRP],
          const float(&q2)[kRQ]) {
        float pp2[kRP], pb[kRP];
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          pp2[r] = sm.p2[g][lane + 32 * r];
          pb[r] = sm.bias[g][lane + 32 * r];
        }
        // pair (query i, point p0 + lane + 32 r)'s distance
        auto dist = [&](int i, int r) {
          const float e =
              __fadd_rn(__fsub_rn(q2[i], __fmul_rn(2.f, acc[i][r])), pp2[r]);
          return p0 + lane + 32 * r < n ? __fadd_rn(fmaxf(e, 0.f), pb[r])
                                        : inf;
        };
#pragma unroll
        for (int i = 0; i < kRQ; ++i) {
          if (qw + i >= m) break;  // warp-uniform
          if (K == 1) {  // each lane keeps the least of its pairs
#pragma unroll
            for (int r = 0; r < kRP; ++r) {
              const float d = dist(i, r);
              const int j = order.key(d, p0 + lane + 32 * r, n);
              if (order.admits(d, j, ld[i], lj[i])) {
                ld[i] = d;
                lj[i] = j;
              }
            }
            continue;
          }
          // the threshold: rank K - 1, in every lane
          float td = __shfl_sync(kFull, ld[i], K - 1);
          int tj = __shfl_sync(kFull, lj[i], K - 1);
#pragma unroll
          for (int r = 0; r < kRP; ++r) {
            const float d = dist(i, r);
            const int j = order.key(d, p0 + lane + 32 * r, n);
            // Every pair of the column that passes the threshold goes in,
            // one at a time, without waiting for the threshold each
            // insertion moves: a pair that ends up past rank K only
            // reorders lanes no one reads.
            unsigned mask =
                __ballot_sync(kFull, order.admits(d, j, td, tj));
            if (mask == 0) continue;
            do {
              const int src = __ffs(mask) - 1;
              mask &= mask - 1;
              insert(ld[i], lj[i], __shfl_sync(kFull, d, src),
                     __shfl_sync(kFull, j, src), lane, order);
            } while (mask);
            td = __shfl_sync(kFull, ld[i], K - 1);
            tj = __shfl_sync(kFull, lj[i], K - 1);
          }
        }
      },
      [] { return false; });
  if (K == 1) {  // the least of the lanes' own, in every lane
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, ld[i], off);
        const int oj = __shfl_xor_sync(kFull, lj[i], off);
        if (order.less(od, oj, ld[i], lj[i])) {
          ld[i] = od;
          lj[i] = oj;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < kRQ; ++i)
    if (qw + i < m) emit(qw + i, ld[i], lj[i]);
}

// Blocks of the tiled form for b clouds of m queries.
inline unsigned tile_blocks(int b, int m) {
  return (unsigned)((long long)b * ((m + kTQ - 1) / kTQ));
}

}  // namespace knn_common
