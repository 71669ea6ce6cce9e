// Fused k-nearest-neighbour selection and neighbourhood gather.
//
// Replaces knn_group_pallas (dispu_tpu/ops/pallas_kernels.py, forward).
// For each query row: the exact kNN of knn.cu (the same distances and
// selection forms, from knn_common.cuh, so dists and idx are bit-equal to
// knn.cu's on the same inputs), and for each kept rank the chosen row of
// feats copied into grouped_feat, and with with_xyz the chosen point's 3
// coordinates into grouped_xyz.  drop_first selects k + 1 and keeps ranks
// 1..k: rank 0 (the query itself, for a self-kNN) is selected but never
// gathered.  Turbo (exact == 0) rounds each gathered feature once to bf16
// (round to nearest even) and back to f32: the leading term of _bf16_terms
// and the value of group_point(impl='onehot').  Exact mode is a plain
// load, which on this card is exact: the TPU's 3-term bf16 split has no
// reason to exist here.  xyz is always exact.
//
// What bounds it on an H100: at the backbone's shapes (c = 24 or 48 keys)
// the distances' f32 FMAs and the gathered rows' bytes; at the refiner's
// (c = 3 keys, 128 features) the bytes, 268 MB of f32 rows at pass 1's 32
// clouds x 1024 queries x k = 16.  Design: knn.cu's forms from
// knn_common.cuh.  For k (+1 with drop_first) <= 32, the tiled form: the
// cloud streams through shared memory in coalesced tiles and each query's
// winners stay sorted in its warp's registers (lane r holds rank r); once
// they are known the warp copies the k chosen feature rows over their
// flattened range, consecutive lanes on consecutive floats (float4s where
// the widths and pointers allow), each lane taking its row's index from
// the owning lane by a shuffle, then the xyz.  Beyond 32, the row form:
// one warp per query row, the row's distances in shared memory (n + c <=
// 58,112), each kept round's winner copied as it is selected.  The TPU
// kernel's n <= 2048 envelope was a VMEM limit; the callers keep the JAX
// package's gates.

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "knn_common.cuh"

namespace {

using namespace knn_common;

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

// The k chosen rows of ft (cf floats, V floats a load: 1 or 4) into out,
// over the flattened (slot, column) range, consecutive lanes on
// consecutive columns, four loads in flight a lane (eight were slower).
// Lane drop + s holds slot s's index j; j >= n (an unfilled slot) gathers
// zeros.  The rows go out by streaming stores (evict first): nothing here
// reads them again, and the L2 stays with the feature table the gathers
// read (the train step's refiner shape 0.302 -> 0.291 ms on an H100).
template <int V>
__device__ __forceinline__ void gather_rows(const float* __restrict__ ft,
                                            float* __restrict__ out, int j,
                                            int n, int cf, int k, int drop,
                                            int exact, int lane) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  constexpr int U = 4;
  const int w = cf / V, total = k * w;
  int s = lane / w, t = lane - s * w;
  const int ds = 32 / w, dt = 32 - ds * w;
  for (int e0 = 0; e0 < total; e0 += 32 * U) {
    Vec v[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int js = __shfl_sync(kFull, j, min(s, k - 1) + drop);
      at[u] = e0 + 32 * u + lane < total ? s * w + t : -1;
      if constexpr (V == 4) {
        v[u] = at[u] >= 0 && js < n
                   ? reinterpret_cast<const float4*>(ft + (size_t)js * cf)[t]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        if (!exact) v[u] = bf16_round4(v[u]);
      } else {
        v[u] = at[u] >= 0 && js < n ? ft[(size_t)js * cf + t] : 0.f;
        if (!exact) v[u] = __bfloat162float(__float2bfloat16_rn(v[u]));
      }
      s += ds;
      t += dt;
      if (t >= w) {
        t -= w;
        ++s;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) __stcs(reinterpret_cast<Vec*>(out) + at[u], v[u]);
  }
}

// k + drop_first <= kStreamK: the tiled form; one block per (cloud, 32
// queries).  vec: cf % 4 == 0 and feats, gfeat 16-byte aligned.
__global__ void __launch_bounds__(kTileThreads)
    knn_group_stream_kernel(const float* __restrict__ points,
                            const float* __restrict__ queries,
                            const float* __restrict__ bias,
                            const float* __restrict__ feats,
                            float* __restrict__ dists, int* __restrict__ idx,
                            float* __restrict__ gxyz,
                            float* __restrict__ gfeat, int n, int m, int c,
                            int cf, int k, int drop_first, int exact,
                            int vec) {
  __shared__ TileSmem sm;
  const int tiles = (m + kTQ - 1) / kTQ;
  const int cloud = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - cloud * tiles) * kTQ;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)cloud * m;
  const float* pts = points + (size_t)cloud * n * c;
  const float* ft = feats + (size_t)cloud * n * cf;
  stream_topk(
      sm, pts, queries + (size_t)row0 * c, bias + (size_t)cloud * n, n, m, c,
      q0, k + drop_first, [&](int q, float d, int j) {
        const long long row = row0 + q;
        if (lane >= drop_first && lane < k + drop_first) {
          dists[row * k + lane - drop_first] = d;
          idx[row * k + lane - drop_first] = j;
        }
        float* out = gfeat + row * k * cf;
        if (vec)
          gather_rows<4>(ft, out, j, n, cf, k, drop_first, exact, lane);
        else
          gather_rows<1>(ft, out, j, n, cf, k, drop_first, exact, lane);
        if (gxyz != nullptr) {
          for (int e0 = 0; e0 < 3 * k; e0 += 32) {
            const int e = e0 + lane, s = e / 3;
            const int js = __shfl_sync(kFull, j, min(s, k - 1) + drop_first);
            if (e < 3 * k)
              gxyz[row * k * 3 + e] =
                  js < n ? pts[(size_t)js * 3 + e - 3 * s] : 0.f;
          }
        }
      });
}

// k + drop_first > kStreamK: the row form.
__global__ void knn_group_kernel(const float* __restrict__ points,
                                 const float* __restrict__ queries,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ feats,
                                 float* __restrict__ dists,
                                 int* __restrict__ idx,
                                 float* __restrict__ gxyz,
                                 float* __restrict__ gfeat, int b, int n,
                                 int m, int c, int cf, int k, int drop_first,
                                 int exact, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= (long long)b * m) return;  // warps never meet at a block barrier
  float* d = smem + (size_t)warp * (n + c);
  const long long cloud = row / m;
  const float* pts = points + cloud * n * c;
  const float* ft = feats + cloud * n * cf;
  row_distances(queries + row * c, pts, bias + cloud * n, d, d + n, n, c,
                lane);

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  const int rounds = k + drop_first;
  for (int r = 0; r < rounds; ++r) {
    float bv;
    int bj;
    select_min(d, n, lane, bv, bj);
    const int slot = r - drop_first;
    if (slot >= 0) {
      if (lane == 0) {
        drow[slot] = bv;
        irow[slot] = bj;
      }
      // bj is the same in every lane; past n only for overflowed inputs
      float* out = gfeat + (row * k + slot) * cf;
      const float* src = ft + (size_t)(bj < n ? bj : 0) * cf;
      for (int t = lane; t < cf; t += 32) {
        float v = bj < n ? src[t] : 0.f;
        if (!exact) v = __bfloat162float(__float2bfloat16_rn(v));
        out[t] = v;
      }
      if (gxyz != nullptr && lane < 3)
        gxyz[(row * k + slot) * 3 + lane] = bj < n ? pts[(size_t)bj * 3 + lane]
                                                   : 0.f;
    }
    knock_out(d, n, lane, bj);
  }
}

}  // namespace

// gxyz may be null (no xyz gather); with it, c must be 3.
extern "C" int dispu_knn_group(const float* points, const float* queries,
                               const float* bias, const float* feats,
                               float* dists, int* idx, float* gxyz,
                               float* gfeat, int b, int n, int m, int c,
                               int cf, int k, int drop_first, int exact,
                               void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k + drop_first > n || cf < 1 ||
      (gxyz != nullptr && c != 3))
    return (int)cudaErrorInvalidValue;
  if (k + drop_first <= kStreamK) {
    const int vec = cf % 4 == 0 && (reinterpret_cast<uintptr_t>(feats) |
                                    reinterpret_cast<uintptr_t>(gfeat)) %
                                           16 == 0;
    knn_group_stream_kernel<<<tile_blocks(b, m), kTileThreads, 0,
                              (cudaStream_t)stream>>>(
        points, queries, bias, feats, dists, idx, gxyz, gfeat, n, m, c, cf, k,
        drop_first, exact, vec);
    return (int)cudaGetLastError();
  }
  int warps;
  size_t smem;
  if (!row_launch(n, c, warps, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  knn_group_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      points, queries, bias, feats, dists, idx, gxyz, gfeat, b, n, m, c, cf,
      k, drop_first, exact, warps);
  return (int)cudaGetLastError();
}
