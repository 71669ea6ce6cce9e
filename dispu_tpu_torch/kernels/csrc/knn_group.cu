// Fused k-nearest-neighbour selection and neighbourhood gather.
//
// Replaces knn_group_pallas (dispu_tpu/ops/pallas_kernels.py, forward).
// For each query row: the exact kNN of knn.cu (the same distance row and
// selection rounds, from knn_common.cuh, so dists and idx are bit-equal
// to knn.cu's on the same inputs), and for each kept round the chosen
// row of feats copied into grouped_feat, and with with_xyz the chosen
// point's 3 coordinates into grouped_xyz.  drop_first runs k + 1 rounds
// and keeps rounds 1..k: round 0 (the query itself, for a self-kNN) is
// selected and knocked out but never gathered.  Turbo (exact == 0) rounds
// each gathered feature once to bf16 (round to nearest even) and back to
// f32: the leading term of _bf16_terms and the value of
// group_point(impl='onehot').  Exact mode is a plain load, which on this
// card is exact: the TPU's 3-term bf16 split has no reason to exist here.
// xyz is always exact.
//
// What bounds it on an H100: the bytes of its output.  At the refiner's
// pass-1 shape (32 clouds x 1024 queries, k = 16, 128 features) the
// gathered rows are 268 MB of f32, against 0.2 GFLOP of distances.
// Design: one warp per query row, the row's distances in shared memory;
// after each kept round the warp copies the winner's feature row with
// consecutive lanes on consecutive floats (coalesced loads and stores).
// The TPU kernel's n <= 2048 envelope was a VMEM limit; this kernel takes
// any n whose row fits one block's shared memory (n + c <= 58,112), and
// the callers keep the JAX package's gates.

#include <cuda_bf16.h>

#include "knn_common.cuh"

namespace {

using namespace knn_common;

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
  int warps;
  size_t smem;
  if (!row_launch(n, c, warps, smem) || k < 1 || k + drop_first > n ||
      cf < 1 || (gxyz != nullptr && c != 3))
    return (int)cudaErrorInvalidValue;
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
