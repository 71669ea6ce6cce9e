// Exact k-nearest-neighbour selection by squared euclidean distance, and
// its packed-key (turbo) variant.
//
// Replaces knn_pallas (dispu_tpu/ops/pallas_kernels.py, forward only), its
// exact variants and variant="packed".  For each query row it forms
// max(q2 - 2 q.p + p2, 0) + bias[j] over every dataset point j (the
// distance row of knn_common.cuh, shared with knn_group.cu).
//
// Exact (knn_kernel): the k smallest in lexicographic (distance, index)
// order, ascending: equal distances go to the lower index, as lax.top_k
// and the Pallas lane order do.  A bias of 1e30 pushes padding and
// duplicate columns last.
//
// Packed (knn_packed_kernel): each entry's key is one int, the distance's
// bits with the low lb bits replaced by the column index (lb =
// bit_length(n_pad - 1), n_pad = n rounded up to 128 as knn_pallas pads).
// Distances are >= +0, so the int order is the float order; the keys are
// distinct, so the k smallest keys ascending are the selection, each round
// one threshold minimum (no knock-out write).  Returns idx = key & lmask
// and dist = the key's high bits as a float: distances truncated, and ties
// within the truncation resolved by index.  The distance code is the
// exact kernel's, so the two differ only in selection.
//
// What bounds it on an H100: the selection, not the distances.  At the
// refiner's shape (32 clouds x 1024 queries x 1024 points, c = 3) the
// distances are 0.2 GFLOP, yet each of the k rounds re-reads the whole
// row.  Design: one warp per query row; the row's n distances live in
// shared memory (never in device memory); each round is one strided pass
// per lane keeping the minimum, a 5-step shuffle reduction, and (exact
// form) a knock-out of the winner with +inf.  The row limit is the shared
// memory of one block: (n + c) floats per warp, at most 232,448 bytes,
// i.e. n + c <= 58,112.

#include "knn_common.cuh"

namespace {

using namespace knn_common;

__global__ void knn_kernel(const float* __restrict__ points,
                           const float* __restrict__ queries,
                           const float* __restrict__ bias,
                           float* __restrict__ dists, int* __restrict__ idx,
                           int b, int n, int m, int c, int k, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= (long long)b * m) return;  // warps never meet at a block barrier
  float* d = smem + (size_t)warp * (n + c);
  const long long cloud = row / m;
  row_distances(queries + row * c, points + cloud * n * c, bias + cloud * n,
                d, d + n, n, c, lane);

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  for (int r = 0; r < k; ++r) {
    float bv;
    int bj;
    select_min(d, n, lane, bv, bj);
    if (lane == 0) {
      drow[r] = bv;
      irow[r] = bj;
    }
    knock_out(d, n, lane, bj);
  }
}

__global__ void knn_packed_kernel(const float* __restrict__ points,
                                  const float* __restrict__ queries,
                                  const float* __restrict__ bias,
                                  float* __restrict__ dists,
                                  int* __restrict__ idx, int b, int n, int m,
                                  int c, int k, int lb, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= (long long)b * m) return;
  float* d = smem + (size_t)warp * (n + c);
  const long long cloud = row / m;
  row_distances(queries + row * c, points + cloud * n * c, bias + cloud * n,
                d, d + n, n, c, lane);
  // each lane turns its own entries into keys in place: the distance's
  // bits, read as an int, with the low lb bits replaced by the index
  int* keys = reinterpret_cast<int*>(d);
  const int lmask = (1 << lb) - 1;
  for (int j = lane; j < n; j += 32) keys[j] = (keys[j] & ~lmask) | j;

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  int t = -1;  // every key is >= 0
  for (int r = 0; r < k; ++r) {
    int best = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      const int key = keys[j];
      if (key > t && key < best) best = key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    t = best;
    if (lane == 0) {
      irow[r] = t & lmask;
      drow[r] = __int_as_float(t & ~lmask);
    }
  }
}

}  // namespace

extern "C" int dispu_knn(const float* points, const float* queries,
                         const float* bias, float* dists, int* idx, int b,
                         int n, int m, int c, int k, void* stream) {
  int warps;
  size_t smem;
  if (!row_launch(n, c, warps, smem) || k < 1 || k > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  knn_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, b, n, m, c, k, warps);
  return (int)cudaGetLastError();
}

// lb: the lane bits, bit_length(n_pad - 1) >= 1 with 2^lb >= n.
extern "C" int dispu_knn_packed(const float* points, const float* queries,
                                const float* bias, float* dists, int* idx,
                                int b, int n, int m, int c, int k, int lb,
                                void* stream) {
  int warps;
  size_t smem;
  if (!row_launch(n, c, warps, smem) || k < 1 || k > n || lb < 1 ||
      lb > 30 || (1LL << lb) < n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  knn_packed_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, b, n, m, c, k, lb, warps);
  return (int)cudaGetLastError();
}
