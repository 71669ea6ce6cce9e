// Exact k-nearest-neighbour selection by squared euclidean distance.
//
// Replaces knn_pallas (dispu_tpu/ops/pallas_kernels.py, forward only).
// For each query row it forms max(q2 - 2 q.p + p2, 0) + bias[j] over every
// dataset point j and returns the k smallest in lexicographic
// (distance, index) order, ascending: equal distances go to the lower
// index, as lax.top_k and the Pallas lane order do.  A bias of 1e30 pushes
// padding and duplicate columns last.
//
// What bounds it on an H100: the selection, not the distances.  At the
// refiner's shape (32 clouds x 1024 queries x 1024 points, c = 3) the
// distances are 0.2 GFLOP, yet each of the k rounds re-reads the whole
// row.  Design: one warp per query row; the row's n distances live in
// shared memory (never in device memory); each round is one strided pass
// per lane keeping the lexicographic minimum, a 5-step shuffle reduction,
// and a knock-out of the winner with +inf.  The row limit is the shared
// memory of one block: (n + c) floats per warp, at most 232,448 bytes,
// i.e. n + c <= 58,112.
//
// The distance keeps the JAX association (q2 - 2qp) + p2 with explicit
// round-to-nearest intrinsics, so nvcc cannot contract it into an FMA.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

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
  float* q = d + n;
  const long long cloud = row / m;

  const float* qrow = queries + row * c;
  for (int t = lane; t < c; t += 32) q[t] = qrow[t];
  __syncwarp();
  float q2 = 0.f;
  for (int t = 0; t < c; ++t) q2 = fmaf(q[t], q[t], q2);

  const float* pts = points + cloud * n * c;
  const float* bs = bias + cloud * n;
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

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  for (int r = 0; r < k; ++r) {
    float bv = __int_as_float(0x7f800000);  // +inf: consumed entries
    int bj = INT_MAX;
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
    if (lane == 0) {
      drow[r] = bv;
      irow[r] = bj;
      // bj == INT_MAX only when every remaining distance is +inf (an
      // overflowed input): nothing to knock out, and no write out of bounds
      if (bj < n) d[bj] = __int_as_float(0x7f800000);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int dispu_knn(const float* points, const float* queries,
                         const float* bias, float* dists, int* idx, int b,
                         int n, int m, int c, int k, void* stream) {
  const size_t per_warp = (size_t)(n + c) * sizeof(float);
  if (per_warp > kMaxSmem || k < 1 || k > n) return (int)cudaErrorInvalidValue;
  int warps = (int)(kMaxSmem / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = per_warp * warps;
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  knn_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, b, n, m, c, k, warps);
  return (int)cudaGetLastError();
}
