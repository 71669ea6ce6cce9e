// The refiner's fused local + skip branch on an already grouped tensor.
//
// Replaces refine_local_pallas (dispu_tpu/ops/pallas_kernels.py): from the
// grouped [centred xyz | raw xyz | features] tensor (b, n, k, cf) and the
// pre-folded parameters (the weight net's inference BN in ww, bw;
// after_conv as (k, c2, co) t-major blocks), out (b, n, co) =
// relu(after_conv(pool)) + relu(skip), with no (b, n, k, .) intermediate
// in device memory.  The math is refine_common.cuh's, in f32.
//
// What bounds it on an H100: operations.  At the refiner's pass-1 shape
// (32 clouds x 1024 queries, k = 16, cf = 134, c1 = c2 = 128, co = 256)
// the products are about 74 GFLOP (conv0 18.0, conv1 17.2, after_conv
// 34.4, pooling 2.1, skip 2.3), 1.1 ms at the card's f32 rate, against
// 281 MB of grouped input (0.084 ms at 3.35 TB/s).  Design: one block per
// (cloud, tile of T queries), T = 8 at k = 16, so a tile's 128 grouped
// rows are one coalesced copy into shared memory; conv0 and conv1 are
// register-tiled 8 x 8 products of shared rows against weights staged in
// shared memory a chunk ahead; the pooling runs from shared memory, and
// after_conv and skip read their weights from L2 some rows ahead.  Each
// block reads all of after_conv's 2 MB for its T queries, so L2's rate
// bounds that head (about 8.6 GB at pass 1).  The tile's shared memory
// (about 180 KB at that width) keeps one block per SM.  A TPU tile of 128
// queries does not carry over: the TPU's grid runs in order and its VMEM
// holds megabytes.

#include "refine_common.cuh"

namespace {

using namespace refine_common;

__global__ void __launch_bounds__(kThreads)
    refine_local_kernel(const float* __restrict__ grouped, Params p, Dims d,
                        int n, int T, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles = (n + T - 1) / T;
  const int cloud = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - cloud * tiles) * T;
  const int valid = min(T, n - q0);
  // the tile's rows are contiguous in (b, n, k, cf): one coalesced copy
  copy_rows(grouped + ((size_t)cloud * n + q0) * d.k * d.cf, T * d.k,
            valid * d.k, d.cf, tile_rows(smem, T, d), pad(d.cf));
  __syncthreads();
  tile_mlp(smem, T, valid, d, p, out + ((size_t)cloud * n + q0) * d.co);
}

}  // namespace

// Shared-memory bytes of one block, or 0 when it exceeds a block's limit.
extern "C" size_t dispu_refine_local_smem(int k, int cf, int c1, int c2,
                                          int co, int T) {
  const size_t bytes = mlp_floats(T, Dims{k, cf, c1, c2, co}) * sizeof(float);
  return bytes <= kMaxSmem ? bytes : 0;
}

// grouped (b, n, k, cf); w0 (cf, c1), w1 (c1, c2), ww (3, k), wsk (cf, co),
// waf (k, c2, co) row-major; biases of the output widths; out (b, n, co).
// T queries a block, 1 <= T <= kMaxT, with its shared memory within a
// block's limit.
extern "C" int dispu_refine_local(const float* grouped, const float* w0,
                                  const float* b0, const float* w1,
                                  const float* b1, const float* ww,
                                  const float* bw, const float* wsk,
                                  const float* bsk, const float* waf,
                                  const float* baf, float* out, int b, int n,
                                  int k, int cf, int c1, int c2, int co,
                                  int T, void* stream) {
  const Dims d{k, cf, c1, c2, co};
  if (b < 1 || n < 1 || k < 1 || cf < 3 || c1 < 1 || c2 < 1 || co < 1 ||
      T < 1 || T > kMaxT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dispu_refine_local_smem(k, cf, c1, c2, co, T);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      refine_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Params p{w0, b0, w1, b1, ww, bw, wsk, bsk, waf, baf};
  const long long blocks = (long long)b * ((n + T - 1) / T);
  refine_local_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(grouped, p, d, n, T, out);
  return (int)cudaGetLastError();
}
