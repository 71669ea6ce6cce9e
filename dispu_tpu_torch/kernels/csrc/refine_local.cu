// The refiner's fused local + skip branch on an already grouped tensor.
//
// Replaces refine_local_pallas (dispu_tpu/ops/pallas_kernels.py): from the
// grouped [centred xyz | raw xyz | features] tensor (b, n, k, cf) and the
// pre-folded parameters (the weight net's inference BN in ww, bw;
// after_conv as (k, c2, co) t-major blocks), out (b, n, co) =
// relu(after_conv(pool)) + relu(skip), with no (b, n, k, .) intermediate
// in device memory.  The math is refine_common.cuh's: 3xTF32 products on
// the tensor cores, f32-grade.
//
// What bounds it on an H100: operations, in principle.  At the refiner's
// pass-1 shape (32 clouds x 1024 queries, k = 16, cf = 134, c1 = c2 =
// 128, co = 256) the products are about 74 GFLOP (conv0 18.0, conv1 17.2,
// after_conv 34.4, pooling 2.1, skip 2.3): 1.10 ms at the card's f32 rate
// of 67 TFLOP/s, or 0.45 ms as three TF32 passes at 495 TFLOP/s, against
// 281 MB of grouped input (0.084 ms at 3.35 TB/s); pass 2 (4096 queries a
// cloud) is 4x that.  Design (refine_common.cuh): one block per tile of
// T = 8 queries (128 grouped rows, one coalesced copy into shared
// memory), two consecutive tiles a cluster; the weights (2.51 MB in
// fragment order) stream through a 2 x 32 KB ring, each byte read from L2
// once a cluster: 5.13 GB a launch at pass 1 (2048 clusters), 20.5 GB at
// pass 2, against 9.7 and 38.9 GB when each block read all of 2.37 MB of
// raw weights for itself.  On an H100 at 700 W it takes about 2.9 ms at
// pass 1, 2.6x the f32 bound (PERF.md): the products run far below the
// tensor cores' rate (mma.sync, splits in registers, the heads' n side
// of 16 queries), and about a quarter of the time is in none of them:
// the ring's round trips (each block takes in 1.39 MB of weights for its
// 8 queries) and the cluster's barriers.  Its 222,000 bytes of shared
// memory keep one block an SM.  A TPU tile of 128 queries does not carry
// over: the TPU's VMEM holds megabytes.

#include "refine_common.cuh"

namespace {

using namespace refine_common;

__global__ void __launch_bounds__(kThreads, 1)
    refine_local_kernel(const float* __restrict__ grouped, Params p, Dims d,
                        int n, int T, long long tiles_total,
                        float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring = ring_start(smem, d, p.packed);
  if (threadIdx.x >= kCompute) {  // the producer warp
    cluster_arrive();  // for the pools' exchange in tile_mlp
    if (ring.rank == 0 && threadIdx.x == kCompute) ring.produce();
    __syncwarp();
    cluster_wait();
  } else {
    float* work = reinterpret_cast<float*>(smem + ring_bytes());
    TileOut outs[kPair];
    TilePos mine{};
#pragma unroll
    for (int j = 0; j < kPair; ++j) {
      const TilePos t = tile_pos(
          (long long)blockIdx.x - ring.rank % kPair + j, tiles_total, n, T);
      outs[j] = TileOut{out + ((size_t)t.cloud * n + t.q0) * d.co, t.valid};
      if (j == ring.rank % kPair) mine = t;
    }
    // the tile's rows are contiguous in (b, n, k, cf): one coalesced copy
    copy_rows(grouped + ((size_t)mine.cloud * n + mine.q0) * d.k * d.cf,
              rows32(T, d.k), mine.valid * d.k, d.cf, up8(d.cf),
              work, ld(d.cf));
    compute_sync();
    tile_mlp(work, T, d, p, outs, ring);
  }
  cluster_sync();  // no block leaves while the cluster still copies
}

}  // namespace

// Shared-memory bytes of one block, or 0 when it exceeds a block's limit.
extern "C" size_t dispu_refine_local_smem(int k, int cf, int c1, int c2,
                                          int co, int T) {
  const Dims d{k, cf, c1, c2, co};
  const size_t bytes = ring_bytes() + mlp_floats(T, d) * sizeof(float);
  return bytes <= kMaxSmem ? bytes : 0;
}

// Clusters of this launch's shape that the current device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int dispu_refine_local_clusters(size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaFuncSetAttribute(
      refine_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters,
                                       (const void*)refine_local_kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Floats of the fragment-ordered weights the launch writes to `packed`.
extern "C" size_t dispu_refine_local_packed(int k, int cf, int c1, int c2,
                                            int co) {
  return packed_floats(Dims{k, cf, c1, c2, co});
}

// grouped (b, n, k, cf); w0 (cf, c1), w1 (c1, c2), ww (3, k), wsk (cf, co),
// waf (k, c2, co) row-major; biases of the output widths; packed:
// dispu_refine_local_packed floats of scratch; out (b, n, co).  T queries
// a block, 1 <= T <= kMaxT, T k <= kMaxRows, with its shared memory
// within a block's limit.
extern "C" int dispu_refine_local(const float* grouped, const float* w0,
                                  const float* b0, const float* w1,
                                  const float* b1, const float* ww,
                                  const float* bw, const float* wsk,
                                  const float* bsk, const float* waf,
                                  const float* baf, float* packed, float* out,
                                  int b, int n, int k, int cf, int c1, int c2,
                                  int co, int T, void* stream) {
  const Dims d{k, cf, c1, c2, co};
  if (b < 1 || n < 1 || k < 1 || cf < 3 || c1 < 1 || c2 < 1 || co < 1 ||
      T < 1 || T > kMaxT || T * k > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dispu_refine_local_smem(k, cf, c1, c2, co, T);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const Params p{w0, b0, w1, b1, ww, bw, wsk, bsk, waf, baf, packed};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = pack_weights(p, d, packed, s);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)b * ((n + T - 1) / T);
  return launch_clusters(refine_local_kernel, tiles, smem, s, grouped, p, d,
                         n, T, tiles, out);
}
