// The refiner's mega-fused block: the neighbourhood gathers and the
// local + skip branches over each point's exact self-kNN, in one kernel
// that takes the selection from knn.cu's launch before it.
//
// Replaces refine_block_pallas (dispu_tpu/ops/pallas_kernels.py): from the
// coarse points xyz (b, n, 3), their features (b, n, c), the (b, n, k)
// indices of each point's k <= 16 nearest points of its own cloud, which
// knn.cu's tiled stream computes in the launch before this one (the
// caller's knn_cuda: knn_pallas's bits, any n), and the pre-folded
// parameters of refine_local.cu, out (b, n, co) = relu(after_conv(pool))
// + relu(skip), each neighbourhood grouped as [p - q | p | bf16(feature
// of p)], the features rounded once to bf16 (to nearest even,
// __float2bfloat16_rn), the xyz exact.  No (b, n, k, .) tensor is ever
// written to device memory: the indices are (b, n, k) ints.
//
// One block per tile of T = 8 queries, two consecutive tiles a cluster
// sharing the weights' ring and the heads (refine_common.cuh), in two
// phases:
//   A. the tile's T k indices into shared memory, one coalesced read;
//      meanwhile the ring's first chunks land.
//   B. the tile's grouped rows, one warp per row, lanes over the feature
//      row (coalesced); then refine_common.cuh's tile_mlp, the same code
//      as refine_local.cu's.
//
// What bounds it on an H100: as refine_local.cu (74 GFLOP at the pass-1
// shape, 1.10 ms at the f32 rate, 0.45 as 3xTF32; pass 2 4x that; the
// same L2 traffic, 5.13 GB a launch at pass 1 and 20.5 GB at pass 2),
// and before it the selection, n (2 c + 4) flops a query and about k (1 +
// ln(n / k)) insertions into its list for points in random order, each a
// chain of shuffles: latency, which knn.cu's launch hides with 20 warps
// an SM and this kernel (one block an SM, nine warps) cannot.  So the
// selection left this kernel.  Its first form here (k rounds of a warp a
// query over an n-float row in shared memory) took 3.96 of 15.66 ms at
// pass 2's 4,096 points and capped n at 5,195; streamed through shared
// memory inside the kernel, with a query's k best in registers as in
// knn.cu, it took 2.84 ms (one query a warp; eight queries a warp over an
// eighth of the cloud each, 6.82), where knn.cu's launch takes 1.35
// (PERF.md).
// Limits: the ring and the tile's indices and regions; n enters neither,
// so the block's shared memory depends on k and the widths alone (222,512
// bytes at GeneratorConfig() width) and n only on int32 indices.

#include <cuda_bf16.h>

#include "refine_common.cuh"

namespace {

using namespace refine_common;

__global__ void __launch_bounds__(kThreads, 1)
    refine_block_kernel(const float* __restrict__ xyz,
                        const int* __restrict__ idx,
                        const float* __restrict__ feats, Params p, Dims d,
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
    int* sidx = reinterpret_cast<int*>(smem + ring_bytes());
    const int k = d.k, c = d.cf - 6;
    float* work = reinterpret_cast<float*>(sidx) + round4((size_t)T * k);
    TileOut outs[kPair];
    TilePos mine{};
#pragma unroll
    for (int j = 0; j < kPair; ++j) {
      const TilePos t = tile_pos(
          (long long)blockIdx.x - ring.rank % kPair + j, tiles_total, n, T);
      outs[j] = TileOut{out + ((size_t)t.cloud * n + t.q0) * d.co, t.valid};
      if (j == ring.rank % kPair) mine = t;
    }
    const long long cloud = mine.cloud;
    const int q0 = mine.q0, valid = mine.valid;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float* pts = xyz + (size_t)cloud * n * 3;

    // phase A: the tile's indices
    const int* tidx = idx + ((size_t)cloud * n + q0) * k;
    for (int e = threadIdx.x; e < valid * k; e += kCompute) sidx[e] = tidx[e];
    compute_sync();

    // phase B: the grouped rows [p - q | p | bf16(f_p)], zero past cf up
    // to up8(cf) and in rows past the valid queries' (up to R32)
    const int ldg = ld(d.cf), cpad = up8(d.cf);
    float* G = work;  // region A
    for (int r = warp; r < rows32(T, k); r += kWarps) {
      float* g = G + (size_t)r * ldg;
      const int q = r / k;
      if (q >= valid) {
        for (int t = lane; t < cpad; t += 32) g[t] = 0.f;
        continue;
      }
      const int j = sidx[r];
      const bool in = j >= 0 && j < n;  // INT_MAX: fewer finite distances
      const float* pj = pts + (size_t)(in ? j : 0) * 3;
      if (lane < 3) {
        const float v = in ? pj[lane] : 0.f;
        g[lane] = __fsub_rn(v, pts[(size_t)(q0 + q) * 3 + lane]);
        g[3 + lane] = v;
      }
      if (lane < cpad - d.cf) g[d.cf + lane] = 0.f;
      const float* f = feats + ((size_t)cloud * n + (in ? j : 0)) * c;
      for (int t0 = lane; t0 < c; t0 += 32 * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + 32 * u;
          v[u] = (in && t < c) ? f[t] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = t0 + 32 * u;
          if (t < c) g[6 + t] = __bfloat162float(__float2bfloat16_rn(v[u]));
        }
      }
    }
    compute_sync();
    tile_mlp(work, T, d, p, outs, ring);
  }
  cluster_sync();  // no block leaves while the cluster still copies
}

}  // namespace

// Shared-memory bytes of one block, or 0 when it exceeds a block's limit:
// the ring, the tile's indices, then tile_mlp's regions.
extern "C" size_t dispu_refine_block_smem(int k, int cf, int c1, int c2,
                                          int co, int T) {
  const Dims d{k, cf, c1, c2, co};
  const size_t floats = round4((size_t)T * k) + mlp_floats(T, d);
  const size_t bytes = ring_bytes() + floats * sizeof(float);
  return bytes <= kMaxSmem ? bytes : 0;
}

// Floats of the fragment-ordered weights the launch writes to `packed`.
extern "C" size_t dispu_refine_block_packed(int k, int cf, int c1, int c2,
                                            int co) {
  return packed_floats(Dims{k, cf, c1, c2, co});
}

// xyz (b, n, 3); idx (b, n, k) int32, each point's k nearest points of
// its cloud (knn.cu's; INT_MAX where fewer than k distances are finite);
// feats (b, n, cf - 6); the weights as dispu_refine_local's with w0 and
// wsk of cf = 6 + c rows; packed: dispu_refine_block_packed floats of
// scratch; out (b, n, co).
extern "C" int dispu_refine_block(const float* xyz, const int* idx,
                                  const float* feats, const float* w0,
                                  const float* b0, const float* w1,
                                  const float* b1, const float* ww,
                                  const float* bw, const float* wsk,
                                  const float* bsk, const float* waf,
                                  const float* baf, float* packed, float* out,
                                  int b, int n, int k, int cf, int c1, int c2,
                                  int co, int T, void* stream) {
  const Dims d{k, cf, c1, c2, co};
  if (b < 1 || n < 1 || k < 1 || k > n || cf < 7 || c1 < 1 || c2 < 1 ||
      co < 1 || T < 1 || T > kMaxT || T * k > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dispu_refine_block_smem(k, cf, c1, c2, co, T);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const Params p{w0, b0, w1, b1, ww, bw, wsk, bsk, waf, baf, packed};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = pack_weights(p, d, packed, s);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)b * ((n + T - 1) / T);
  return launch_clusters(refine_block_kernel, tiles, smem, s, xyz, idx,
                         feats, p, d, n, T, tiles, out);
}
