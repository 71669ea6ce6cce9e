// Exact farthest-point sampling.
//
// Replaces fps_pallas (dispu_tpu/ops/pallas_kernels.py).  Semantics: the
// first sample is index 0; every running min-distance starts at 1e38; each
// round takes the first-occurrence argmax of the updated min-distances;
// the distance is (x-px)^2 + (y-py)^2 + (z-pz)^2 in that order, with
// round-to-nearest intrinsics so nvcc cannot contract it into FMAs (an FMA
// changes the bits of the distances and so the order of near-ties).
// Padding does not exist here: only indices < n are ever candidates.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The argmax
// chain is serial (round j needs round j-1's winner), so the merge of a
// 2048-point cloud (24,576 points -> 8,192 samples) is 8,191 dependent
// rounds of one block-wide reduction each.  Design: one block of 1024
// threads per cloud; each thread owns a strided share of the points and
// keeps their running min-distances in registers (up to 32 per thread, so
// n <= 32,768; larger clouds go to fps_chunked.cu, one cluster per cloud);
// each round is one pass over the thread's points, a warp shuffle
// reduction of (max value, lowest index), and a second one across the 32
// warps through shared memory: two block barriers a round.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRegs = 32;  // min-distances per thread held in registers

__device__ __forceinline__ float sq_dist(const float* p, float px, float py,
                                         float pz) {
  const float dx = __fsub_rn(p[0], px);
  const float dy = __fsub_rn(p[1], py);
  const float dz = __fsub_rn(p[2], pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void take_max(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
}

// Min-distances of points tid + r*1024 (r < kRegs) in registers; the
// i < n guard skips the slots past the cloud, so one instantiation serves
// every n up to kRegs * 1024.
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n,
           int npoint) {
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cloud = blockIdx.x;
  const float* pts = xyz + cloud * n * 3;
  int* o = out + cloud * npoint;

  float md[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) md[r] = 1e38f;
  if (tid == 0) o[0] = 0;
  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float px = pts[3 * last], py = pts[3 * last + 1],
                pz = pts[3 * last + 2];
    float bv = -1.f;  // below every min-distance (all are >= 0)
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int i = tid + r * kThreads;
      if (i < n) {
        const float v = fminf(md[r], sq_dist(pts + 3 * i, px, py, pz));
        md[r] = v;
        if (v > bv) { bv = v; bi = i; }  // ascending i: keeps the first
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_max(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
               __shfl_xor_sync(0xffffffffu, bi, off));
    if (lane == 0) { s_v[warp] = bv; s_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = s_v[lane];
      bi = s_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_max(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                 __shfl_xor_sync(0xffffffffu, bi, off));
      if (lane == 0) { s_last = bi; o[j] = bi; }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

// n <= 32,768 (kernels/fps.py: FPS_MAX_N); larger clouds are refused.
extern "C" int dispu_fps(const float* xyz, int* out, int b, int n, int npoint,
                         void* stream) {
  if (b < 1 || n < 1 || npoint < 1 || n > kRegs * kThreads)
    return (int)cudaErrorInvalidValue;
  fps_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(xyz, out, n, npoint);
  return (int)cudaGetLastError();
}
