// Farthest-point sampling inside each bucket of a pre-partitioned cloud.
//
// Replaces fps_bucketed_pallas (dispu_tpu/ops/pallas_kernels.py), the
// merge FPS of farthest_point_sample_bucketed.  Input (K, n_b, 3) buckets,
// output (K, m_b) LOCAL indices.  Per bucket the semantics are exact FPS
// (_fps_xla on that bucket, and fps.cu): seed at local index 0, every
// min-distance from 1e38, the distance (x-px)^2 + (y-py)^2 + (z-pz)^2 in
// that order with round-to-nearest intrinsics (no FMA), and the
// first-occurrence argmax.  The TPU kernel edge-padded n_b to 128 lanes;
// here only indices < n_b are candidates, so any n_b is taken as it is.
//
// What bounds it on an H100: the latency of each bucket's serial argmax
// chain (m_b - 1 dependent rounds), not bytes or FLOPs.  At the 4x merge
// of a 2048-point cloud the buckets are 64 x 384 points -> 128 samples, at
// 16x 64 x 1536 -> 512.  Design: one warp per bucket and one bucket per
// block, so that the buckets spread over the SMs; the bucket's coordinates
// in shared memory (structure of arrays, conflict-free), each lane's
// min-distances in registers (PER of them, for n_b <= 32 * PER), and each
// round one warp-shuffle argmax with no block barrier.  The grid is all
// B * K buckets of B clouds: one launch merges a whole batch.  Buckets
// past 2,048 points take a form with the min-distances in device memory
// (scratch from the caller) and the coordinates read from the input.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRegMaxNb = 2048;  // 64 min-distances a lane

__device__ __forceinline__ float sq_dist(float x, float y, float z, float px,
                                         float py, float pz) {
  const float dx = __fsub_rn(x, px);
  const float dy = __fsub_rn(y, py);
  const float dz = __fsub_rn(z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
}

template <int PER>
__global__ void __launch_bounds__(32)
fps_bucketed_kernel(const float* __restrict__ pts, int* __restrict__ out,
                    int nb, int mb) {
  extern __shared__ float s[];
  float* sx = s;
  float* sy = s + nb;
  float* sz = s + 2 * nb;
  const int lane = threadIdx.x;
  const long long bucket = blockIdx.x;
  const float* p = pts + bucket * nb * 3;
  for (int i = lane; i < nb; i += 32) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  __syncwarp();
  float md[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) md[r] = 1e38f;
  int* o = out + bucket * mb;
  if (lane == 0) o[0] = 0;
  int last = 0;
  for (int j = 1; j < mb; ++j) {
    const float px = sx[last], py = sy[last], pz = sz[last];
    float bv = -1.f;  // below every min-distance (all are >= 0)
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = lane + 32 * r;
      if (i < nb) {
        const float v = fminf(md[r], sq_dist(sx[i], sy[i], sz[i], px, py, pz));
        md[r] = v;
        if (v > bv) { bv = v; bi = i; }  // ascending i: keeps the first
      }
    }
    warp_argmax(bv, bi);
    last = bi;
    if (lane == 0) o[j] = bi;
  }
}

__global__ void __launch_bounds__(32)
fps_bucketed_mem_kernel(const float* __restrict__ pts, float* __restrict__ md,
                        int* __restrict__ out, int nb, int mb) {
  const int lane = threadIdx.x;
  const long long bucket = blockIdx.x;
  const float* p = pts + bucket * nb * 3;
  float* m = md + bucket * nb;
  for (int i = lane; i < nb; i += 32) m[i] = 1e38f;
  int* o = out + bucket * mb;
  if (lane == 0) o[0] = 0;
  int last = 0;
  for (int j = 1; j < mb; ++j) {
    const float px = p[3 * last], py = p[3 * last + 1], pz = p[3 * last + 2];
    float bv = -1.f;
    int bi = INT_MAX;
    for (int i = lane; i < nb; i += 32) {
      const float v =
          fminf(m[i], sq_dist(p[3 * i], p[3 * i + 1], p[3 * i + 2], px, py, pz));
      m[i] = v;  // only this lane reads it again
      if (v > bv) { bv = v; bi = i; }
    }
    warp_argmax(bv, bi);
    last = bi;
    if (lane == 0) o[j] = bi;
  }
}

template <int PER>
int launch_reg(const float* pts, int* out, int buckets, int nb, int mb,
               cudaStream_t stream) {
  const size_t smem = (size_t)3 * nb * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_bucketed_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_bucketed_kernel<PER><<<buckets, 32, smem, stream>>>(pts, out, nb, mb);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch: nb floats a bucket of device memory, used only for nb > 2,048
// (may be null below that).
extern "C" int dispu_fps_bucketed(const float* pts, float* scratch, int* out,
                                  int buckets, int nb, int mb, void* stream) {
  if (buckets < 1 || nb < 1 || mb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = (nb + 31) / 32;
  if (per <= 4) return launch_reg<4>(pts, out, buckets, nb, mb, s);
  if (per <= 8) return launch_reg<8>(pts, out, buckets, nb, mb, s);
  if (per <= 12) return launch_reg<12>(pts, out, buckets, nb, mb, s);
  if (per <= 16) return launch_reg<16>(pts, out, buckets, nb, mb, s);
  if (per <= 24) return launch_reg<24>(pts, out, buckets, nb, mb, s);
  if (per <= 32) return launch_reg<32>(pts, out, buckets, nb, mb, s);
  if (per <= 48) return launch_reg<48>(pts, out, buckets, nb, mb, s);
  if (per <= kRegMaxNb / 32) return launch_reg<64>(pts, out, buckets, nb, mb, s);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  fps_bucketed_mem_kernel<<<buckets, 32, 0, s>>>(pts, scratch, out, nb, mb);
  return (int)cudaGetLastError();
}
