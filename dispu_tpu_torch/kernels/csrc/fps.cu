// Exact farthest-point sampling for clouds of up to 32,768 points.
//
// Replaces fps_pallas (dispu_tpu/ops/pallas_kernels.py:87) and, under its
// own count, fps_pallas_lite (:211).  The semantics, what bounds the
// kernel on an H100 and the design of its round are in fps_common.cuh,
// which fps_chunked.cu shares.  Here a cloud lives in registers: 8 points
// a thread, one block of 256 or 1024 threads up to 8,192 points, a
// cluster of 2, 3 or 4 blocks of 1024 beyond.

#include "fps_common.cuh"

namespace {

// the forms of this kernel: CL CTAs of T threads, 8 points a thread in
// registers
template <int CL, int T>
int form(const float* xyz, int* out, int b, int n, int npoint,
         cudaStream_t stream) {
  return fps_round::run<CL, T, 8, fps_round::kRegisters>(
      xyz, out, nullptr, b, n, npoint, stream, nullptr);
}

}  // namespace

// A cloud takes the smallest form that holds it, n <= CL * T * P: the
// fewest CTAs, since each one more lengthens the cluster barrier (3 CTAs
// for the 4x merge of a 2048-point cloud, 24,576 points).  Larger clouds
// (kernels/fps.py: FPS_MAX_N) are refused.
extern "C" int dispu_fps(const float* xyz, int* out, int b, int n, int npoint,
                         void* stream) {
  if (b < 1 || n < 1 || npoint < 1 || n > 4 * 1024 * 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 256 * 8) return form<1, 256>(xyz, out, b, n, npoint, s);
  if (n <= 1024 * 8) return form<1, 1024>(xyz, out, b, n, npoint, s);
  if (n <= 2 * 1024 * 8) return form<2, 1024>(xyz, out, b, n, npoint, s);
  if (n <= 3 * 1024 * 8) return form<3, 1024>(xyz, out, b, n, npoint, s);
  return form<4, 1024>(xyz, out, b, n, npoint, s);
}
