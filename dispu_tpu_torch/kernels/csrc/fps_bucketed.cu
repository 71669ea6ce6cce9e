// Farthest-point sampling inside each bucket of a pre-partitioned cloud.
//
// Replaces fps_bucketed_pallas (dispu_tpu/ops/pallas_kernels.py:631), the
// merge FPS of farthest_point_sample_bucketed.  Input (K, n_b, 3) buckets,
// output (K, m_b) LOCAL indices.  Per bucket the semantics are exact FPS,
// those of fps.cu; the TPU kernel edge-padded n_b to 128 lanes, here only
// indices < n_b are candidates, so any n_b is taken as it is.
//
// A bucket is one "cloud" of fps_common.cuh's round (its semantics, what
// bounds it on an H100 and its design are there): the bucket's points in
// registers, redux.sync a level, one barrier a round.  The grid is all
// B * K buckets of B clouds, so one launch merges a whole batch.  Buckets
// are small (the 4x merge of a 2048-point cloud: 64 x 384 points -> 128
// samples, 16x: 64 x 1536 -> 512), so a round is short and its length is
// set by how many instructions its warps execute in a row: three points a
// thread, as many warps as that takes, beat fewer warps with more points
// each and a single warp with no barrier at all (time_fps, PERF.md).
// Large scans give large buckets (a 60,000-point cloud at 4x: 64 x 11,248
// -> 3,750): there one block of 1024 threads, in registers up to 6,144
// points, the coordinates in shared memory up to 18,432 (a cluster of two
// blocks was slower), device memory beyond.  A bucket takes the first
// form of with_form's list that holds it.

#include "fps_common.cuh"

namespace {

using fps_round::Describe;
using fps_round::first_holding;
using fps_round::Form;
using fps_round::kDevice;
using fps_round::kRegisters;
using fps_round::kShared;
using fps_round::Launch;

// The forms, smallest first; 384 (4 warps of 3), 1536 (16 of 3) and 11,248
// points (32 of 12, coordinates in shared memory) were each timed against
// other forms that hold them with time_fps --kernel fps_bucketed.
template <class Op>
int with_form(int nb, const Op& op) {
  return first_holding<
      Form<1, 64, 3, kRegisters>, Form<1, 128, 3, kRegisters>,
      Form<1, 256, 3, kRegisters>, Form<1, 512, 3, kRegisters>,
      Form<1, 1024, 3, kRegisters>, Form<1, 1024, 6, kRegisters>,
      Form<1, 1024, 12, kShared>, Form<1, 1024, 18, kShared>,
      Form<1, 1024, 0, kDevice>>(nb, op);
}

}  // namespace

// The form a bucket of nb points takes: shape[0..3] = CTAs a cluster,
// threads a CTA, points a thread (0 in device memory), fps_round::Storage.
extern "C" int dispu_fps_bucketed_form(int nb, int* shape) {
  if (nb < 1 || shape == nullptr) return (int)cudaErrorInvalidValue;
  return with_form(nb, Describe{shape});
}

// scratch: buckets x nb floats, used only by the device form.
extern "C" int dispu_fps_bucketed(const float* pts, float* scratch, int* out,
                                  int buckets, int nb, int mb, void* stream) {
  if (buckets < 1 || nb < 1 || mb < 1) return (int)cudaErrorInvalidValue;
  return with_form(nb, Launch{pts, out, scratch, buckets, nb, mb,
                              (cudaStream_t)stream, nullptr});
}
