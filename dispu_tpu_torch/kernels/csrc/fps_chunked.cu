// Exact farthest-point sampling for clouds past fps.cu's 32,768 points:
// one thread block cluster per cloud.
//
// Replaces fps_pallas_chunked (dispu_tpu/ops/pallas_kernels.py:526, its
// kernel body at :253) and fps_pallas_chunked_batch (:471, body at :362).
// The TPU kernel gets first occurrence by visiting chunks in order with a
// strict > and taking the least flat index among ties; here each CTA owns
// one contiguous index range and every reduction orders candidates by
// (value descending, index ascending), which is the same rule.  Each cloud
// of a batch gets its own cluster: on the TPU the batch kernel advances B
// clouds in one core's rounds, here the batch is the grid.
//
// The semantics, what bounds the kernel on an H100 (the latency of its
// serial argmax chain: the 16x merge of a 2048-point cloud is 32,767
// dependent rounds) and the round itself (redux.sync a level, each warp's
// winner pushed into every CTA, one cluster barrier) are fps_common.cuh's,
// which fps.cu shares.  What differs here is the forms: a cloud this size
// does not fit one SM, so it is spread over a cluster of 5, 6 or 8 CTAs
// (8 is the portable maximum) of 512 threads, 16 to 24 points a thread in
// registers (128 registers a thread, no spill); past 98,304 points its
// coordinates stay in the CTAs' shared memory (36 a thread), past 147,456
// in device memory.  512 threads a CTA: 1024 threads hold 12 points a
// thread only by spilling (64 registers), and twice the warps push twice
// the candidates into every CTA each round; 256 threads make the round
// longer too.  A cluster of 16 CTAs (non-portable) was slower still.  A
// cloud takes the first form of with_form's list that holds it.

#include "fps_common.cuh"

namespace {

using fps_round::Describe;
using fps_round::first_holding;
using fps_round::Form;
using fps_round::kDevice;
using fps_round::kRegisters;
using fps_round::kShared;
using fps_round::Launch;

// The forms, smallest first, each timed at its limit against the next
// larger one with time_fps.  At 16 points a thread in registers, 5 or 6
// CTAs: a shorter cluster barrier and 80 or 96 slots, three a lane to
// reduce; 7 CTAs have 112 slots, four a lane as at 8, and lost to 8 x 16
// at 57,344 points.  Then the fewest points a thread at 8 CTAs (the
// portable maximum), then the coordinates in shared memory, then device
// memory.
template <class Op>
int with_form(int n, const Op& op) {
  return first_holding<
      Form<5, 512, 16, kRegisters>, Form<6, 512, 16, kRegisters>,
      Form<8, 512, 16, kRegisters>, Form<8, 512, 20, kRegisters>,
      Form<8, 512, 24, kRegisters>, Form<8, 512, 36, kShared>,
      Form<8, 1024, 0, kDevice>>(n, op);
}

}  // namespace

// The form an n-point cloud takes: shape[0..3] = CTAs a cluster, threads
// a CTA, points a thread (0 in device memory), fps_round::Storage.
extern "C" int dispu_fps_chunked_form(int n, int* shape) {
  if (n < 1 || shape == nullptr) return (int)cudaErrorInvalidValue;
  return with_form(n, Describe{shape});
}

// How many clusters of the form for n points the current device can hold
// at once; 0 means the form cannot be scheduled there.
extern "C" int dispu_fps_chunked_max_clusters(int n, int* count) {
  if (n < 1 || count == nullptr) return (int)cudaErrorInvalidValue;
  return with_form(n, Launch{nullptr, nullptr, nullptr, 1, n, 1, 0, count});
}

// scratch: b x n floats, used only by the device form.
extern "C" int dispu_fps_chunked(const float* xyz, int* out, float* scratch,
                                 int b, int n, int npoint, void* stream) {
  if (b < 1 || n < 1 || npoint < 1) return (int)cudaErrorInvalidValue;
  return with_form(n, Launch{xyz, out, scratch, b, n, npoint,
                             (cudaStream_t)stream, nullptr});
}
