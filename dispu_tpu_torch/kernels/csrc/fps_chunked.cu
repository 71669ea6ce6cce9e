// Exact farthest-point sampling for clouds past one SM: one thread block
// cluster per cloud.
//
// Replaces fps_pallas_chunked (dispu_tpu/ops/pallas_kernels.py:526, its
// kernel body at :253) and fps_pallas_chunked_batch (:471, body at :362).
// Semantics are fps.cu's: the first sample is index 0; every running
// min-distance starts at 1e38; each round takes the first-occurrence argmax
// of the updated min-distances; the distance is (x-px)^2 + (y-py)^2 +
// (z-pz)^2 in that order, with round-to-nearest intrinsics so nvcc cannot
// contract it into FMAs.  The TPU kernel gets first occurrence by visiting
// chunks in order with a strict > and taking the least flat index among
// ties; here each CTA owns one contiguous index range and every reduction
// orders candidates by (value descending, index ascending), which is the
// same rule.  Each cloud of a batch gets its own cluster: on the TPU the
// batch kernel advances B clouds in one core's rounds, here the batch is
// the grid.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The argmax
// chain is serial (round j needs round j-1's winner): the 16x merge of a
// 2048-point cloud (98,304 points -> 32,768 samples) is 32,767 dependent
// rounds.  A cloud that size does not fit one SM, and one block that
// re-reads it from L2 every round pays L2 latency and one SM's L2 bandwidth
// in every round.  Design: a cluster of 8 CTAs (the portable size) x 1024
// threads holds the cloud on chip.  CTA r owns points [r*chunk,
// (r+1)*chunk), chunk = ceil(n/8), keeps their coordinates in dynamic
// shared memory as three planes and their min-distances in registers (R a
// thread, a template count).  A round is one pass over the thread's
// points, a warp shuffle reduction of the candidate (value, index, x, y,
// z), a second one across the 32 warps through shared memory (one block
// barrier), a write of the CTA's candidate to its own shared slot
// (double-buffered by round parity), one cluster barrier, and a reduction
// of the 8 slots, which every warp of every CTA reads through distributed
// shared memory in the same order.  The winner's coordinates ride the
// reductions, as the TPU kernel carries xv/yv/zv, so no round waits on a
// dependent global load.  Past the cluster's on-chip capacity
// (8 x 18 x 1024 = 147,456 points) the kernel reads its chunk's coordinates
// from the input and its min-distances from a wrapper-allocated buffer in
// device memory instead (R == 0); the selection is the same.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;    // CTAs a cloud; 8 is the portable maximum
constexpr int kMaxRegs = 18;   // 12 B * 18 * 1024 = 221,184 B of shared memory

struct Cand {
  float v;  // min-distance, -1 where the thread or CTA has no point
  int i;    // point index, INT_MAX where there is none
  float x, y, z;
};

__device__ __forceinline__ float sq_dist(float x, float y, float z, float px,
                                         float py, float pz) {
  const float dx = __fsub_rn(x, px);
  const float dy = __fsub_rn(y, py);
  const float dz = __fsub_rn(z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (value descending, index ascending): a total order on the candidates,
// so every reduction order gives the same winner
__device__ __forceinline__ void take_max(Cand& a, const Cand& b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) a = b;
}

__device__ __forceinline__ Cand shfl_xor(const Cand& c, int off) {
  Cand o;
  o.v = __shfl_xor_sync(0xffffffffu, c.v, off);
  o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
  o.x = __shfl_xor_sync(0xffffffffu, c.x, off);
  o.y = __shfl_xor_sync(0xffffffffu, c.y, off);
  o.z = __shfl_xor_sync(0xffffffffu, c.z, off);
  return o;
}

__host__ __device__ __forceinline__ int chunk_of(int n) {
  return (n + kCluster - 1) / kCluster;
}

// R > 0: the chunk's coordinates in shared memory, the min-distances of
// local points tid + r*1024 (r < R) in registers; the l < cnt guard skips
// the slots past the chunk.  R == 0: coordinates from `xyz`, min-distances
// in `scratch` (b x n floats).
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
fps_chunked_kernel(const float* __restrict__ xyz, int* __restrict__ out,
                   float* __restrict__ scratch, int n, int npoint) {
  extern __shared__ float s_pts[];  // R > 0: x, y, z planes of the chunk
  __shared__ Cand s_warp[kWarps];
  __shared__ Cand s_slot[2];        // this CTA's candidate, by round parity
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const long long cloud = blockIdx.x / kCluster;
  const int chunk = chunk_of(n);
  const int base = rank * chunk;
  const int cnt = max(0, min(n - base, chunk));
  const float* pts = xyz + cloud * n * 3;
  int* o = out + cloud * npoint;
  float* s_x = s_pts;
  float* s_y = s_pts + chunk;
  float* s_z = s_pts + 2 * chunk;
  float* mdg = R > 0 ? nullptr : scratch + cloud * n + base;

  float md[R > 0 ? R : 1];
  if constexpr (R > 0) {
    for (int l = tid; l < cnt; l += kThreads) {
      const float* p = pts + 3LL * (base + l);
      s_x[l] = p[0];
      s_y[l] = p[1];
      s_z[l] = p[2];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) md[r] = 1e38f;
    __syncthreads();
  } else {
    for (int l = tid; l < cnt; l += kThreads) mdg[l] = 1e38f;
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  float px = pts[0], py = pts[1], pz = pts[2];
  for (int j = 1; j < npoint; ++j) {
    Cand c{-1.f, INT_MAX, 0.f, 0.f, 0.f};  // below every min-distance
    if constexpr (R > 0) {
      int bl = -1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int l = tid + r * kThreads;
        if (l < cnt) {
          const float v =
              fminf(md[r], sq_dist(s_x[l], s_y[l], s_z[l], px, py, pz));
          md[r] = v;
          if (v > c.v) { c.v = v; bl = l; }  // ascending l: keeps the first
        }
      }
      if (bl >= 0) {
        c.i = base + bl;
        c.x = s_x[bl];
        c.y = s_y[bl];
        c.z = s_z[bl];
      }
    } else {
      for (int l = tid; l < cnt; l += kThreads) {
        const float* p = pts + 3LL * (base + l);
        const float x = p[0], y = p[1], z = p[2];
        const float v = fminf(mdg[l], sq_dist(x, y, z, px, py, pz));
        mdg[l] = v;
        if (v > c.v) c = Cand{v, base + l, x, y, z};
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) take_max(c, shfl_xor(c, off));
    if (lane == 0) s_warp[warp] = c;
    __syncthreads();
    if (warp == 0) {
      c = s_warp[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) take_max(c, shfl_xor(c, off));
      if (lane == 0) s_slot[j & 1] = c;
    }
    // release this CTA's slot to the cluster, acquire the others'
    cluster.sync();
    c = *cluster.map_shared_rank(&s_slot[j & 1], lane & (kCluster - 1));
#pragma unroll
    for (int off = kCluster / 2; off > 0; off >>= 1)
      take_max(c, shfl_xor(c, off));
    if (rank == 0 && tid == 0) o[j] = c.i;
    px = c.x;
    py = c.y;
    pz = c.z;
  }
  // no CTA leaves while another may still read its slots
  cluster.sync();
}

template <int R>
size_t smem_bytes(int n) {
  return R > 0 ? 3 * sizeof(float) * (size_t)chunk_of(n) : 0;
}

// max_clusters == nullptr: launch; otherwise write how many such clusters
// the card can hold at once (cudaOccupancyMaxActiveClusters) and launch
// nothing.
template <int R>
int run(const float* xyz, int* out, float* scratch, int b, int n, int npoint,
        cudaStream_t stream, int* max_clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      fps_chunked_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(3 * sizeof(float) * R * kThreads));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<R>(n);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(
        max_clusters, (const void*)fps_chunked_kernel<R>, &cfg);
  err = cudaLaunchKernelEx(&cfg, fps_chunked_kernel<R>, xyz, out, scratch, n,
                           npoint);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch(const float* xyz, int* out, float* scratch, int b, int n,
             int npoint, cudaStream_t stream, int* max_clusters) {
  const int regs = (chunk_of(n) + kThreads - 1) / kThreads;
  if (regs <= 6)
    return run<6>(xyz, out, scratch, b, n, npoint, stream, max_clusters);
  if (regs <= 12)
    return run<12>(xyz, out, scratch, b, n, npoint, stream, max_clusters);
  if (regs <= kMaxRegs)
    return run<kMaxRegs>(xyz, out, scratch, b, n, npoint, stream,
                         max_clusters);
  return run<0>(xyz, out, scratch, b, n, npoint, stream, max_clusters);
}

}  // namespace

// The form the kernel takes for an n-point cloud: R, the min-distances a
// thread holds in registers with the coordinates in shared memory (6, 12
// or 18), or 0 when the cloud is past the cluster's on-chip capacity and
// the kernel needs the wrapper's scratch.
extern "C" int dispu_fps_chunked_form(int n) {
  const int regs = (chunk_of(n) + kThreads - 1) / kThreads;
  return regs <= 6 ? 6 : regs <= 12 ? 12 : regs <= kMaxRegs ? kMaxRegs : 0;
}

// How many clusters of the form for n the current device can hold at once;
// 0 means the kernel cannot be scheduled there.
extern "C" int dispu_fps_chunked_max_clusters(int n, int* count) {
  if (n < 1 || count == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, nullptr, nullptr, 1, n, 1, 0, count);
}

// scratch: b x n floats, used only when dispu_fps_chunked_form(n) == 0.
extern "C" int dispu_fps_chunked(const float* xyz, int* out, float* scratch,
                                 int b, int n, int npoint, void* stream) {
  if (b < 1 || n < 1 || npoint < 1) return (int)cudaErrorInvalidValue;
  if (dispu_fps_chunked_form(n) == 0 && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch(xyz, out, scratch, b, n, npoint, (cudaStream_t)stream,
                  nullptr);
}
