// The round of exact farthest-point sampling on Hopper, shared by fps.cu
// (clouds of up to 32,768 points) and fps_chunked.cu (larger clouds).
//
// Semantics (fps_pallas, fps_pallas_chunked and fps_pallas_chunked_batch,
// dispu_tpu/ops/pallas_kernels.py): the first sample is index 0; every
// running min-distance starts at 1e38; each round takes the
// first-occurrence argmax of the updated min-distances; the distance is
// (x-px)^2 + (y-py)^2 + (z-pz)^2 in that order, with round-to-nearest
// intrinsics so nvcc cannot contract it into FMAs (an FMA changes the bits
// of the distances and so the order of near-ties).  Only indices < n are
// ever candidates.  When npoint exceeds the distinct points, every
// min-distance reaches 0 and each later round takes index 0.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  The argmax
// chain is serial (round j needs round j-1's winner): the 4x merge of a
// 2048-point cloud (24,576 points -> 8,192 samples) is 8,191 dependent
// rounds, the 16x merge (98,304 -> 32,768) 32,767.  A round is a pass over
// the points, a reduction of (value, index) over every thread, and a
// barrier; its length is what counts.  Design:
//  - A cloud goes to a cluster of CL CTAs (a form, chosen by n by the
//    caller); CTA r owns points [r*chunk, (r+1)*chunk), chunk =
//    ceil(n/CL), and thread t of it the points t + k*T.  Where they live
//    is the form's Storage: coordinates and min-distances in registers
//    (P a thread), with a copy of the chunk's coordinates in shared memory
//    that gives a warp's winner its coordinates; or coordinates in shared
//    memory and min-distances in registers, for chunks past the
//    registers; or, past the cluster's shared memory, coordinates read
//    from the input and min-distances in a caller's scratch in device
//    memory.  The round is the same for all three.
//  - One reduction instruction a level.  Min-distances are >= 0, so their
//    f32 bits order as unsigned integers; key = bits + 1 (0: no point).
//    A warp takes redux.sync max over the keys, then redux.sync min over
//    the indices of the lanes that tie it: the (value descending, index
//    ascending) winner, which is the first-occurrence argmax.
//  - One barrier a round.  The lane that wins its warp pushes its
//    candidate (key, index, coordinates) into the slot of its warp in
//    every CTA of the cluster, double-buffered by round parity; after one
//    block (CL == 1) or cluster barrier every warp reduces all the slots
//    from its own CTA's copy the same way, so every warp holds the winner
//    and its coordinates: no second barrier, no broadcast, and no round
//    starts on a remote load.  (Pulling the slots instead, every warp
//    reading every other CTA's, was slower and grew with the cluster: its
//    remote reads scale with warps x CTAs.)
//    A warp may write round j+1's slots while another still reads round
//    j's: they are the other parity, and round j+2's writes wait behind
//    round j+1's barrier, which the reader must have reached.  Every warp
//    writes its slot in every round (key 0 where it has no point), so no
//    slot holds a value from two rounds before.

#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace fps_round {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

// where a form keeps its points
enum Storage : int {
  kRegisters = 0,  // coordinates and min-distances in registers
  kShared = 1,     // coordinates in shared memory, min-distances in registers
  kDevice = 2,     // coordinates from the input, min-distances in scratch
};

__device__ __forceinline__ float sq_dist(float x, float y, float z, float px,
                                         float py, float pz) {
  const float dx = __fsub_rn(x, px);
  const float dy = __fsub_rn(y, py);
  const float dz = __fsub_rn(z, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The candidates of one round: each warp's, pushed by the warp into
// every CTA of the cluster.  key: (bits(v) + 1) << 32 | (0xFFFFFFFF - i),
// whose maximum is the (value descending, index ascending) winner; 0: no
// point.  xyz: the candidate's coordinates.
template <int S>
struct Slots {
  unsigned long long key[2][S];
  float4 xyz[2][S];
};

// CL CTAs a cloud (1: a plain block), T threads a CTA, P points a thread
// (kRegisters, kShared; kDevice takes any chunk).  scratch: b x n floats
// for kDevice, else unused.
template <int CL, int T, int P, int M>
__global__ void __launch_bounds__(T, 1)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out,
           float* __restrict__ scratch, int n, int npoint) {
  constexpr int W = T / 32;      // warps a CTA
  constexpr int S = CL * W;      // candidates a round
  constexpr int SL = (S + 31) / 32;  // of them a lane reads
  constexpr int PR = M == kRegisters ? P : 1;  // coordinates in registers
  constexpr int PM = M == kDevice ? 1 : P;     // min-distances in registers
  extern __shared__ float s_pts[];  // x, y, z planes of the chunk
  __shared__ Slots<S> s_slot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rank = 0;
  if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
  const long long cloud = blockIdx.x / CL;
  const int chunk = (n + CL - 1) / CL;
  const int base = rank * chunk;
  const int cnt = max(0, min(n - base, chunk));
  const float* pts = xyz + cloud * n * 3;
  int* o = out + cloud * npoint;
  float* s_x = s_pts;
  float* s_y = s_pts + chunk;
  float* s_z = s_pts + 2 * chunk;
  float* mdg = M == kDevice ? scratch + cloud * n + base : nullptr;

  float x[PR], y[PR], z[PR], md[PM];
  if constexpr (M == kDevice) {
    for (int l = tid; l < cnt; l += T) mdg[l] = 1e38f;
  } else {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int l = tid + r * T;
      if constexpr (M == kRegisters) x[r] = y[r] = z[r] = 0.f;
      md[r] = 1e38f;
      if (l < cnt) {
        const float* p = pts + 3LL * (base + l);
        const float qx = p[0], qy = p[1], qz = p[2];
        if constexpr (M == kRegisters) {
          x[r] = qx;
          y[r] = qy;
          z[r] = qz;
        }
        s_x[l] = qx;
        s_y[l] = qy;
        s_z[l] = qz;
      }
    }
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  float px = pts[0], py = pts[1], pz = pts[2];
  // a thread reads back only its own points: no block barrier; but every
  // CTA of the cluster must have started before the first round writes
  // into its shared memory
  if constexpr (CL > 1) cg::this_cluster().sync();
  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    unsigned key = 0;
    int bl = -1;
    float bx = 0.f, by = 0.f, bz = 0.f;  // kDevice: the lane's best point
    if constexpr (M == kDevice) {
      for (int l = tid; l < cnt; l += T) {
        const float* p = pts + 3LL * (base + l);
        const float qx = p[0], qy = p[1], qz = p[2];
        const float v = fminf(mdg[l], sq_dist(qx, qy, qz, px, py, pz));
        mdg[l] = v;
        const unsigned k = __float_as_uint(v) + 1u;
        if (k > key) {  // ascending l: keeps the first
          key = k;
          bl = l;
          bx = qx;
          by = qy;
          bz = qz;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int l = tid + r * T;
        if (l < cnt) {
          float v;
          if constexpr (M == kRegisters)
            v = fminf(md[r], sq_dist(x[r], y[r], z[r], px, py, pz));
          else
            v = fminf(md[r], sq_dist(s_x[l], s_y[l], s_z[l], px, py, pz));
          md[r] = v;
          const unsigned k = __float_as_uint(v) + 1u;
          if (k > key) { key = k; bl = l; }  // ascending l: keeps the first
        }
      }
    }
    // the warp's winner: the largest key, then the least index among the
    // lanes that hold it
    const unsigned idx = bl >= 0 ? (unsigned)(base + bl) : UINT_MAX;
    const unsigned wkey = __reduce_max_sync(kFull, key);
    const unsigned widx =
        __reduce_min_sync(kFull, key == wkey ? idx : UINT_MAX);
    if (key == wkey && idx == widx && (wkey != 0 || lane == 0)) {
      const int slot = rank * W + warp;
      const unsigned long long k64 =
          (unsigned long long)wkey << 32 | (0xFFFFFFFFu - widx);
      float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (M == kDevice) {
        c = make_float4(bx, by, bz, 0.f);
      } else {
        if (bl >= 0) c = make_float4(s_x[bl], s_y[bl], s_z[bl], 0.f);
      }
      if constexpr (CL > 1) {
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int q = 0; q < CL; ++q) {
          *cluster.map_shared_rank(&s_slot.key[par][slot], q) = k64;
          *cluster.map_shared_rank(&s_slot.xyz[par][slot], q) = c;
        }
      } else {
        s_slot.key[par][slot] = k64;
        s_slot.xyz[par][slot] = c;
      }
    }
    // the one barrier of the round: it releases the pushed candidates
    if constexpr (CL > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    // every warp reduces all S candidates from its own CTA's copy
    unsigned long long best = 0;
    int bs = 0;
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      const int sl = lane + 32 * i;
      if (sl < S) {
        const unsigned long long k64 = s_slot.key[par][sl];
        if (k64 > best) { best = k64; bs = sl; }
      }
    }
    const unsigned hi = (unsigned)(best >> 32), lo = (unsigned)best;
    const unsigned h = __reduce_max_sync(kFull, hi);
    const unsigned lmax = __reduce_max_sync(kFull, hi == h ? lo : 0u);
    const int win = __ffs(__ballot_sync(kFull, hi == h && lo == lmax)) - 1;
    const float4 c = s_slot.xyz[par][__shfl_sync(kFull, bs, win)];
    px = c.x;
    py = c.y;
    pz = c.z;
    if (rank == 0 && tid == 0) o[j] = (int)(0xFFFFFFFFu - lmax);
  }
  // no CTA leaves while another may still write into its slots
  if constexpr (CL > 1) cg::this_cluster().sync();
}

// Set the form's attributes on the current device, once a device: its
// dynamic shared memory at the form's capacity and, for clusters past 8
// CTAs (non-portable), the attribute that allows them.
template <int CL, int T, int P, int M>
cudaError_t set_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  const auto kernel = fps_kernel<CL, T, P, M>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      M == kDevice ? 0 : (int)(3 * sizeof(float) * T * P));
  if (err != cudaSuccess) return err;
  if constexpr (CL > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// Launch the form on b clouds of n points (the caller has checked that
// the chunk fits the form), or, with max_clusters != nullptr, write how
// many of its clusters the current device holds at once
// (cudaOccupancyMaxActiveClusters) and launch nothing.
template <int CL, int T, int P, int M>
int run(const float* xyz, int* out, float* scratch, int b, int n, int npoint,
        cudaStream_t stream, int* max_clusters) {
  const auto kernel = fps_kernel<CL, T, P, M>;
  const int chunk = (n + CL - 1) / CL;
  const size_t smem = M == kDevice ? 0 : 3 * sizeof(float) * (size_t)chunk;
  cudaError_t err = set_attributes<CL, T, P, M>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * CL);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               (const void*)kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, out, scratch, n, npoint);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A form: a cluster of CL CTAs of T threads, P points a thread where M
// says (P = 0 for kDevice, which holds any n).
template <int CL, int T, int P, int M>
struct Form {
  static constexpr long long kCapacity = (long long)CL * T * P;
};

// Launch the form on b clouds of n points, or, with max_clusters set,
// write how many of its clusters the current device holds at once.
struct Launch {
  const float* xyz;
  int* out;
  float* scratch;
  int b, n, npoint;
  cudaStream_t stream;
  int* max_clusters;

  template <int CL, int T, int P, int M>
  int operator()(Form<CL, T, P, M>) const {
    if (M == kDevice && max_clusters == nullptr && scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    return run<CL, T, P, M>(xyz, out, scratch, b, n, npoint, stream,
                            max_clusters);
  }
};

// Write the form's shape: cluster, threads, points, storage.
struct Describe {
  int* shape;

  template <int CL, int T, int P, int M>
  int operator()(Form<CL, T, P, M>) const {
    shape[0] = CL;
    shape[1] = T;
    shape[2] = P;
    shape[3] = M;
    return 0;
  }
};

// op on the first of the forms F, Rest... that holds n; the last one is
// the device form, which holds any n.
template <class F, class... Rest, class Op>
int first_holding(int n, const Op& op) {
  if constexpr (sizeof...(Rest) == 0) {
    return op(F{});
  } else {
    if (n <= F::kCapacity) return op(F{});
    return first_holding<Rest...>(n, op);
  }
}

}  // namespace fps_round
