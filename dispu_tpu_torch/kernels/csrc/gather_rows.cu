// Exact row gather and its transpose, the deterministic row scatter-add.
//
// Replaces gather_rows_pallas and scatter_rows_pallas
// (dispu_tpu/ops/pallas_kernels.py), the pair behind
// gather_rows_pallas_diff.
//
// Gather: out[b, r, :] = table[b, idx[b, r], :].  On the TPU the gather is a
// one-hot contraction on the MXU with the table split into three bf16
// terms, so that the sum reproduces each f32 row exactly.  On this card a
// load is exact, so the gather is a copy, bound by its bytes; what it must
// do is keep enough of them in flight for each index it waits on.  A warp
// takes a group of 32 consecutive output rows, which are contiguous in
// `out`: lane l loads row l's index (one coalesced access), and the lanes
// then walk the group's flattened (row, element) range, each element's
// source row broadcast from its lane with __shfl_sync, so no lane idles
// whatever the width c, every store is coalesced, and each lane issues
// several loads before its stores.  When c % 4 == 0 and both `table` and
// `out` are 16-byte aligned the elements are float4s, else floats (the
// refiner's c = 131).  Indices outside [0, n) give a row of zeros, as the
// one-hot gives there.
//
// Scatter-add: out[b, j, :] = sum over r with idx[b, r] == j of g[b, r, :],
// deterministic and with no float atomics: every sum is taken in ascending
// r from +0.0 with __fadd_rn, so two runs give the same bits, and those of
// a sequential index_add_ (the TPU kernel sums in a fixed tile order on
// the MXU).  It is a stable counting sort of the indices into a CSR
// (rowptr: each row's first slot; perm: the cloud's positions by row,
// ascending within a row) followed by one ordered sum per destination row.
// Indices outside [0, n) are dropped.
//  - The index build, one launch a cloud (build_kernel): one block of W
//    warps, each owning a contiguous slice of the positions, with a count
//    per (warp, row) and the cloud's perm in shared memory.  The counts
//    are taken with shared atomics (a count does not depend on their
//    order), scanned in (row, warp) order into each warp's first slot of
//    each row, and the positions placed by a walk of 32 at a time: a
//    lane's slot is its warp's next slot of its row plus its rank among
//    the lanes of that row, whose mask one ballot a bit of the row gives
//    (__match_any_sync gives the same mask; the build with it in both
//    passes took 1.4 to 1.6x as long).  Slices and ranks ascend with the
//    position, so the placement is stable and does not depend on
//    scheduling.  The slots land anywhere in perm, so it is placed in
//    shared memory and stored in order afterwards (placed straight into
//    device memory, the build took 1.5x as long).  W is the most of 32,
//    16, 8 or 4 warps whose counts and perm fit a block's shared memory
//    (build_warps); a larger cloud takes the multi-pass route: count, scan
//    and place kernels over segments of 1024 positions, with the counts in
//    device memory.
//  - The sum (sum_kernel): LR lanes a destination row, LR the power of
//    two that covers its width, so a warp takes 32 / LR rows of up to 32
//    elements (the backbone's c 24 as six float4s in eight lanes, the
//    refiner's xyz as three floats in four) and a lane A elements of a
//    wider row (c 131: five floats).  The lanes load U source rows' slots
//    of perm, then U source rows, and only then add them in order: U loads
//    in flight, one serial chain of adds.  Elements are float4s when c %
//    4 == 0 and both g and out are 16-byte aligned, else floats.  Every
//    (row, element) is written, rows that no index names as +0.0.
//
// What bounds them on an H100: bytes.  The gather reads its rows and writes
// them once (b*q*c*4 bytes each way); the scatter reads g once (b*q*c*4
// bytes) and writes b*n*c*4, plus the indices and the CSR, which are c
// times smaller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;       // warps a block in the gather and the sum
constexpr int kSeg = 1024;      // positions a segment of the multi-pass route
constexpr int kGroup = 32;      // rows a warp of the gather takes at once
// a block's shared memory on Hopper, and what the index build may take of
// it for its counts (the rest: its static scan scratch)
constexpr int kBlockSmem = 232448;
constexpr int kBuildSmem = kBlockSmem - 256;
constexpr int kMaxN = kBlockSmem / 4;  // the multi-pass route's n a block

// Warps of the one-launch index build for n rows and q positions: the
// most of 32, 16, 8 and 4 whose counts (one int a warp and row) and the
// cloud's perm (q ints) fit kBuildSmem; 0 where none does and the
// multi-pass route takes the cloud.  kernels/gather_rows.py: build_warps
// is the same formula.
int build_warps(int n, int q) {
  for (int w = 32; w >= 4; w >>= 1)
    if (4LL * ((long long)w * n + q) <= kBuildSmem) return w;
  return 0;
}

// V: float4 or float; cv: elements of V a row; U: loads a lane has in
// flight before its stores.  Lane l's u-th element of a pass is e = e0 +
// l + 32u of the group's flattened range: row r = e / cv, column e % cv,
// divided once and then stepped by 32U elements a pass with no division.
template <typename V, int U>
__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
              V* __restrict__ out, long long rows, int n, int q, int cv) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroup;
  if (row0 >= rows) return;
  const int nrows = (int)min((long long)kGroup, rows - row0);
  // lane l: the offset of row l's source row in `table`, -1 for zeros
  long long src = -1;
  if (lane < nrows) {
    const long long row = row0 + lane;
    const int j = idx[row];
    if (j >= 0 && j < n) src = (row / q * n + j) * cv;
  }
  const int total = nrows * cv;
  const int step_r = 32 * U / cv, step_c = 32 * U % cv;
  int r[U], col[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    r[u] = (lane + 32 * u) / cv;
    col[u] = lane + 32 * u - r[u] * cv;
  }
  V* dst = out + row0 * cv;
  for (int e0 = 0; e0 < total; e0 += 32 * U) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long s = __shfl_sync(0xffffffffu, src, r[u] & 31);
      v[u] = V{};
      if (e0 + lane + 32 * u < total && s >= 0) v[u] = table[s + col[u]];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + lane + 32 * u;
      if (e < total) dst[e] = v[u];
      r[u] += step_r;
      col[u] += step_c;
      if (col[u] >= cv) {
        col[u] -= cv;
        ++r[u];
      }
    }
  }
}

template <typename V, int U>
int launch_gather(const float* table, const int* idx, float* out,
                  long long rows, int n, int q, int cv, cudaStream_t stream) {
  const long long warps = (rows + kGroup - 1) / kGroup;
  gather_kernel<V, U><<<(unsigned)((warps + kWarps - 1) / kWarps),
                        kWarps * 32, 0, stream>>>(
      reinterpret_cast<const V*>(table), idx, reinterpret_cast<V*>(out), rows,
      n, q, cv);
  return (int)cudaGetLastError();
}

// counts[(cloud * nseg + seg) * n + j]: positions of the segment at row j
__global__ void __launch_bounds__(kSeg)
count_kernel(const int* __restrict__ idx, int* __restrict__ counts, int n,
             int q, int nseg) {
  extern __shared__ int s_count[];
  const int seg = blockIdx.x, cloud = blockIdx.y;
  for (int j = threadIdx.x; j < n; j += kSeg) s_count[j] = 0;
  __syncthreads();
  const int pos = seg * kSeg + threadIdx.x;
  if (pos < q) {
    const int j = idx[(long long)cloud * q + pos];
    if (j >= 0 && j < n) atomicAdd(&s_count[j], 1);
  }
  __syncthreads();
  int* out = counts + ((long long)cloud * nseg + seg) * n;
  for (int j = threadIdx.x; j < n; j += kSeg) out[j] = s_count[j];
}

// In place: counts become each (row, segment) run's start in the cloud's
// inverse index, taken in (row, segment) order; rowptr[cloud * (n + 1) + j]
// is row j's first slot and rowptr[... + n] the cloud's total.
__global__ void __launch_bounds__(kSeg)
scan_kernel(int* __restrict__ counts, int* __restrict__ rowptr, int n,
            int nseg) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cloud = blockIdx.x;
  int* cnt = counts + cloud * nseg * n;
  int* ptr = rowptr + cloud * (n + 1);
  const long long total = (long long)n * nseg;
  int carry = 0;
  for (long long base = 0; base < total; base += kSeg) {
    const long long e = base + threadIdx.x;  // e = row * nseg + segment
    const int j = (int)(e / nseg), seg = (int)(e % nseg);
    const int v = e < total ? cnt[(long long)seg * n + j] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += t;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int start = carry + incl - v + (warp > 0 ? s_warp[warp - 1] : 0);
    if (e < total) {
      cnt[(long long)seg * n + j] = start;
      if (seg == 0) ptr[j] = start;
    }
    carry += s_warp[31];
    __syncthreads();  // s_warp is rewritten by the next chunk
  }
  if (threadIdx.x == 0) ptr[n] = carry;
}

// perm[cloud * q + slot]: the positions of the cloud, by row, ascending
__global__ void __launch_bounds__(kSeg)
place_kernel(const int* __restrict__ idx, const int* __restrict__ starts,
             int* __restrict__ perm, int n, int q, int nseg) {
  extern __shared__ int s_next[];
  const int seg = blockIdx.x, cloud = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* st = starts + ((long long)cloud * nseg + seg) * n;
  for (int j = threadIdx.x; j < n; j += kSeg) s_next[j] = st[j];
  const int pos = seg * kSeg + threadIdx.x;
  int j = -1;
  if (pos < q) {
    j = idx[(long long)cloud * q + pos];
    if (j < 0 || j >= n) j = -1;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, j);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();
  for (int w = 0; w < kSeg / 32; ++w) {  // the warps in position order
    if (warp == w && j >= 0) {
      perm[(long long)cloud * q + s_next[j] + rank] = pos;
      __syncwarp(peers);
      if (rank == 0) s_next[j] += __popc(peers);
    }
    __syncthreads();
  }
}

// The row at position pos of a cloud's indices, -1 past end or outside
// [0, n).
__device__ __forceinline__ int row_at(const int* __restrict__ ix, int pos,
                                      int end, int n) {
  const int j = pos < end ? ix[pos] : -1;
  return (unsigned)j < (unsigned)n ? j : -1;
}

// The lanes of the warp whose row is j (for j >= 0), from one ballot a bit
// of the rows' nbits bits: what __match_any_sync gives, which the card
// runs one warp at a time on an SM.
__device__ __forceinline__ unsigned peers_of(int j, int nbits) {
  unsigned m = __ballot_sync(kFull, j >= 0);
  for (int bit = 0; bit < nbits; ++bit) {
    const bool set = (j >> bit) & 1;
    const unsigned ones = __ballot_sync(kFull, set);
    m &= set ? ones : ~ones;
  }
  return m;
}

// One block a cloud, W = blockDim.x / 32 warps (build_warps(n, q));
// dynamic shared memory: W * n + q ints.
__global__ void __launch_bounds__(1024)
build_kernel(const int* __restrict__ idx, int* __restrict__ rowptr,
             int* __restrict__ perm, int n, int q) {
  extern __shared__ int s_next[];  // [warp][row]: counts, then next slots
  __shared__ int s_warp[32];
  int* s_perm = s_next + (blockDim.x >> 5) * n;  // the cloud's perm
  constexpr int kBatch = 4;  // index loads a lane has in flight
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cloud = blockIdx.x;
  const int* ix = idx + cloud * q;
  int* ptr = rowptr + cloud * (n + 1);
  int* pm = perm + cloud * q;
  for (int e = tid; e < nw * n; e += blockDim.x) s_next[e] = 0;
  __syncthreads();
  // warp w owns positions [p0, p1), slices ascending with w
  const int slice = ((q + nw - 1) / nw + 31) & ~31;
  const int p0 = min(q, warp * slice), p1 = min(q, p0 + slice);
  int* mine = s_next + warp * n;
  // counts do not depend on the order they are taken in: atomics
  for (int base = p0; base < p1; base += 32 * kBatch) {
    int j[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      j[u] = row_at(ix, base + 32 * u + lane, p1, n);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j[u] >= 0) atomicAdd(&mine[j[u]], 1);
  }
  __syncthreads();
  // scan in (row, warp) order: s_next[w][j] becomes warp w's first slot of
  // row j, rowptr[j] row j's first slot
  int carry = 0;
  for (int j0 = 0; j0 < n; j0 += blockDim.x) {
    const int j = j0 + tid;
    int total = 0;
    if (j < n) {
      for (int w = 0; w < nw; ++w) {
        const int c = s_next[w * n + j];
        s_next[w * n + j] = total;
        total += c;
      }
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < nw ? s_warp[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += t;
      }
      s_warp[lane] = v;
    }
    __syncthreads();
    const int start = carry + incl - total + (warp > 0 ? s_warp[warp - 1] : 0);
    if (j < n) {
      ptr[j] = start;
      for (int w = 0; w < nw; ++w) s_next[w * n + j] += start;
    }
    carry += s_warp[nw - 1];
    __syncthreads();  // s_warp is rewritten by the next chunk
  }
  if (tid == 0) ptr[n] = carry;
  // place: the same walk, each lane at its warp's next slot of its row
  // plus its rank among the lanes of that row
  const int nbits = 32 - __clz(max(n - 1, 1));
  for (int base = p0; base < p1; base += 32 * kBatch) {
    int j[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      j[u] = row_at(ix, base + 32 * u + lane, p1, n);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned peers = peers_of(j[u], nbits);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (j[u] >= 0) s_perm[mine[j[u]] + rank] = base + 32 * u + lane;
      __syncwarp();
      if (j[u] >= 0 && rank == 0) mine[j[u]] += __popc(peers);
      __syncwarp();
    }
  }
  // the slots land anywhere in the cloud's perm: placed in shared memory,
  // then stored in order, coalesced
  __syncthreads();
  for (int e = tid; e < carry; e += blockDim.x) pm[e] = s_perm[e];
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// V: float4 or float; cv: elements of V a row; LR lanes a destination row
// (32 / LR rows a warp), A elements of V a lane, U source rows in flight.
template <typename V, int LR, int A, int U>
__global__ void __launch_bounds__(kWarps * 32)
sum_kernel(const V* __restrict__ g, const int* __restrict__ perm,
           const int* __restrict__ rowptr, V* __restrict__ out,
           long long rows, int n, int q, int cv) {
  const int lane = threadIdx.x & 31, gl = lane % LR;
  const long long row =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / LR) +
      lane / LR;
  long long cloud = 0;
  int lo = 0, len = 0;
  if (row < rows) {
    cloud = row / n;
    const int* ptr = rowptr + cloud * (n + 1) + row % n;
    lo = ptr[0];
    len = ptr[1] - lo;
  }
  const int* pr = perm + cloud * q + lo;
  const V* gc = g + cloud * q * cv;
  const int most = __reduce_max_sync(kFull, len);
  for (int c0 = 0; c0 < cv; c0 += LR * A) {
    V acc[A];
#pragma unroll
    for (int a = 0; a < A; ++a) acc[a] = V{};
    for (int s = 0; s < most; s += U) {
      int src[U];
#pragma unroll
      for (int u = 0; u < U; ++u) src[u] = s + u < len ? pr[s + u] : -1;
      V v[U][A];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const int t = c0 + gl + LR * a;
          v[u][a] = V{};
          if (src[u] >= 0 && t < cv) v[u][a] = gc[(long long)src[u] * cv + t];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (src[u] < 0) continue;  // ascending u: the sum's order
#pragma unroll
        for (int a = 0; a < A; ++a) acc[a] = add_rn(acc[a], v[u][a]);
      }
    }
    if (row < rows) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int t = c0 + gl + LR * a;
        if (t < cv) out[row * cv + t] = acc[a];
      }
    }
  }
}

// The sum's arguments: cv elements of V a row, rows = b * n.
struct SumArgs {
  const float* g;
  const int* perm;
  const int* rowptr;
  float* out;
  long long rows;
  int n, q, cv;
  cudaStream_t stream;
};

template <typename V, int LR, int A>
int launch_sum(const SumArgs& a) {
  // 16 to 64 registers of loads in flight a lane, at least two rows
  constexpr int kWidth = A * (int)(sizeof(V) / sizeof(float));
  constexpr int U = kWidth <= 4 ? 16 : kWidth <= 8 ? 8 : kWidth <= 16 ? 4 : 2;
  const long long per_block = (long long)kWarps * (32 / LR);
  sum_kernel<V, LR, A, U>
      <<<(unsigned)((a.rows + per_block - 1) / per_block), kWarps * 32, 0,
         a.stream>>>(reinterpret_cast<const V*>(a.g), a.perm, a.rowptr,
                     reinterpret_cast<V*>(a.out), a.rows, a.n, a.q, a.cv);
  return (int)cudaGetLastError();
}

// the lanes a row and elements a lane for rows of cv elements of V
template <typename V>
int sum_rows(const SumArgs& a) {
  if (a.cv <= 1) return launch_sum<V, 1, 1>(a);
  if (a.cv <= 2) return launch_sum<V, 2, 1>(a);
  if (a.cv <= 4) return launch_sum<V, 4, 1>(a);
  if (a.cv <= 8) return launch_sum<V, 8, 1>(a);
  if (a.cv <= 16) return launch_sum<V, 16, 1>(a);
  if (a.cv <= 32) return launch_sum<V, 32, 1>(a);
  if (a.cv <= 64) return launch_sum<V, 32, 2>(a);
  if (a.cv <= 128) return launch_sum<V, 32, 4>(a);
  if (a.cv <= 160) return launch_sum<V, 32, 5>(a);
  return launch_sum<V, 32, 8>(a);
}

// The shared-memory limits of the scatter's kernels, set once a device
// (at their largest, so that no call sets them again).
cudaError_t set_scatter_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(build_kernel, attr, kBuildSmem)) ||
      (err = cudaFuncSetAttribute(count_kernel, attr, kBlockSmem)) ||
      (err = cudaFuncSetAttribute(place_kernel, attr, kBlockSmem)))
    return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

extern "C" int dispu_gather_rows(const float* table, const int* idx,
                                 float* out, int b, int n, int q, int c,
                                 void* stream) {
  if (b < 1 || n < 1 || q < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * q;
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_gather<float4, 4>(table, idx, out, rows, n, q, c / 4, s);
  return launch_gather<float, 8>(table, idx, out, rows, n, q, c, s);
}

// Warps of the one-launch index build for n rows and q positions, 0 for
// the multi-pass route (build_warps).
extern "C" int dispu_scatter_build_warps(int n, int q) {
  return build_warps(n, q);
}

// scratch, ints: rowptr b * (n + 1), then perm b * q, then for the
// multi-pass route (build_warps(n, q) == 0) the counts b * ceil(q / 1024)
// * n.  n <= 58,112: a row table of the multi-pass route fits a block.
extern "C" int dispu_scatter_rows(const float* g, const int* idx, float* out,
                                  int* scratch, int b, int n, int q, int c,
                                  void* stream) {
  if (b < 1 || n < 1 || q < 1 || c < 1 || n > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_scatter_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int* rowptr = scratch;
  int* perm = scratch + (size_t)b * (n + 1);
  const int warps = build_warps(n, q);
  if (warps > 0) {
    build_kernel<<<b, 32 * warps, ((size_t)warps * n + q) * sizeof(int), s>>>(
        idx, rowptr, perm, n, q);
  } else {
    int* counts = perm + (size_t)b * q;
    const int nseg = (q + kSeg - 1) / kSeg;
    const dim3 segs(nseg, b);
    const size_t smem = (size_t)n * sizeof(int);
    count_kernel<<<segs, kSeg, smem, s>>>(idx, counts, n, q, nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_kernel<<<b, kSeg, 0, s>>>(counts, rowptr, n, nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    place_kernel<<<segs, kSeg, smem, s>>>(idx, counts, perm, n, q, nseg);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  SumArgs a{g, perm, rowptr, out, (long long)b * n, n, q, c, s};
  if (c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    a.cv = c / 4;
    return sum_rows<float4>(a);
  }
  return sum_rows<float>(a);
}
