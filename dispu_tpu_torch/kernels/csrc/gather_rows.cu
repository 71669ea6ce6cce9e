// Exact row gather and its transpose, the deterministic row scatter-add.
//
// Replaces gather_rows_pallas and scatter_rows_pallas
// (dispu_tpu/ops/pallas_kernels.py), the pair behind
// gather_rows_pallas_diff.
//
// Gather: out[b, r, :] = table[b, idx[b, r], :].  On the TPU the gather is a
// one-hot contraction on the MXU with the table split into three bf16
// terms, so that the sum reproduces each f32 row exactly.  On this card a
// load is exact: one warp per output row, consecutive lanes on consecutive
// floats of the row (coalesced loads and stores).  Indices outside [0, n)
// give a row of zeros, as the one-hot gives there.
//
// Scatter-add: out[b, j, :] = sum over r with idx[b, r] == j of g[b, r, :],
// deterministic and with no float atomics: every sum is taken in ascending
// r, so two runs give the same bits (the TPU kernel sums in a fixed tile
// order on the MXU).  It is the counting sort of the indices followed by
// one ordered sum per destination row:
//   1. count: per cloud and segment of 1024 positions, how many positions
//      point at each row (integer shared-memory atomics: counts do not
//      depend on their order);
//   2. scan: per cloud, the exclusive prefix of the counts in (row,
//      segment) order: where each (row, segment) run starts in the cloud's
//      inverse index, and each row's span;
//   3. place: per cloud and segment, each position written to its row's
//      next slot in ascending order; inside a segment the 32 warps take
//      their turns, and a warp ranks equal rows with __match_any_sync, so
//      the placement does not depend on scheduling;
//   4. sum: one warp per destination row adds its span's rows of g in
//      order, lanes over the channels.
// Indices outside [0, n) are dropped.
//
// What bounds them on an H100: bytes.  The gather reads its rows and writes
// them once (b*q*c*4 bytes each way); the scatter reads g once (b*q*c*4
// bytes) and writes b*n*c*4, plus 4 int passes over the indices, which are
// c times smaller.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps a block in the gather and the sum
constexpr int kSeg = 1024;      // positions a segment; threads a block
constexpr int kChan = 8;        // channels a lane holds in the sum

__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ idx,
                              float* __restrict__ out, int b, int n, int q,
                              int c) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)b * q) return;
  const long long cloud = row / q;
  const int j = idx[row];
  const bool ok = j >= 0 && j < n;
  const float* src = table + (cloud * n + (ok ? j : 0)) * c;
  float* dst = out + row * c;
  for (int t = lane; t < c; t += 32) dst[t] = ok ? src[t] : 0.f;
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

__global__ void sum_kernel(const float* __restrict__ g,
                           const int* __restrict__ perm,
                           const int* __restrict__ rowptr,
                           float* __restrict__ out, int b, int n, int q,
                           int c) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)b * n) return;
  const long long cloud = row / n;
  const int j = (int)(row % n);
  const int* ptr = rowptr + cloud * (n + 1);
  const int lo = ptr[j], hi = ptr[j + 1];
  const int* pr = perm + cloud * q;
  const float* gc = g + cloud * q * c;
  float* dst = out + row * c;
  for (int c0 = 0; c0 < c; c0 += 32 * kChan) {
    float acc[kChan];
#pragma unroll
    for (int u = 0; u < kChan; ++u) acc[u] = 0.f;
    for (int s = lo; s < hi; ++s) {
      const float* src = gc + (long long)pr[s] * c;
#pragma unroll
      for (int u = 0; u < kChan; ++u) {
        const int t = c0 + lane + 32 * u;
        if (t < c) acc[u] = __fadd_rn(acc[u], src[t]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChan; ++u) {
      const int t = c0 + lane + 32 * u;
      if (t < c) dst[t] = acc[u];
    }
  }
}

}  // namespace

extern "C" int dispu_gather_rows(const float* table, const int* idx,
                                 float* out, int b, int n, int q, int c,
                                 void* stream) {
  if (b < 1 || n < 1 || q < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * q;
  gather_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kWarps * 32, 0,
                  (cudaStream_t)stream>>>(table, idx, out, b, n, q, c);
  return (int)cudaGetLastError();
}

// counts: b * ceil(q / 1024) * n ints, rowptr: b * (n + 1) ints, perm:
// b * q ints, all scratch; n ints of a row table must fit shared memory.
extern "C" int dispu_scatter_rows(const float* g, const int* idx, float* out,
                                  int* counts, int* rowptr, int* perm, int b,
                                  int n, int q, int c, void* stream) {
  if (b < 1 || n < 1 || q < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int nseg = (q + kSeg - 1) / kSeg;
  const dim3 segs(nseg, b);
  count_kernel<<<segs, kSeg, smem, s>>>(idx, counts, n, q, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_kernel<<<b, kSeg, 0, s>>>(counts, rowptr, n, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  place_kernel<<<segs, kSeg, smem, s>>>(idx, counts, perm, n, q, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)b * n;
  sum_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kWarps * 32, 0, s>>>(
      g, perm, rowptr, out, b, n, q, c);
  return (int)cudaGetLastError();
}
