// Exact k-nearest-neighbour selection by squared euclidean distance, and
// its packed-key (turbo) variant.
//
// Replaces knn_pallas (dispu_tpu/ops/pallas_kernels.py, forward only), its
// exact variants and variant="packed".  For each query row it forms
// max(q2 - 2 q.p + p2, 0) + bias[j] over every dataset point j (the
// distance row of knn_common.cuh, shared with knn_group.cu).
//
// Exact (knn_stream_kernel for k <= 32, knn_kernel beyond, knn_split_*
// beyond where a row does not fit shared memory): the k smallest in
// lexicographic (distance, index) order, ascending: equal distances go to
// the lower index, as lax.top_k and the Pallas lane order do.  A bias of
// 1e30 pushes padding and duplicate columns last.
//
// Packed (knn_packed_stream_kernel for k <= 32, knn_packed_kernel beyond):
// each entry's key is one int, the distance's bits with the low lb bits
// replaced by the column index (lb = bit_length(n_pad - 1), n_pad = n
// rounded up to 128 as knn_pallas pads).  Distances are >= +0, so the int
// order is the float order; the keys are distinct, so the k smallest keys
// ascending are the selection.  Returns idx = key & lmask and dist = the
// key's high bits as a float: distances truncated, and ties within the
// truncation resolved by index.  The distance code is the exact kernel's,
// so the two differ only in selection.
//
// What bounds it on an H100.  Exact, k <= 32 (every kNN of the serving and
// training paths but the patch cut): the f32 FMAs of the distances, b m n
// (2 c + 4) operations (0.05 ms at f32's 67 TFLOP/s at pass 2's c = 48
// shape), and the selection's compares and insertions.  The row form
// below, run at these shapes, gives each query one warp that reads the
// whole cloud again with lanes c floats apart (32 sectors for 128 useful
// bytes at c = 48) and makes k passes over the row: 7.8 ms, 160x the
// bound, at pass 2's c = 48 shape on an H100 80GB HBM3 at 700 W.  Design:
// knn_common.cuh's tiled form (stream_topk): a block of 4 warps takes 32
// queries of one cloud and streams the cloud through shared memory in
// coalesced tiles of 128 points, each lane a register tile of 8 queries x
// 4 points, and each query's k best stay sorted in its warp's registers,
// so the row never goes to shared memory and n is not limited.  The packed
// selection at k <= 32 (pass 2's refiner of a 16x turbo request, 32 x
// 4096 queries over 4096 points, k 16) is the same stream over its int
// keys (knn_common.cuh's PackedOrder), formed where the tile's distance
// is; the row form took 6.3 ms there, one warp a query making k strided
// passes over 4,096 keys in shared memory.  Exact, k > 32 (the patch cut,
// k = 256 over 2,048 points, 24 queries), and packed past k = 32 (no
// caller; the JAX gate admits k <= 128): the row form, one warp per query
// row, its n distances in shared memory, k rounds (a strided pass, a
// butterfly, and in the exact form a knock-out); a row must fit one
// block's shared memory, n + c <= 58,112.  Past that n (the patch cut of a
// cloud of more than 58,109 points) the exact selection splits the row:
// knn_split_select runs the row form over chunks of L points of each row
// (one warp a (row, chunk)) and writes each chunk's k best (d, j) to
// device scratch, chunk after chunk; knn_split_merge runs the row form
// over those k * chunks candidates.  A chunk's k best are sorted by (d, j)
// and a later chunk's indices are larger, so the candidates' position
// order is their index order among equal distances, and the selection is
// the row form's, bit for bit: the lexicographic k smallest are unique.
// Its cost is the row form's, b m n k / 32 strided steps a lane, plus the
// merge's b m (k * chunks) k / 32; n is limited by the merge's row, k *
// chunks <= 58,112 floats.

#include "knn_common.cuh"

namespace {

using namespace knn_common;

// k > kStreamK: the row form.
__global__ void knn_kernel(const float* __restrict__ points,
                           const float* __restrict__ queries,
                           const float* __restrict__ bias,
                           float* __restrict__ dists, int* __restrict__ idx,
                           int b, int n, int m, int c, int k, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= (long long)b * m) return;  // warps never meet at a block barrier
  float* d = smem + (size_t)warp * (n + c);
  const long long cloud = row / m;
  row_distances(queries + row * c, points + cloud * n * c, bias + cloud * n,
                d, d + n, n, c, lane);

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  for (int r = 0; r < k; ++r) {
    float bv;
    int bj;
    select_min(d, n, lane, bv, bj);
    if (lane == 0) {
      drow[r] = bv;
      irow[r] = bj;
    }
    knock_out(d, n, lane, bj);
  }
}

// Past the row form's n, stage 1: one warp per (row, chunk of L points)
// writes the chunk's k best (d, j), ascending, to cand_d / cand_j at
// (row * chunks + chunk) * k; past the chunk's finite distances (+inf,
// INT_MAX).
__global__ void knn_split_select(const float* __restrict__ points,
                                 const float* __restrict__ queries,
                                 const float* __restrict__ bias,
                                 float* __restrict__ cand_d,
                                 int* __restrict__ cand_j, int b, int n,
                                 int m, int c, int k, int L, int chunks,
                                 int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * warps + warp;
  if (task >= (long long)b * m * chunks) return;
  const long long row = task / chunks;
  const int j0 = (int)(task - row * chunks) * L;
  const int len = min(L, n - j0);
  float* d = smem + (size_t)warp * (L + c);
  const long long cloud = row / m;
  row_distances(queries + row * c, points + ((size_t)cloud * n + j0) * c,
                bias + (size_t)cloud * n + j0, d, d + L, len, c, lane);
  float* dout = cand_d + task * k;
  int* jout = cand_j + task * k;
  for (int r = 0; r < k; ++r) {
    float bv;
    int bj;
    select_min(d, len, lane, bv, bj);
    if (lane == 0) {
      dout[r] = bv;
      jout[r] = bj < len ? j0 + bj : INT_MAX;
    }
    knock_out(d, len, lane, bj);
  }
}

// Stage 2: one warp per row takes the k smallest of its k * chunks
// candidates by (d, position), which is (d, j).
__global__ void knn_split_merge(const float* __restrict__ cand_d,
                                const int* __restrict__ cand_j,
                                float* __restrict__ dists,
                                int* __restrict__ idx, long long rows,
                                int width, int k, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= rows) return;
  float* d = smem + (size_t)warp * width;
  const float* src = cand_d + row * width;
  for (int t = lane; t < width; t += 32) d[t] = src[t];
  __syncwarp();
  for (int r = 0; r < k; ++r) {
    float bv;
    int bt;
    select_min(d, width, lane, bv, bt);
    if (lane == 0) {
      dists[row * k + r] = bv;
      idx[row * k + r] = bt < width ? cand_j[row * width + bt] : INT_MAX;
    }
    knock_out(d, width, lane, bt);
  }
}

// k <= kStreamK: the tiled form; one block per (cloud, 32 queries).
__global__ void __launch_bounds__(kTileThreads)
    knn_stream_kernel(const float* __restrict__ points,
                      const float* __restrict__ queries,
                      const float* __restrict__ bias,
                      float* __restrict__ dists, int* __restrict__ idx, int n,
                      int m, int c, int k) {
  __shared__ TileSmem sm;
  const int tiles = (m + kTQ - 1) / kTQ;
  const int cloud = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - cloud * tiles) * kTQ;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)cloud * m;
  stream_topk(sm, points + (size_t)cloud * n * c,
              queries + (size_t)row0 * c, bias + (size_t)cloud * n, n, m, c,
              q0, k, [&](int q, float d, int j) {
                if (lane < k) {
                  dists[(row0 + q) * k + lane] = d;
                  idx[(row0 + q) * k + lane] = j;
                }
              });
}

// The packed selection, k <= kStreamK: the tiled form over int keys.
__global__ void __launch_bounds__(kTileThreads)
    knn_packed_stream_kernel(const float* __restrict__ points,
                             const float* __restrict__ queries,
                             const float* __restrict__ bias,
                             float* __restrict__ dists,
                             int* __restrict__ idx, int n, int m, int c,
                             int k, int lmask) {
  __shared__ TileSmem sm;
  const int tiles = (m + kTQ - 1) / kTQ;
  const int cloud = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - cloud * tiles) * kTQ;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)cloud * m;
  stream_topk(
      sm, points + (size_t)cloud * n * c, queries + (size_t)row0 * c,
      bias + (size_t)cloud * n, n, m, c, q0, k,
      [&](int q, float, int key) {
        if (lane < k) {
          dists[(row0 + q) * k + lane] = __int_as_float(key & ~lmask);
          idx[(row0 + q) * k + lane] = key & lmask;
        }
      },
      PackedOrder{lmask});
}

// The packed selection, k > kStreamK: the row form over int keys.
__global__ void knn_packed_kernel(const float* __restrict__ points,
                                  const float* __restrict__ queries,
                                  const float* __restrict__ bias,
                                  float* __restrict__ dists,
                                  int* __restrict__ idx, int b, int n, int m,
                                  int c, int k, int lb, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= (long long)b * m) return;
  float* d = smem + (size_t)warp * (n + c);
  const long long cloud = row / m;
  row_distances(queries + row * c, points + cloud * n * c, bias + cloud * n,
                d, d + n, n, c, lane);
  // each lane turns its own entries into keys in place: the distance's
  // bits, read as an int, with the low lb bits replaced by the index
  int* keys = reinterpret_cast<int*>(d);
  const int lmask = (1 << lb) - 1;
  for (int j = lane; j < n; j += 32) keys[j] = (keys[j] & ~lmask) | j;

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  int t = -1;  // every key is >= 0
  for (int r = 0; r < k; ++r) {
    int best = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      const int key = keys[j];
      if (key > t && key < best) best = key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    t = best;
    if (lane == 0) {
      irow[r] = t & lmask;
      drow[r] = __int_as_float(t & ~lmask);
    }
  }
}

}  // namespace

extern "C" int dispu_knn(const float* points, const float* queries,
                         const float* bias, float* dists, int* idx, int b,
                         int n, int m, int c, int k, void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n)
    return (int)cudaErrorInvalidValue;
  if (k <= kStreamK) {
    knn_stream_kernel<<<tile_blocks(b, m), kTileThreads, 0,
                        (cudaStream_t)stream>>>(points, queries, bias, dists,
                                                idx, n, m, c, k);
    return (int)cudaGetLastError();
  }
  int warps;
  size_t smem;
  if (!row_launch(n, c, warps, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  knn_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, b, n, m, c, k, warps);
  return (int)cudaGetLastError();
}

// The exact selection past the row form's n: rows of L-point chunks.
// cand_d / cand_j: scratch of b * m * k * ceil(n / L) floats and ints.
extern "C" int dispu_knn_split(const float* points, const float* queries,
                               const float* bias, float* cand_d,
                               int* cand_j, float* dists, int* idx, int b,
                               int n, int m, int c, int k, int L,
                               void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)n + L - 1) / L;
  const long long width = chunks * k;
  int warps, mwarps;
  size_t smem, msmem;
  if (width > INT_MAX || !row_launch(L, c, warps, smem) ||
      !row_launch((int)width, 0, mwarps, msmem))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      knn_split_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(knn_split_merge,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const long long tasks = rows * chunks;
  knn_split_select<<<(unsigned)((tasks + warps - 1) / warps), warps * 32,
                     smem, s>>>(points, queries, bias, cand_d, cand_j, b, n,
                                m, c, k, L, (int)chunks, warps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_split_merge<<<(unsigned)((rows + mwarps - 1) / mwarps), mwarps * 32,
                    msmem, s>>>(cand_d, cand_j, dists, idx, rows,
                                (int)width, k, mwarps);
  return (int)cudaGetLastError();
}

// lb: the lane bits, bit_length(n_pad - 1) >= 1 with 2^lb >= n.
extern "C" int dispu_knn_packed(const float* points, const float* queries,
                                const float* bias, float* dists, int* idx,
                                int b, int n, int m, int c, int k, int lb,
                                void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n || lb < 1 || lb > 30 ||
      (1LL << lb) < n)
    return (int)cudaErrorInvalidValue;
  if (k <= kStreamK) {
    knn_packed_stream_kernel<<<tile_blocks(b, m), kTileThreads, 0,
                               (cudaStream_t)stream>>>(
        points, queries, bias, dists, idx, n, m, c, k, (1 << lb) - 1);
    return (int)cudaGetLastError();
  }
  int warps;
  size_t smem;
  if (!row_launch(n, c, warps, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      knn_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)b * m;
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  knn_packed_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, b, n, m, c, k, lb, warps);
  return (int)cudaGetLastError();
}
