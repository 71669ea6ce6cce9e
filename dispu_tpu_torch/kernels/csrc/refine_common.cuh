// The refiner's local and skip branches on one tile of grouped rows,
// shared by refine_local.cu and refine_block.cu, so that the two kernels
// compute the same bits from the same grouped tile.
//
// A block of kThreads threads takes T queries (T <= kMaxT) and their
// R = T * k grouped rows [centred xyz | raw xyz | features] (cf floats a
// row), which the caller has put in shared memory.  Everything after that
// stays in shared memory and registers; device memory sees the weights
// (about 2.3 MB at GeneratorConfig() width, held in L2: conv0's and
// conv1's staged through shared memory chunk by chunk, after_conv's and
// skip's read ahead into registers, each thread its own output column)
// and one write of the tile's (T, co) output:
//   h0   = relu(g @ w0 + b0)                      (R, c1)
//   h1   = relu(h0 @ w1 + b1)                     (R, c2)
//   w    = relu(g[:, 0:3] @ ww + bw)              (R, k), BN folded in
//   pool[q, t, :] = sum_j w[q k + j, t] h1[q k + j, :]   (T, k c2)
//   out[q] = relu(pool[q] @ waf + baf) + relu(max_j g[q k + j] @ wsk + bsk)
// with waf the (k, c2, co) t-major blocks of after_conv's kernel, flat
// (k c2, co).  Every sum is an f32 FMA chain in ascending order of its
// contracted index, but for after_conv's and skip's, which the 8 warps
// split into 8 ascending ranges whose sums are added in warp order; no
// TF32, no tensor cores.
//
// Shared memory, in floats (each region a multiple of 4):
//   bufB  max(R pad(c1), R c2)   h0, then pool (T rows of k c2)
//   bufA  R max(pad(cf), pad(c2)) the grouped tile, then h1
//   wts   R k                     the pooling weights
//   Ws    2 kStage                the conv weights' staging buffers, then
//                                 the heads' partial products
//   gmax  T cf                    the skip branch's max over the k rows
// pad() makes row strides odd, so that the rows two lanes of a warp read
// (at most 31 apart) lie in distinct banks.

#pragma once

#include <cuda_runtime.h>

namespace refine_common {

constexpr int kThreads = 256;
constexpr int kMaxT = 16;
constexpr size_t kMaxSmem = 232448;
constexpr int kTile = 128;              // rows and columns of a product tile
constexpr int kChunk = 32;              // rows of W staged at a time
constexpr int kStage = kChunk * kTile;  // floats of one staging buffer
constexpr int kPer = kStage / kThreads; // of them, loaded by each thread
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;               // rows of W a warp reads at a time
constexpr int kHeadCols = 128;          // columns of a head tile
// a head tile's partial products (8 queries a warp) fill the staging
// buffers, and its sums split evenly over the threads
static_assert(kWarps * 8 * kHeadCols <= 2 * kStage, "head tile");
static_assert(8 * kHeadCols % kThreads == 0, "head tile");
constexpr int kBatch = 8;               // loads a thread keeps in flight

struct Dims {
  int k, cf, c1, c2, co;
};

struct Params {
  const float *w0, *b0, *w1, *b1, *ww, *bw, *wsk, *bsk, *waf, *baf;
};

__host__ __device__ inline int pad(int c) { return c | 1; }
__host__ __device__ inline size_t round4(size_t x) {
  return (x + 3) & ~(size_t)3;
}
__host__ __device__ inline size_t zmax(size_t a, size_t b) {
  return a > b ? a : b;
}

__host__ __device__ inline size_t buf_b_floats(int T, const Dims& d) {
  const size_t R = (size_t)T * d.k;
  return round4(zmax(R * pad(d.c1), R * d.c2));
}

__host__ __device__ inline size_t buf_a_floats(int T, const Dims& d) {
  const size_t R = (size_t)T * d.k;
  return round4(R * zmax(pad(d.cf), pad(d.c2)));
}

// Shared-memory floats of tile_mlp for T queries.
__host__ __device__ inline size_t mlp_floats(int T, const Dims& d) {
  const size_t R = (size_t)T * d.k;
  return buf_b_floats(T, d) + buf_a_floats(T, d) + round4(R * d.k) +
         round4((size_t)T * d.cf) + 2 * kStage;
}

// dst[r * ldd + c] = r < live ? src[r * cols + c] : 0 for r < rows, c <
// cols: a contiguous block of device memory into shared rows, kBatch
// loads of each thread in flight at a time.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          int rows, int live, int cols,
                                          float* dst, int ldd) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + kThreads * u;
      v[u] = (e < total && e / cols < live) ? src[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + kThreads * u;
      if (e < total) dst[(e / cols) * ldd + e % cols] = v[u];
    }
  }
}

// The grouped tile's place in shared memory: rows of stride pad(cf).
__device__ __forceinline__ float* tile_rows(float* smem, int T,
                                            const Dims& d) {
  return smem + buf_b_floats(T, d);
}

// Rows kk in [c0, c0 + kChunk) and columns c in [n0, n0 + kTile) of W
// (K, N) row-major into pre: element e = threadIdx.x + kThreads i of the
// chunk, row e / kTile, column e % kTile (coalesced); zeros outside W.
__device__ __forceinline__ void stage_load(const float* __restrict__ W,
                                           int K, int N, int c0, int n0,
                                           float (&pre)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int kk = c0 + e / kTile, c = n0 + e % kTile;
    pre[i] = (kk < K && c < N) ? __ldg(W + (size_t)kk * N + c) : 0.f;
  }
}

__device__ __forceinline__ void stage_store(float* buf,
                                            const float (&pre)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) buf[threadIdx.x + kThreads * i] = pre[i];
}

// C[r, :] = relu(A[r, :] @ W + bias) for r < R.  A and C in shared memory
// (row strides lda, ldc; they must not overlap), W (K, N) row-major and
// bias in device memory.  The 256 threads form a 16 x 16 grid; thread
// (tx, ty) computes rows ty + 16 i and columns tx + 16 j (i, j < 8) of
// each kTile x kTile output tile, a register tile of 8 x 8 sums.  W comes
// in chunks of kChunk rows through Ws (two buffers of kStage floats): each
// thread loads its share of the next chunk into registers before the
// products of the current one and stores it after them, so the chunk's
// loads from L2 overlap the products.  Every thread of the block must
// call it.
__device__ __forceinline__ void dense_relu(const float* A, int lda, int R,
                                           int K,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias,
                                           int N, float* C, int ldc,
                                           float* Ws) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int r0 = 0; r0 < R; r0 += kTile) {
    for (int n0 = 0; n0 < N; n0 += kTile) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      float pre[kPer];
      stage_load(W, K, N, 0, n0, pre);
      stage_store(Ws, pre);
      __syncthreads();
      int buf = 0;
      for (int c0 = 0; c0 < K; c0 += kChunk) {
        const bool more = c0 + kChunk < K;
        if (more) stage_load(W, K, N, c0 + kChunk, n0, pre);
        const float* ws = Ws + buf * kStage;
        const int kn = min(kChunk, K - c0);
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          float a[8], w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = r0 + ty + 16 * i;
            a[i] = r < R ? A[r * lda + c0 + kk] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) w[j] = ws[kk * kTile + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        if (more) stage_store(Ws + (buf ^ 1) * kStage, pre);
        __syncthreads();
        buf ^= 1;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= R) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + tx + 16 * j;
          if (c < N) C[r * ldc + c] = fmaxf(acc[i][j] + __ldg(bias + c), 0.f);
        }
      }
    }
  }
}

// Warp w's partial products of the head tile (queries q0 + i, i < 8;
// columns n0 + lane + 32 j, j < 4): sum over its rows kk of K, ascending,
// of X[q, kk] W[kk, c], written to part[(w 8 + i) kHeadCols + lane + 32 j]
// (kWarps 8 kHeadCols floats).  The warps split K into ranges of kw rows
// (a multiple of kGroup); each reads its rows of W kGroup at a time, one
// group ahead in registers, so its loads from L2 overlap the products;
// rows of X whose stride is a multiple of 4 are read four columns a load.
// Queries past T and columns past N give zeros.
__device__ __forceinline__ void head_part(const float* X, int ldx, int T,
                                          int K,
                                          const float* __restrict__ W, int N,
                                          int q0, int n0, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = (K + kWarps * kGroup - 1) / (kWarps * kGroup) * kGroup;
  const int lo = warp * kw, hi = min(K, lo + kw);
  const int nq = min(8, T - q0);
  bool col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col[j] = n0 + lane + 32 * j < N;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float cur[kGroup][4], nxt[kGroup][4];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cur[g][j] = (lo + g < hi && col[j])
                      ? __ldg(W + (size_t)(lo + g) * N + n0 + lane + 32 * j)
                      : 0.f;
  const bool vec = (ldx & 3) == 0;
  for (int c0 = lo; c0 < hi; c0 += kGroup) {
    const int c1 = c0 + kGroup;
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nxt[g][j] = (c1 + g < hi && col[j])
                        ? __ldg(W + (size_t)(c1 + g) * N + n0 + lane + 32 * j)
                        : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < nq) {
        const float* x = X + (size_t)(q0 + i) * ldx + c0;
        float xv[kGroup];
        if (vec && c1 <= hi) {
#pragma unroll
          for (int v = 0; v < kGroup / 4; ++v) {
            const float4 x4 = reinterpret_cast<const float4*>(x)[v];
            xv[4 * v] = x4.x;
            xv[4 * v + 1] = x4.y;
            xv[4 * v + 2] = x4.z;
            xv[4 * v + 3] = x4.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) xv[g] = c0 + g < hi ? x[g] : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[g], cur[g][j], acc[i][j]);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[g][j] = nxt[g][j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(warp * 8 + i) * kHeadCols + lane + 32 * j] = acc[i][j];
}

// The sum over the warps, in warp order, of head_part's partial products
// at tile element e = i kHeadCols + c.
__device__ __forceinline__ float head_sum(const float* part, int e) {
  float s = part[e];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += part[w * 8 * kHeadCols + e];
  return s;
}

// The local and skip branches of T queries whose grouped rows the caller
// has written to tile_rows(smem, T, d) (rows of queries >= valid zeroed)
// and synchronized.  Writes out[q * co + o] for q < valid.  Every thread
// of the block must call it.
__device__ void tile_mlp(float* smem, int T, int valid, const Dims& d,
                         const Params& p, float* __restrict__ out) {
  const int k = d.k, cf = d.cf, c1 = d.c1, c2 = d.c2, co = d.co;
  const int R = T * k;
  float* bufB = smem;
  float* bufA = smem + buf_b_floats(T, d);
  float* wts = bufA + buf_a_floats(T, d);
  float* Ws = wts + round4((size_t)R * k);
  float* gmax = Ws + 2 * kStage;
  const int ldg = pad(cf);

  // the pooling weights: the weight net on the centred xyz (lanes 0..2)
  for (int e = threadIdx.x; e < R * k; e += kThreads) {
    const int r = e / k, t = e - r * k;
    const float* g = bufA + r * ldg;
    float s = fmaf(g[0], __ldg(p.ww + t), 0.f);
    s = fmaf(g[1], __ldg(p.ww + k + t), s);
    s = fmaf(g[2], __ldg(p.ww + 2 * k + t), s);
    wts[e] = fmaxf(s + __ldg(p.bw + t), 0.f);
  }
  // the skip branch's max over each query's k rows
  for (int e = threadIdx.x; e < T * cf; e += kThreads) {
    const int q = e / cf, c = e - q * cf;
    const float* g = bufA + (size_t)q * k * ldg + c;
    float m = g[0];
    for (int j = 1; j < k; ++j) m = fmaxf(m, g[j * ldg]);
    gmax[e] = m;
  }
  dense_relu(bufA, ldg, R, cf, p.w0, p.b0, c1, bufB, pad(c1), Ws);
  __syncthreads();
  dense_relu(bufB, pad(c1), R, c1, p.w1, p.b1, c2, bufA, pad(c2), Ws);
  __syncthreads();
  // pool[q, t c2 + c] into bufB (h0 is spent)
  const int ldh = pad(c2);
  const int kc = k * c2;
  for (int e = threadIdx.x; e < T * kc; e += kThreads) {
    const int q = e / kc, rem = e - q * kc;
    const int t = rem / c2, c = rem - t * c2;
    const float* h = bufA + (size_t)q * k * ldh + c;
    const float* w = wts + (size_t)q * k * k + t;
    float s = 0.f;
#pragma unroll 4
    for (int j = 0; j < k; ++j) s = fmaf(w[j * k], h[j * ldh], s);
    bufB[e] = s;
  }
  __syncthreads();
  // after_conv and skip, a tile of 8 queries by kHeadCols columns at a
  // time; the partial products go to Ws (spent), the sums stay with the
  // thread that writes the output
  constexpr int kPerThread = 8 * kHeadCols / kThreads;
  for (int q0 = 0; q0 < T; q0 += 8) {
    for (int n0 = 0; n0 < co; n0 += kHeadCols) {
      float after[kPerThread];
      head_part(bufB, kc, T, kc, p.waf, co, q0, n0, Ws);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPerThread; ++u)
        after[u] = head_sum(Ws, threadIdx.x + kThreads * u);
      __syncthreads();
      head_part(gmax, cf, T, cf, p.wsk, co, q0, n0, Ws);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int e = threadIdx.x + kThreads * u;
        const int q = q0 + e / kHeadCols, o = n0 + e % kHeadCols;
        const float skip = head_sum(Ws, e);
        if (q < valid && o < co)
          out[(size_t)q * co + o] = fmaxf(after[u] + __ldg(p.baf + o), 0.f) +
                                    fmaxf(skip + __ldg(p.bsk + o), 0.f);
      }
      __syncthreads();
    }
  }
}

}  // namespace refine_common
