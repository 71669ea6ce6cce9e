// Softmax attention softmax(scale * q k^T) v, forward.
//
// Replaces attention_pallas (dispu_tpu/ops/pallas_kernels.py) and keeps
// its numerics: q, k and v are rounded to bf16, the scores accumulate in
// f32 and are then scaled, the softmax is f32 (p = exp(s - rowmax),
// denominator = sum of the f32 p), p is rounded to bf16 before the PV
// product, which accumulates in f32, and the output is divided by the
// denominator at the end.
//
// What bounds it on an H100: at the refiner's shape (32 clouds x 1024
// queries x 1024 keys, c = cv = 64) the function moves 33.5 MB of f32
// in and out (10 us at 3.35 TB/s) against 8.6 GFLOP of products (9 us at
// the bf16 tensor-core rate), so the bound is the bytes, and the
// attention map itself (134 MB in f32) must never reach device memory.
// Design: one block per (cloud, tile of 64 queries); K and V stream
// through shared memory in tiles of 64 keys, so the map exists only one
// 64 x 64 tile at a time.  To round p where the TPU kernel rounds it
// (against the row's final max, not a running one) it makes two passes
// over the keys: the first finds each row's max, the second forms p,
// the denominator and the PV product.  The products run on the CUDA
// cores in f32 FMAs: exact for bf16 operands, but far from the
// tensor-core rate; wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 64;        // queries per block
constexpr int kTK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16: each thread owns 4 query rows
constexpr int kMaxC = 256;
constexpr int kMaxCV = 256;  // shared memory at c = cv = 256: 213,760 B

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage rows [r0, r0 + rows) of a (total, width) f32 matrix into shared
// memory with row stride `stride`, rounded to bf16, zero past `total`.
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int rows, int total, int width,
                                      int stride) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, t = e - r * width;
    dst[r * stride + t] =
        r0 + r < total ? bf16_round(src[(size_t)(r0 + r) * width + t]) : 0.f;
  }
}

// s[i][j] = <Q row (ty*4 + i), K row (tx + 16 j)> for this thread.
__device__ __forceinline__ void scores(const float* qs, const float* ks,
                                       int c, int cs, int ty, int tx,
                                       float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int t = 0; t < c; ++t) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * cs + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * cs + t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// Reduce over the 16 threads (tx) that share a row group (ty).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// CVJ: output channels per thread, cv <= 16 * CVJ.
template <int CVJ>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int nq, int nk, int c, int cv, float scale) {
  extern __shared__ float sm[];
  const int cs = c + 1;  // padded row stride: conflict-free K reads
  float* qs = sm;                   // kTQ x cs
  float* ks = qs + kTQ * cs;        // kTK x cs
  float* vs = ks + kTK * cs;        // kTK x cv
  float* ps = vs + kTK * cv;        // kTQ x (kTK + 1)
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long cloud = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const float* qb = q + cloud * nq * c;
  const float* kb = k + cloud * nk * c;
  const float* vb = v + cloud * nk * cv;

  stage(qs, qb, q0, kTQ, nq, c, cs);

  // pass 1: each row's max score
  float mrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mrow[i] = -__int_as_float(0x7f800000);
  float s[4][4];
  for (int k0 = 0; k0 < nk; k0 += kTK) {
    __syncthreads();
    stage(ks, kb, k0, kTK, nk, c, cs);
    __syncthreads();
    scores(qs, ks, c, cs, ty, tx, s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j < nk)
#pragma unroll
        for (int i = 0; i < 4; ++i) mrow[i] = fmaxf(mrow[i], s[i][j] * scale);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) mrow[i] = row_max(mrow[i]);

  // pass 2: p = exp(s - max), the denominator, and bf16(p) @ bf16(v)
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][CVJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CVJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kTK) {
    __syncthreads();
    stage(ks, kb, k0, kTK, nk, c, cs);
    stage(vs, vb, k0, kTK, nk, cv, cv);
    __syncthreads();
    scores(qs, ks, c, cs, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        float p = 0.f;
        // scale first, as the TPU kernel does: no contraction into an FMA
        if (k0 + key < nk)
          p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), mrow[i]));
        l[i] += p;
        ps[(ty * 4 + i) * (kTK + 1) + key] = bf16_round(p);
      }
    __syncthreads();
    for (int kk = 0; kk < kTK; ++kk) {
      float vv[CVJ];
#pragma unroll
      for (int j = 0; j < CVJ; ++j) {
        const int ch = tx + 16 * j;
        vv[j] = ch < cv ? vs[kk * cv + ch] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * (kTK + 1) + kk];
#pragma unroll
        for (int j = 0; j < CVJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = row_sum(l[i]);
    const int row = q0 + ty * 4 + i;
    if (row < nq)
#pragma unroll
      for (int j = 0; j < CVJ; ++j) {
        const int ch = tx + 16 * j;
        if (ch < cv) out[(cloud * nq + row) * cv + ch] = acc[i][j] / denom;
      }
  }
}

template <int CVJ>
int launch(const float* q, const float* k, const float* v, float* out, int b,
           int nq, int nk, int c, int cv, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) *
      ((size_t)(kTQ + kTK) * (c + 1) + (size_t)kTK * cv + kTQ * (kTK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<CVJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + kTQ - 1) / kTQ, b);
  attention_kernel<CVJ><<<grid, kThreads, smem, stream>>>(q, k, v, out, nq,
                                                          nk, c, cv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dispu_attention(const float* q, const float* k, const float* v,
                               float* out, int b, int nq, int nk, int c,
                               int cv, float scale, void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || c < 1 || c > kMaxC || cv < 1 ||
      cv > kMaxCV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cv <= 16) return launch<1>(q, k, v, out, b, nq, nk, c, cv, scale, s);
  if (cv <= 32) return launch<2>(q, k, v, out, b, nq, nk, c, cv, scale, s);
  if (cv <= 64) return launch<4>(q, k, v, out, b, nq, nk, c, cv, scale, s);
  if (cv <= 128) return launch<8>(q, k, v, out, b, nq, nk, c, cv, scale, s);
  return launch<16>(q, k, v, out, b, nq, nk, c, cv, scale, s);
}
