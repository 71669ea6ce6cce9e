// Softmax attention softmax(scale * q k^T) v, forward, on the tensor cores.
//
// Replaces attention_pallas (dispu_tpu/ops/pallas_kernels.py) and keeps
// its numerics: q, k and v are rounded to bf16, the scores accumulate in
// f32 and are then scaled, the softmax is f32 (p = exp(s - rowmax), the
// max of the final row, denominator = sum of the f32 p), p is rounded to
// bf16 before the PV product, which accumulates in f32, and the output is
// divided by the denominator at the end.  Products of bf16 operands are
// exact in f32, so only the order of the f32 sums differs from the plain
// version.
//
// What bounds it on an H100: at the refiner's shape (32 clouds x 1024
// queries x 1024 keys, c = cv = 64) the function moves 33.5 MB of f32
// in and out (10 us at 3.35 TB/s) against 8.6 GFLOP of products (9 us at
// the bf16 tensor-core rate), so the bound is the bytes, and the
// attention map itself (134 MB in f32) must never reach device memory.
// Two passes over the keys, so that p is rounded against the row's final
// max: the first finds each row's max, the second forms p, the
// denominator and the PV product; the map exists one 64 x 64 tile at a
// time.
//  - One conversion pass rounds q, k and v to bf16 once a call, into the
//    wrapper's scratch, zero-padded to tiles: rows to 64, widths to 16.
//  - One block of 4 warps per (cloud, tile of 64 queries); each warp owns
//    16 whole query rows, so a row's max and sum are quad shuffles.  Q
//    stays in shared memory; K and V tiles of 64 keys stream through a
//    double-buffered shared-memory ring by cp.async (16-byte copies; rows
//    padded by 16 bytes, so ldmatrix reads them without bank conflicts).
//  - S = Q K^T and O += P V run on the tensor cores: mma.sync m16n8k16,
//    bf16 operands, f32 accumulators.  Pass 1 computes S and the row max
//    only; pass 2 computes S again (the same instructions, so the same
//    bits), p = expf(s * scale - max) with no contraction, the f32 row
//    sum, and rounds p to bf16 in registers, where the S accumulators
//    already have the layout of PV's A fragments: p never goes through
//    shared memory.  V's B fragments come from ldmatrix.trans.
//  - Widths that are not a multiple of the tile are zeros in the
//    scratch; keys past nk are masked out of the max and get p = 0.
//
// A second entry, dispu_attention_bf16, takes q, k and v already in bf16
// (the refiner at bf16 compute).  Rounding a bf16 value to bf16 is the
// identity, so it keeps every rounding point of the f32 entry and gives
// the f32 entry's bits for the same values upcast.  A tensor whose rows
// are a multiple of 64, whose width is a multiple of 16 and whose address
// is 16-byte aligned is read where it lies; only the others are copied,
// zero-padded, into the scratch (none at the refiner's shapes).  The
// inputs then fall from 25.2 MB to 12.6 MB at the 4x shape, 21.0 MB in
// and out in all (6.3 us at 3.35 TB/s), below the 8.6 GFLOP of products
// (8.7 us at 989 TFLOP/s): the bound moves from the bytes to the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTQ = 64;        // queries a block: 4 warps x 16 rows
constexpr int kTK = 64;        // keys a tile
constexpr int kThreads = 128;  // shared memory at c = cv = 256: 168,960 B
constexpr int kPadRow = 64;    // rows of the scratch: multiples of this
constexpr int kPadWidth = 16;  // widths of the scratch: multiples of this

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ----------------------------------------------------- bf16 conversion

template <typename T>
struct Convert {
  const T* src;  // (b, rows, w) f32 or bf16
  bf16* dst;     // (b, rows_pad, w_pad) bf16, zeros past rows and w
  int rows, rows_pad, w, w_pad;
};
template <typename T>
struct Converts {
  Convert<T> t[3];
  int b;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// blockIdx.y picks the tensor; each thread writes 8 bf16 (16 bytes).
template <typename T>
__global__ void __launch_bounds__(256) to_bf16_kernel(Converts<T> cv) {
  const Convert<T> t = cv.t[blockIdx.y];
  const int groups = t.w_pad / 8;
  const long long total = (long long)cv.b * t.rows_pad * groups;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < total; gi += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(gi % groups) * 8;
    const long long rr = gi / groups;
    const int row = (int)(rr % t.rows_pad);
    const long long bb = rr / t.rows_pad;
    bf16* dst = t.dst + (bb * t.rows_pad + row) * t.w_pad + col;
    const T* src = t.src + (bb * t.rows + row) * t.w + col;
    const bool whole = row < t.rows && col + 8 <= t.w &&
                       t.w % (16 / sizeof(T)) == 0 &&
                       (reinterpret_cast<uintptr_t>(t.src) & 15) == 0;
    if constexpr (std::is_same<T, bf16>::value) {
      if (whole) {  // bf16 in: 16 bytes copied as they are
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        continue;
      }
    }
    float f[8];
    bool loaded = false;
    if constexpr (std::is_same<T, float>::value) {
      if (whole) {
        const float4* s = reinterpret_cast<const float4*>(src);
        const float4 a = s[0], c = s[1];
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = row < t.rows && col + e < t.w ? to_f32(src[e]) : 0.f;
    }
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = packed;
  }
}

// ------------------------------------------------- tensor-core helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float* p, int ch, int cv, float a,
                                       float b) {
  if (ch + 1 < cv && (cv & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (ch < cv) p[0] = a;
    if (ch + 1 < cv) p[1] = b;
  }
}

// ------------------------------------------------------------ the kernel

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// A a0 (row g, cols 2t..2t+1), a1 (row g+8, same), a2 (row g, cols
// 2t+8..), a3 (row g+8, cols 2t+8..); B b0 (rows 2t..2t+1, col g), b1
// (rows 2t+8.., col g); C c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8).
// NV: n-tiles of 8 output channels the accumulators hold (cv_pad <= 8 NV).
template <int NV>
__global__ void __launch_bounds__(kThreads, NV <= 8 ? 4 : 1)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ out, int nq,
                 int nk, int cv, int nq_pad, int nk_pad, int c_pad,
                 int cv_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = c_pad + 8, vs = cv_pad + 8;  // row strides, elements
  bf16* qs = reinterpret_cast<bf16*>(smem);   // kTQ x cs
  bf16* ks = qs + kTQ * cs;                   // 2 x kTK x cs
  bf16* vsm = ks + 2 * kTK * cs;              // 2 x kTK x vs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3;
  const long long cloud = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const bf16* qb = q + (cloud * nq_pad + q0) * c_pad;
  const bf16* kb = k + cloud * nk_pad * c_pad;
  const bf16* vb = v + cloud * nk_pad * cv_pad;
  const int ntiles = nk_pad / kTK;
  const int cg = c_pad / 8, vg = cv_pad / 8;  // 16-byte groups a row
  const int kc = c_pad / 16;                  // k-steps of Q K^T
  const int nvt = cv_pad / 8;                 // n-tiles of P V (even)

  for (int e = tid; e < kTQ * cg; e += kThreads) {
    const int r = e / cg, cc = e - r * cg;
    cp_async16(qs + r * cs + cc * 8, qb + (long long)r * c_pad + cc * 8);
  }
  // step `it` of 2 * ntiles: pass 1 (K only) then pass 2 (K and V)
  auto load = [&](int it) {
    const int tile = it < ntiles ? it : it - ntiles;
    const bf16* src = kb + (long long)tile * kTK * c_pad;
    bf16* dst = ks + (it & 1) * kTK * cs;
    for (int e = tid; e < kTK * cg; e += kThreads) {
      const int r = e / cg, cc = e - r * cg;
      cp_async16(dst + r * cs + cc * 8, src + (long long)r * c_pad + cc * 8);
    }
    if (it >= ntiles) {
      const bf16* vsrc = vb + (long long)tile * kTK * cv_pad;
      bf16* vdst = vsm + (it & 1) * kTK * vs;
      for (int e = tid; e < kTK * vg; e += kThreads) {
        const int r = e / vg, cc = e - r * vg;
        cp_async16(vdst + r * vs + cc * 8,
                   vsrc + (long long)r * cv_pad + cc * 8);
      }
    }
  };
  load(0);
  cp_commit();

  // rows g and g+8 of this warp's 16
  float m0 = -__int_as_float(0x7f800000), m1 = m0;
  float l0 = 0.f, l1 = 0.f;
  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const bf16* qw = qs + warp * 16 * cs;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;  // A, and V trans
  const int b_row = (lane & 7) + ((lane >> 4) << 3);     // K as B
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int it = 0; it < 2 * ntiles; ++it) {
    if (it + 1 < 2 * ntiles) {
      load(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int key0 = (it < ntiles ? it : it - ntiles) * kTK;
    const bf16* kt = ks + (it & 1) * kTK * cs;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < kc; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qw + a_row * cs + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + (np * 16 + b_row) * cs + kk * 16 + b_col);
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (it < ntiles) {
      // pass 1: the row max of the scaled scores
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + j * 8 + 2 * t4 + e < nk) {
            m0 = fmaxf(m0, __fmul_rn(s[j][e], scale));
            m1 = fmaxf(m1, __fmul_rn(s[j][2 + e], scale));
          }
    } else {
      if (it == ntiles) {
        m0 = quad_max(m0);
        m1 = quad_max(m1);
      }
      // pass 2: p, the denominator, and P V; scale first, then subtract,
      // as the TPU kernel does (no contraction into an FMA)
      uint32_t pa[4][4];  // A fragments of 4 k-steps of 16 keys
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = key0 + j * 8 + 2 * t4 + (e & 1) < nk
                     ? expf(__fsub_rn(__fmul_rn(s[j][e], scale),
                                      e < 2 ? m0 : m1))
                     : 0.f;
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      const bf16* vt = vsm + (it & 1) * kTK * vs;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int nv = 0; nv < NV / 2; ++nv)
          if (2 * nv < nvt) {
            uint32_t b[4];
            ldsm_x4_trans(b, vt + (kq * 16 + a_row) * vs + nv * 16 + a_col);
            mma(o[2 * nv], pa[kq], b[0], b[1]);
            mma(o[2 * nv + 1], pa[kq], b[2], b[3]);
          }
    }
    __syncthreads();  // the buffer is refilled at step it + 2
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  float* ob = out + cloud * nq * cv;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (j < nvt) {
      const int ch = j * 8 + 2 * t4;
      if (r0 < nq)
        store2(ob + (long long)r0 * cv + ch, ch, cv, o[j][0] / l0,
               o[j][1] / l0);
      if (r1 < nq)
        store2(ob + (long long)r1 * cv + ch, ch, cv, o[j][2] / l1,
               o[j][3] / l1);
    }
}

struct Shape {
  int nq_pad, nk_pad, c_pad, cv_pad;
  long long q_elems, k_elems, v_elems;  // bf16 elements in the scratch
};

Shape shape_of(int b, int nq, int nk, int c, int cv) {
  Shape s;
  s.nq_pad = round_up(nq, kPadRow);
  s.nk_pad = round_up(nk, kPadRow);
  s.c_pad = round_up(c, kPadWidth);
  s.cv_pad = round_up(cv, kPadWidth);
  s.q_elems = (long long)b * s.nq_pad * s.c_pad;
  s.k_elems = (long long)b * s.nk_pad * s.c_pad;
  s.v_elems = (long long)b * s.nk_pad * s.cv_pad;
  return s;
}

template <int NV>
int launch(const bf16* q, const bf16* k, const bf16* v, float* out, int b,
           int nq, int nk, int cv, const Shape& s, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((size_t)(kTQ + 2 * kTK) * (s.c_pad + 8) +
                                      (size_t)2 * kTK * (s.cv_pad + 8));
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s.nq_pad / kTQ, b);
  attention_kernel<NV><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, nq, nk, cv, s.nq_pad, s.nk_pad, s.c_pad, s.cv_pad, scale);
  return (int)cudaGetLastError();
}

// Whether a (b, rows, w) tensor at p must be copied into the scratch: its
// rows or width off the tiles, or its address not 16-byte aligned.
template <typename T>
bool needs_copy(const T* p, int rows, int w) {
  return std::is_same<T, float>::value || rows % kPadRow != 0 ||
         w % kPadWidth != 0 || (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// Bytes of bf16 scratch for one call of the entry that takes T.
template <typename T>
long long scratch_bytes(const T* q, const T* k, const T* v, int b, int nq,
                        int nk, int c, int cv) {
  const Shape s = shape_of(b, nq, nk, c, cv);
  long long elems = 0;
  if (needs_copy(q, nq, c)) elems += s.q_elems;
  if (needs_copy(k, nk, c)) elems += s.k_elems;
  if (needs_copy(v, nk, cv)) elems += s.v_elems;
  return (long long)sizeof(bf16) * elems;
}

// f32 inputs: all three rounded into the scratch.  bf16 inputs: read
// where they lie, unless needs_copy.
template <typename T>
int run(const T* q, const T* k, const T* v, float* out, void* scratch, int b,
        int nq, int nk, int c, int cv, float scale, cudaStream_t st) {
  const Shape s = shape_of(b, nq, nk, c, cv);
  const T* src[3] = {q, k, v};
  const int rows[3] = {nq, nk, nk}, rows_pad[3] = {s.nq_pad, s.nk_pad,
                                                   s.nk_pad};
  const int w[3] = {c, c, cv}, w_pad[3] = {s.c_pad, s.c_pad, s.cv_pad};
  const long long elems[3] = {s.q_elems, s.k_elems, s.v_elems};
  const bf16* ops[3];
  bf16* next = static_cast<bf16*>(scratch);
  Converts<T> conv;
  conv.b = b;
  int n = 0;
  long long most = 0;
  for (int i = 0; i < 3; ++i) {
    if (!needs_copy(src[i], rows[i], w[i])) {
      ops[i] = reinterpret_cast<const bf16*>(src[i]);
      continue;
    }
    if (next == nullptr) return (int)cudaErrorInvalidValue;
    conv.t[n++] = Convert<T>{src[i], next, rows[i], rows_pad[i], w[i],
                             w_pad[i]};
    ops[i] = next;
    next += elems[i];
    if (elems[i] > most) most = elems[i];
  }
  if (n > 0) {
    long long blocks = (most / 8 + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    to_bf16_kernel<T><<<dim3((unsigned)blocks, n), 256, 0, st>>>(conv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bf16 *qh = ops[0], *kh = ops[1], *vh = ops[2];
  if (s.cv_pad <= 32)
    return launch<4>(qh, kh, vh, out, b, nq, nk, cv, s, scale, st);
  if (s.cv_pad <= 64)
    return launch<8>(qh, kh, vh, out, b, nq, nk, cv, s, scale, st);
  if (s.cv_pad <= 128)
    return launch<16>(qh, kh, vh, out, b, nq, nk, cv, s, scale, st);
  return launch<32>(qh, kh, vh, out, b, nq, nk, cv, s, scale, st);
}

}  // namespace

constexpr int kMaxWidth = 256;  // c and cv

static bool bad_shape(int b, int nq, int nk, int c, int cv) {
  return b < 1 || nq < 1 || nk < 1 || c < 1 || c > kMaxWidth || cv < 1 ||
         cv > kMaxWidth;
}

// Bytes of bf16 scratch the wrapper allocates for one call.
extern "C" long long dispu_attention_scratch_bytes(int b, int nq, int nk,
                                                   int c, int cv) {
  const float* none = nullptr;
  return scratch_bytes(none, none, none, b, nq, nk, c, cv);
}

extern "C" int dispu_attention(const float* q, const float* k, const float* v,
                               float* out, void* scratch, int b, int nq,
                               int nk, int c, int cv, float scale,
                               void* stream) {
  if (bad_shape(b, nq, nk, c, cv) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  return run(q, k, v, out, scratch, b, nq, nk, c, cv, scale,
             (cudaStream_t)stream);
}

// The bf16 entry's scratch for these tensors: 0 where all three are read
// where they lie.
extern "C" long long dispu_attention_bf16_scratch_bytes(
    const void* q, const void* k, const void* v, int b, int nq, int nk, int c,
    int cv) {
  return scratch_bytes(static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), b, nq, nk, c, cv);
}

extern "C" int dispu_attention_bf16(const void* q, const void* k,
                                    const void* v, float* out, void* scratch,
                                    int b, int nq, int nk, int c, int cv,
                                    float scale, void* stream) {
  if (bad_shape(b, nq, nk, c, cv)) return (int)cudaErrorInvalidValue;
  return run(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), out, scratch, b, nq, nk, c, cv,
             scale, (cudaStream_t)stream);
}
