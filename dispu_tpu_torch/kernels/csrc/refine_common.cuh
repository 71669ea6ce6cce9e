// The refiner's local and skip branches on one tile of grouped rows,
// shared by refine_local.cu and refine_block.cu, so that the two kernels
// compute the same bits from the same grouped tile.
//
// A block of kCompute threads (8 warps) and one producer warp takes T <=
// kMaxT queries and their R = T * k <= kMaxRows grouped rows [centred xyz
// | raw xyz | features] (cf floats a row), which the caller has put in
// shared memory.  Then:
//   h0   = relu(g @ w0 + b0)                      (R, c1)
//   h1   = relu(h0 @ w1 + b1)                     (R, c2)
//   w    = relu(g[:, 0:3] @ ww + bw)              (R, k), BN folded in
//   pool[q, t, :] = sum_j w[q k + j, t] h1[q k + j, :]   (T, k c2)
//   out[q] = relu(pool[q] @ waf + baf) + relu(max_j g[q k + j] @ wsk + bsk)
// with waf the (k, c2, co) t-major blocks of after_conv's kernel, flat
// (k c2, co).
//
// Products: on the tensor cores at f32 grade (3xTF32).  Each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest;
// mma.sync m16n8k8 takes lo*hi and hi*lo, then hi*hi (lo*lo, below f32's
// last bit, is left out).  The tensor cores round their f32 sums toward
// zero, so a running sum fed back through them loses a last bit at every
// k8 block, a bias that grows with K (1.8e-5 of the output at K = 2048,
// where 1e-5 is allowed).  So the tensor cores sum short windows from
// zero and the CUDA cores add the windows, to nearest.  conv0 and conv1
// take the tile's rows as the m16 side and the weights as the n8 side,
// the 8 warps 4 x 2 tiles of 32 rows x 64 columns (64 sums a thread),
// over passes of kConvCols columns, a window one k8 block, the 16 tiles'
// chains free of branches so that they interleave.  The heads take the
// transposed product, out^T (co x 16) = waf^T (co x k c2) . pool^T
// (k c2 x 16) and wsk^T (co x cf) . gmax^T (cf x 16), whose n side is
// both blocks' queries of a cluster (see below): block r takes its slice
// of the columns, warp w one
// m16 tile of it against both n8 tiles, so no partial sums cross warps;
// the cross terms of even and odd k8 blocks run in separate sums, eight
// chains of products a warp; bias and both relus are the epilogue.  The
// pooling (k x k weights against k x c2 a query, 2.1 of 74 GFLOP at the
// pass-1 shape) runs the same way, one query a warp.
//
// Weights: through a ring of kStages buffers of kStageBytes in shared
// memory, shared by a cluster of kCluster = 2 blocks.  A small kernel
// first lays w0, w1, waf and wsk out in fragment order (zero-padded to
// whole tiles; conflict-free 16-byte loads a lane; the convs' split into
// TF32 hi and lo there, after_conv's and skip's raw f32, split in
// registers) as segments in the order a tile takes them: conv0's
// passes, conv1's, then each head pass's after_conv and skip, each head
// segment cut into one column slice a block.  Block 0's producer warp
// copies each chunk with cp.async.bulk: a conv chunk once for both blocks
// (.multicast::cluster), a head chunk each block its own slice; either
// way L2 gives up each byte once a cluster, and the bytes complete on each
// block's own "full" mbarrier.  A block's warps count their releases of a
// buffer in shared memory; the last of them arrives on block 0's "empty"
// mbarrier (mapa + mbarrier.arrive.shared::cluster), and the producer
// refills the buffer once both blocks have.  After the pooling a cluster
// barrier, and each block copies the other's pool and skip max from its
// shared memory (DSMEM), so the heads see 16 queries: every block takes in
// its 8 queries' conv weights and half of the heads' (1.39 of 2.51 MB at
// GeneratorConfig() width).  A block past the grid's last tile takes part
// in every copy and barrier and writes nothing.
//
// Shared memory, in this order (floats unless said; ld() makes a row
// stride = 4 mod 8, so that the 8 rows x 4 columns of an mma fragment lie
// in distinct banks; rows counted to R32 = R rounded up to 32, zero or
// finite past R):
//   ring  kStages x kStageBytes bytes, 2 kStages mbarriers, kStages
//         counts
//   A     max(R32 max(ld(cf), ld(c2)), 8 ld(k c2))
//                                   the grouped tile, then h1, then the
//                                   other block's pool
//   B     max(R32 ld(c1), 8 ld(k c2)) h0, then pool (8 query rows)
//   wts   R32 k                     the pooling weights
//   gmax  2 x 8 ld(cf)              the skip's max over the k rows, this
//                                   block's and the other's
// At GeneratorConfig() width (k 16, cf 134, c1 = c2 = 128, co 256, T 8)
// that is 65,584 + 156,416 bytes: one block an SM.
//
// Registers (nvcc -Xptxas -v, sm_90a): 168 a thread, the most that nine
// warps a block leave (a scheduler's 16,384 hold three), with 4 bytes of
// spill stores and loads in each kernel.  The conv products take them
// (131 without them, dispu_tpu_torch/time_refine_forms).  Two other
// designs were built and timed on an H100 while this one was made: no
// producer warp (the block that lets go of a buffer last refills it,
// through a cluster-scope atomic): 187 registers, no spill, but slower at
// the refiner's pass-1 shape; and setmaxnreg moving the producer warp's
// registers to the compute warps (at most 184 within the block's
// allocation): the launch hung.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace refine_common {

constexpr int kWarps = 8;                 // compute warps
constexpr int kCompute = 32 * kWarps;     // their threads
constexpr int kThreads = kCompute + 32;   // and the producer warp
constexpr int kMaxT = 8;        // queries a tile: the heads' n8 side
constexpr int kMaxRows = 128;   // grouped rows a tile
constexpr size_t kMaxSmem = 232448;
constexpr int kCluster = 2;     // blocks that share each weight chunk
constexpr int kStages = 2;      // buffers of the ring
constexpr int kStageBytes = 32768;
constexpr int kStageFloats = kStageBytes / 4;
constexpr int kConvCols = 128;  // columns of a conv pass: 16 n8 tiles
constexpr int kHeadCols = 256;  // columns of a head pass: 16 m16 tiles
constexpr int kPair = 2;        // blocks whose queries the heads share
constexpr int kHeadTiles = 16 / kPair;  // of them, a block's slice
constexpr int kBatch = 8;       // loads a thread keeps in flight
static_assert(kWarps == 8, "the product tilings assume 8 warps");
static_assert(kPair == 2 && kHeadTiles == kWarps && kCluster % kPair == 0,
              "a head slice is one m16 tile a warp, a pair's queries");
static_assert(16 * 32 * 4 <= kStageFloats, "a k8 block fits a buffer");

struct Dims {
  int k, cf, c1, c2, co;
};

// The raw parameters, and the fragment-ordered weights (packed) that
// pack_weights writes from them.
struct Params {
  const float *w0, *b0, *w1, *b1, *ww, *bw, *wsk, *bsk, *waf, *baf;
  const float* packed;
};

__host__ __device__ inline int up8(int c) { return (c + 7) & ~7; }
// row stride of an mma operand of c columns: whole k8 blocks, = 4 mod 8
__host__ __device__ inline int ld(int c) { return up8(c) + 4; }
__host__ __device__ inline int rows32(int T, int k) {
  return (T * k + 31) & ~31;
}
__host__ __device__ inline size_t zmax(size_t a, size_t b) {
  return a > b ? a : b;
}
__host__ __device__ inline size_t round4(size_t x) {
  return (x + 3) & ~(size_t)3;
}

// ------------------------------------------------------------ the weights

// One segment of the packed weights as block `rank` of a cluster sees
// it: the k8 blocks of one matrix's pass, each block `tiles` fragment
// tiles of 32 lanes x `frag` floats.  The conv weights are one slice that
// every block takes (multicast); each head pass is cut into kCluster
// column slices of at most kHeadTiles m16 tiles (as even as can be), one
// a block, stored one after another.
struct Segment {
  int which;      // 0 w0, 1 w1 (conv B operands); 2 waf, 3 wsk (head A)
  int pass;       // column pass
  int K, N;       // the matrix (K, N) row-major
  int kbs;        // k8 blocks: up8(K) / 8
  int tiles;      // n8 (conv) or m16 (head) tiles of this block's slice
  int frag;       // floats a lane a tile: 4 (conv: hi and lo; head: raw)
  int kb_chunk;   // k8 blocks a ring chunk
  int col0;       // the slice's first column of W
  size_t before;  // floats of the slices before this block's
  size_t group;   // floats of all the segment's slices
};

__host__ __device__ inline int passes(int N, int cols) {
  return (N + cols - 1) / cols;
}

__host__ __device__ inline int num_segments(const Dims& d) {
  return passes(d.c1, kConvCols) + passes(d.c2, kConvCols) +
         2 * passes(d.co, kHeadCols);
}

__host__ __device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

__host__ __device__ inline Segment segment(const Dims& d, int s, int rank) {
  Segment g;
  const int p0 = passes(d.c1, kConvCols), p1 = passes(d.c2, kConvCols);
  if (s < p0 + p1) {
    const bool first = s < p0;
    g.which = first ? 0 : 1;
    g.pass = first ? s : s - p0;
    g.K = first ? d.cf : d.c1;
    g.N = first ? d.c1 : d.c2;
    g.frag = 4;
    g.kbs = up8(g.K) / 8;
    g.tiles = 16;  // zero past N, so that the products take no branch
    g.col0 = kConvCols * g.pass;
    g.before = 0;
    g.group = (size_t)g.kbs * g.tiles * 128;
    const int fit = kStageFloats / (g.tiles * 128);
    g.kb_chunk = fit < g.kbs ? fit : g.kbs;
  } else {
    const int h = s - p0 - p1;
    g.which = 2 + (h & 1);
    g.pass = h >> 1;
    g.K = (h & 1) ? d.cf : d.k * d.c2;
    g.N = d.co;
    g.frag = 4;
    g.kbs = up8(g.K) / 8;
    const int all = clampi((g.N + 15) / 16 - 16 * g.pass, 0, 16);
    const int slice = rank % kPair;
    const int start = slice * (all / kPair) + min(slice, all % kPair);
    g.tiles = all / kPair + (slice < all % kPair ? 1 : 0);
    g.col0 = kHeadCols * g.pass + 16 * start;
    g.before = (size_t)g.kbs * 128 * start;
    g.group = (size_t)g.kbs * 128 * all;
    const int fit = kStageFloats / (kHeadTiles * 128);
    g.kb_chunk = fit < g.kbs ? fit : g.kbs;
  }
  return g;
}

__host__ __device__ inline int kb_floats(const Segment& g) {
  return g.tiles * 32 * g.frag;
}
__host__ __device__ inline int seg_chunks(const Segment& g) {
  return (g.kbs + g.kb_chunk - 1) / g.kb_chunk;
}

__host__ __device__ inline size_t packed_floats(const Dims& d) {
  size_t n = 0;
  for (int s = 0; s < num_segments(d); ++s) n += segment(d, s, 0).group;
  return n;
}

// Chunks a block takes in all (the same in every block).
__host__ __device__ inline int total_chunks(const Dims& d) {
  int n = 0;
  for (int s = 0; s < num_segments(d); ++s)
    n += seg_chunks(segment(d, s, 0));
  return n;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the generic address of p's place in block `rank`'s shared memory
__device__ __forceinline__ const float* peer_ptr(const float* p,
                                                 uint32_t rank) {
  uint64_t a;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(a);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// a barrier of the compute warps alone (the producer warp does not wait)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCompute) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// an arrival on the barrier at the same offset in block `rank`
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar,
                                               uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// bytes from global src to dst in every block of `mask`, completing on
// the barrier at bar's offset in each
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Slice blockIdx.x of segment blockIdx.y of the packed weights from the
// raw ones.  Conv (B operand of m16n8k8, W (K, N)), split ahead into TF32
// hi and lo: tile n, lane (g, t), float j holds part j >> 1 (hi, lo) of
// W[8 kb + t + 4 (j & 1), col0 + 8 n + g].  Head (A operand, W^T of W (K,
// co)), raw: tile m, lane (g, t), float j holds W[8 kb + t + 4 (j >> 1),
// col0 + 16 m + g + 8 (j & 1)].  Zeros outside W.
__global__ void pack_kernel(Params p, Dims d, float* __restrict__ packed) {
  const int s = blockIdx.y, rank = blockIdx.x;
  size_t base = 0;
  for (int i = 0; i < s; ++i) base += segment(d, i, 0).group;
  const Segment g = segment(d, s, rank);
  if (g.which < 2 && rank > 0) return;  // one conv slice for all
  const float* W = g.which == 0 ? p.w0 : g.which == 1 ? p.w1
                                       : g.which == 2 ? p.waf : p.wsk;
  const int kbf = kb_floats(g);
  const size_t total = (size_t)g.kbs * kbf;
  float* dst = packed + base + g.before;
  for (size_t e = (size_t)blockIdx.z * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.z * blockDim.x) {
    const int kb = (int)(e / kbf), rem = (int)(e % kbf);
    const int tile = rem / (32 * g.frag);
    const int lane = (rem / g.frag) & 31, j = rem % g.frag;
    const int gq = lane >> 2, t = lane & 3;
    if (g.which < 2) {
      const int row = 8 * kb + t + 4 * (j & 1), col = g.col0 + 8 * tile + gq;
      const float x =
          (row < g.K && col < g.N) ? W[(size_t)row * g.N + col] : 0.f;
      uint32_t hi, lo;
      split(x, hi, lo);
      dst[e] = __uint_as_float(j >> 1 ? lo : hi);
    } else {
      const int row = 8 * kb + t + 4 * (j >> 1);
      const int col = g.col0 + 16 * tile + gq + 8 * (j & 1);
      dst[e] = (row < g.K && col < g.N) ? W[(size_t)row * g.N + col] : 0.f;
    }
  }
}

inline cudaError_t pack_weights(const Params& p, const Dims& d, float* packed,
                                cudaStream_t stream) {
  pack_kernel<<<dim3(kPair, num_segments(d), 32), kCompute, 0, stream>>>(
      p, d, packed);
  return cudaGetLastError();
}

// ------------------------------------------------------------- the ring

__host__ __device__ inline size_t ring_bytes() {
  return (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) +
         round4(kStages) * sizeof(int);
}

// Walks the chunks of the packed weights in order, as block `rank` takes
// them: each one's offset and bytes, with segment() recomputed once a
// segment.
struct Cursor {
  Segment g;
  int seg, kb0, rank;
  size_t base;

  __device__ void start(const Dims& d, int r) {
    rank = r;
    g = segment(d, 0, r);
    seg = 0;
    kb0 = 0;
    base = 0;
  }
  __device__ void next(const Dims& d) {
    kb0 += g.kb_chunk;
    if (kb0 >= g.kbs) {
      base += g.group;
      kb0 = 0;
      if (++seg < num_segments(d)) g = segment(d, seg, rank);
    }
  }
  __device__ bool shared() const { return g.which < 2; }
  // An empty slice (co <= 16 leaves a block no head tile) still takes 16
  // bytes from the weights' start, so that every chunk is a copy that
  // completes its barrier's phase: an arrival alone could complete the
  // next phase before every warp has seen the last.
  __device__ size_t offset() const {
    return g.tiles > 0 ? base + g.before + (size_t)kb0 * kb_floats(g) : 0;
  }
  __device__ uint32_t bytes() const {
    const uint32_t b =
        4u * (uint32_t)(min(g.kb_chunk, g.kbs - kb0) * kb_floats(g));
    return b > 0 ? b : 16u;
  }
};

// Thread 0's walk over the chunks its block awaits: their bytes only,
// in as few registers as can be, since every compute thread holds them.
struct Expect {
  int seg, kb0, kbs, kb_chunk, kbf;

  __device__ void load(const Dims& d, int rank) {
    const Segment g = segment(d, seg, rank);
    kbs = g.kbs;
    kb_chunk = g.kb_chunk;
    kbf = kb_floats(g);
    kb0 = 0;
  }
  __device__ void start(const Dims& d, int rank) {
    seg = 0;
    load(d, rank);
  }
  __device__ void next(const Dims& d, int rank) {
    kb0 += kb_chunk;
    if (kb0 >= kbs && ++seg < num_segments(d)) load(d, rank);
  }
  // as Cursor::bytes
  __device__ uint32_t bytes() const {
    const uint32_t b = 4u * (uint32_t)(min(kb_chunk, kbs - kb0) * kbf);
    return b > 0 ? b : 16u;
  }
};

// The consumers' side of the ring (every compute thread: chunk, the
// current chunk's index; thread 0: `expect` walks the chunks whose bytes
// its block awaits next) and the producer's (block 0's producer warp,
// with a cursor a head slice of its own).
struct Ring {
  unsigned char* smem;  // the buffers, then the barriers and counts
  const float* packed;
  Dims d;
  int total, chunk, rank;
  Expect expect;

  __device__ float* buf(int s) const {
    return reinterpret_cast<float*>(smem) + (size_t)s * kStageFloats;
  }
  // a block's own: the chunk has landed
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStageBytes)
           + s;
  }
  // block 0's: every block of the cluster has let go
  __device__ uint64_t* empty(int s) const { return full(kStages + s); }
  // warps of this block that have let go
  __device__ int* done(int s) const {
    return reinterpret_cast<int*>(full(2 * kStages)) + s;
  }

  // The producer warp's loop (block 0's, one lane): every chunk into its
  // buffer, from the kStages-th on once the whole cluster has let go of
  // the chunk before it there.  A conv chunk goes to every block in one
  // multicast copy, a head chunk to each block its own slice.
  __device__ void produce() const {
    Cursor fill[kPair];
#pragma unroll
    for (int q = 0; q < kPair; ++q) fill[q].start(d, q);
    for (int c = 0; c < total; ++c) {
      const int q = c - kStages;
      if (q >= 0) mbar_wait(empty(q % kStages), (uint32_t)(q / kStages) & 1);
      float* dst = buf(c % kStages);
      if (fill[0].shared()) {
        bulk_multicast(dst, packed + fill[0].offset(), fill[0].bytes(),
                       full(c % kStages), (uint16_t)((1u << kCluster) - 1));
      } else {
#pragma unroll
        for (int q = 0; q < kPair; ++q) {
          uint16_t mask = 0;
          for (int r = q; r < kCluster; r += kPair) mask |= 1u << r;
          bulk_multicast(dst, packed + fill[q].offset(), fill[q].bytes(),
                         full(c % kStages), mask);
        }
      }
#pragma unroll
      for (int q = 0; q < kPair; ++q) fill[q].next(d);
    }
  }

  // The current chunk's buffer, once it has landed.  Thread 0 then
  // expects the bytes of the chunk that will refill it (the copy is
  // issued only after this warp has let go of the current one).
  __device__ const float* acquire() {
    const int s = chunk % kStages;
    mbar_wait(full(s), (uint32_t)(chunk / kStages) & 1);
    if (threadIdx.x == 0 && chunk + kStages < total) {
      mbar_expect_tx(full(s), expect.bytes());
      expect.next(d, rank);
    }
    return buf(s);
  }

  // This warp is done with the current chunk; the block's last warp to be
  // so arrives on block 0's empty barrier.  On to the next chunk.
  __device__ void release() {
    __syncwarp();
    const int s = chunk % kStages;
    if ((threadIdx.x & 31) == 0) {
      __threadfence_block();
      if ((atomicAdd(done(s), 1) + 1) % kWarps == 0)
        mbar_arrive_at(empty(s), 0);
    }
    ++chunk;
  }
};

// The ring at the start of dynamic shared memory, its barriers set up in
// every block, thread 0 awaiting the first kStages chunks.  Every thread
// of every block of the cluster must call it (it holds a cluster
// barrier), before anything else touches shared memory.
__device__ inline Ring ring_start(unsigned char* smem, const Dims& d,
                                  const float* packed) {
  Ring r;
  r.smem = smem;
  r.packed = packed;
  r.d = d;
  r.total = total_chunks(d);
  r.chunk = 0;
  r.rank = (int)cluster_rank();
  r.expect.start(d, r.rank);
  const int first = r.total < kStages ? r.total : kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), kCluster);
      *r.done(s) = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < first; ++s) {
      mbar_expect_tx(r.full(s), r.expect.bytes());
      r.expect.next(d, r.rank);
    }
  }
  cluster_sync();  // every block's barriers exist before any copy
  return r;
}

// ------------------------------------------------------- the tile's memory

// region A also takes the other block's pool rows for the heads
__host__ __device__ inline size_t region_a_floats(int T, const Dims& d) {
  return zmax((size_t)rows32(T, d.k) * zmax(ld(d.cf), ld(d.c2)),
              (size_t)8 * ld(d.k * d.c2));
}
__host__ __device__ inline size_t region_b_floats(int T, const Dims& d) {
  return zmax((size_t)rows32(T, d.k) * ld(d.c1),
              (size_t)8 * ld(d.k * d.c2));
}
__host__ __device__ inline size_t wts_floats(int T, const Dims& d) {
  return round4((size_t)rows32(T, d.k) * d.k);
}

// Shared-memory floats of tile_mlp's regions (after the ring): A, B, the
// pooling weights, and the skip's max of this block and of the other.
__host__ __device__ inline size_t mlp_floats(int T, const Dims& d) {
  return region_a_floats(T, d) + region_b_floats(T, d) + wts_floats(T, d) +
         (size_t)16 * ld(d.cf);
}

// dst[r * ldd + c] = r < live && c < cols ? src[r * cols + c] : 0 for
// r < rows, c < cols_pad: a contiguous block of device memory into padded
// shared rows.  Where src is 16-byte aligned the block is read 16 bytes a
// load, kBatch loads of each thread in flight at a time.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          int rows, int live, int cols,
                                          int cols_pad, float* dst, int ldd) {
  const int n = live * cols;
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n / 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int base = threadIdx.x; base < n4; base += kCompute * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + kCompute * u;
      if (i < n4) v[u] = __ldg(src4 + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + kCompute * u;
      if (i >= n4) continue;
      const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      int r = 4 * i / cols, c = 4 * i - r * cols;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[r * ldd + c] = f[q];
        if (++c == cols) {
          c = 0;
          ++r;
        }
      }
    }
  }
  for (int e = 4 * n4 + threadIdx.x; e < n; e += kCompute) {
    const int r = e / cols;
    dst[r * ldd + e - r * cols] = src[e];
  }
  const int pad = cols_pad - cols;
  for (int e = threadIdx.x; e < live * pad; e += kCompute) {
    const int r = e / pad;
    dst[r * ldd + cols + e - r * pad] = 0.f;
  }
  for (int e = threadIdx.x; e < (rows - live) * cols_pad; e += kCompute) {
    const int r = e / cols_pad;
    dst[(live + r) * ldd + e - r * cols_pad] = 0.f;
  }
}


// ------------------------------------------------------------ products

// One k8 block of a warp's conv tile: rows g (+ 8, + 16, + 24) of x
// (stride ldx; x[0], x[4]: columns t, t + 4 of the block) against the 8
// n8 tiles of wk (B fragments split ahead, 128 floats a tile).  Each
// tile's 3xTF32 products run from zero through the tensor cores and are
// then added to acc.  No branch, so that the 16 tiles' chains of products
// interleave.
__device__ __forceinline__ void conv_step(const float* x, int ldx,
                                          const float* wk,
                                          float (&acc)[2][8][4]) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* xr = x + (size_t)(16 * i) * ldx;
    split(xr[0], ah[i][0], al[i][0]);
    split(xr[8 * ldx], ah[i][1], al[i][1]);
    split(xr[4], ah[i][2], al[i][2]);
    split(xr[8 * ldx + 4], ah[i][3], al[i][3]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(wk + j * 128);
    const uint32_t bh[2] = {__float_as_uint(v.x), __float_as_uint(v.y)};
    const uint32_t bl[2] = {__float_as_uint(v.z), __float_as_uint(v.w)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      mma(s, al[i], bh[0], bh[1]);
      mma(s, ah[i], bl[0], bl[1]);
      mma(s, ah[i], bh[0], bh[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += s[e];
    }
  }
}

// C[r, c] = relu(X[r, :] @ W + bias[c]) for r < R32, c < up8(N) (0 past
// N), X in shared memory (stride ldx, zero past K up to up8(K), R32 rows
// that are finite), W the ring's segments from s0 on, one a pass of
// kConvCols columns (16 n8 tiles, zero past N).  Warp (wr, wc) of 4 x 2
// takes rows 32 wr and columns 64 wc of a pass, where there are any.
// Every compute thread must call it.
__device__ __forceinline__ void conv(const float* X, int ldx, int R32,
                                     const float* __restrict__ bias, float* C,
                                     int ldc, const Dims& d, int s0, int np,
                                     Ring& ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const float* xw = X + (size_t)(32 * wr + g) * ldx + t;
  for (int pass = 0; pass < np; ++pass) {
    const Segment seg = segment(d, s0 + pass, 0);
    const int real = clampi((seg.N + 7) / 8 - 16 * pass, 0, 16);
    const bool live = 32 * wr < R32 && 8 * wc < real;
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kb0 = 0; kb0 < seg.kbs; kb0 += seg.kb_chunk) {
      const float* w = ring.acquire() + 8 * wc * 128 + lane * 4;
      const int kn = min(seg.kb_chunk, seg.kbs - kb0);
      if (live)
        for (int kb = 0; kb < kn; ++kb)
          conv_step(xw + (kb0 + kb) * 8, ldx, w + kb * 2048, acc);
      ring.release();
    }
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 32 * wr + 16 * i + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = 8 * wc + j;
        if (nt >= real) continue;
        const int c = kConvCols * pass + 8 * nt + 2 * t;
        const float b0 = c < seg.N ? __ldg(bias + c) : 0.f;
        const float b1 = c + 1 < seg.N ? __ldg(bias + c + 1) : 0.f;
        const float2 lo = make_float2(
            c < seg.N ? fmaxf(acc[i][j][0] + b0, 0.f) : 0.f,
            c + 1 < seg.N ? fmaxf(acc[i][j][1] + b1, 0.f) : 0.f);
        const float2 hi = make_float2(
            c < seg.N ? fmaxf(acc[i][j][2] + b0, 0.f) : 0.f,
            c + 1 < seg.N ? fmaxf(acc[i][j][3] + b1, 0.f) : 0.f);
        *reinterpret_cast<float2*>(C + (size_t)r * ldc + c) = lo;
        *reinterpret_cast<float2*>(C + (size_t)(r + 8) * ldc + c) = hi;
      }
    }
  }
}

// One k8 block of a warp's head tile against both blocks' queries: wk
// its A fragment (4 floats a lane), x[j] block j's B fragment (x[j][0],
// x[j][4]: rows g, columns t and t + 4).  The hi*hi products go to the
// window's sums hh (the caller adds them on the CUDA cores, every two k8
// blocks); the cross terms (2^-11 of them, so the tensor cores' rounding
// of their running sum is far below f32's last bit of the output) run on
// in sml.
__device__ __forceinline__ void head_step(const float* const (&x)[kPair],
                                          const float* wk,
                                          float (&hh)[kPair][4],
                                          float (&sml)[kPair][4]) {
  const float4 a = *reinterpret_cast<const float4*>(wk);
  uint32_t ah[4], al[4];
  split(a.x, ah[0], al[0]);
  split(a.y, ah[1], al[1]);
  split(a.z, ah[2], al[2]);
  split(a.w, ah[3], al[3]);
#pragma unroll
  for (int j = 0; j < kPair; ++j) {
    uint32_t bh[2], bl[2];
    split(x[j][0], bh[0], bl[0]);
    split(x[j][4], bh[1], bl[1]);
    mma(hh[j], ah, bh[0], bh[1]);
    mma(sml[j], al, bh[0], bh[1]);
    mma(sml[j], ah, bl[0], bl[1]);
  }
}

// big += hh, and hh back to zero: the end of a window of hi*hi products.
__device__ __forceinline__ void add_window(float (&big)[kPair][4],
                                           float (&hh)[kPair][4]) {
#pragma unroll
  for (int j = 0; j < kPair; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      big[j][e] += hh[j][e];
      hh[j][e] = 0.f;
    }
}

// Where the heads of one block's tile go: its rows of out, and how many
// of its queries are real.
struct TileOut {
  float* out;
  int valid;
};

// out[q, o] = relu(pool[q] @ waf + baf)[o] + relu(gmax[q] @ wsk + bsk)[o]
// for the queries of both blocks of the cluster and this block's slice of
// the columns, as out^T = W^T X^T with the 16 queries the n side: warp w
// takes m16 tile w of the slice of each pass.  pools[j], gmaxs[j]: block
// j's pool (8 rows, stride ldp, zero past k c2) and skip max (8 rows,
// stride ldg, zero past cf) in this block's shared memory, zero in rows
// past T.  Even and odd k8 blocks keep cross terms apart, so that eight
// chains of products are in flight a warp.  Every compute thread must
// call it.
__device__ __forceinline__ void heads(const float* const (&pools)[kPair],
                                      int ldp,
                                      const float* const (&gmaxs)[kPair],
                                      int ldg, const TileOut (&outs)[kPair],
                                      const Dims& d, const Params& p, int s0,
                                      int rank, Ring& ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = passes(d.co, kHeadCols);
  for (int pass = 0; pass < np; ++pass) {
    // [after_conv, skip][block j][fragment]; sml also [k8 block parity];
    // hh: the current window's hi*hi sums
    float big[2][kPair][4], sml[2][2][kPair][4], hh[kPair][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kPair; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          big[h][j][e] = 0.f;
          sml[h][0][j][e] = 0.f;
          sml[h][1][j][e] = 0.f;
          hh[j][e] = 0.f;
        }
    Segment seg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      seg = segment(d, s0 + 2 * pass + h, rank);
      const float* X[kPair];
#pragma unroll
      for (int j = 0; j < kPair; ++j)
        X[j] = (h ? gmaxs[j] : pools[j]) + (size_t)g * (h ? ldg : ldp) + t;
      const bool mine = warp < seg.tiles;
      const int step = seg.tiles * 128;
      for (int kb0 = 0; kb0 < seg.kbs; kb0 += seg.kb_chunk) {
        const float* w = ring.acquire() + warp * 128 + lane * 4;
        const int kn = min(seg.kb_chunk, seg.kbs - kb0);
        if (mine) {
          int kb = 0;
          for (; kb + 1 < kn; kb += 2) {
            const float* x0[kPair];
            const float* x1[kPair];
#pragma unroll
            for (int j = 0; j < kPair; ++j) {
              x0[j] = X[j] + (kb0 + kb) * 8;
              x1[j] = x0[j] + 8;
            }
            head_step(x0, w + kb * step, hh, sml[h][0]);
            head_step(x1, w + (kb + 1) * step, hh, sml[h][1]);
            add_window(big[h], hh);
          }
          if (kb < kn) {
            const float* x0[kPair];
#pragma unroll
            for (int j = 0; j < kPair; ++j) x0[j] = X[j] + (kb0 + kb) * 8;
            head_step(x0, w + kb * step, hh, sml[h][0]);
            add_window(big[h], hh);
          }
        }
        ring.release();
      }
    }
    if (warp >= seg.tiles) continue;
    // fragment e: output column col0 + 16 w + g + 8 (e >> 1), query
    // 2 t + (e & 1) of block j
#pragma unroll
    for (int j = 0; j < kPair; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = seg.col0 + 16 * warp + g + 8 * (e >> 1);
        const int q = 2 * t + (e & 1);
        const float after =
            big[0][j][e] + (sml[0][0][j][e] + sml[0][1][j][e]);
        const float skip = big[1][j][e] + (sml[1][0][j][e] + sml[1][1][j][e]);
        if (q < outs[j].valid && o < d.co)
          outs[j].out[(size_t)q * d.co + o] =
              fmaxf(after + __ldg(p.baf + o), 0.f) +
              fmaxf(skip + __ldg(p.bsk + o), 0.f);
      }
    }
  }
}

// One query's pooling on the tensor cores (3xTF32), by the calling warp:
// dst[t c2 + c] = sum_j w[j k + t] h[j ldh + c] for t < k, c < c2, with w
// the query's k x k pooling weights and h its k rows of h1 (zero past c2
// up to up8(c2)).  m16 runs over t, n8 over c, k8 over j; each tile's
// k8 blocks are one window of the tensor cores' sums.
__device__ __forceinline__ void pool_query(const float* w, int k,
                                           const float* h, int ldh, int c2,
                                           float* dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kbs = (k + 7) / 8, mts = (k + 15) / 16, nts = (c2 + 7) / 8;
  for (int mt = 0; mt < mts; ++mt) {
    const int m0 = 16 * mt + g, m1 = m0 + 8;
    for (int n0 = 0; n0 < nts; n0 += 16) {
      float s[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      for (int kb = 0; kb < kbs; ++kb) {
        const int j0 = 8 * kb + t, j1 = j0 + 4;
        uint32_t ah[4], al[4];
        split(j0 < k && m0 < k ? w[j0 * k + m0] : 0.f, ah[0], al[0]);
        split(j0 < k && m1 < k ? w[j0 * k + m1] : 0.f, ah[1], al[1]);
        split(j1 < k && m0 < k ? w[j1 * k + m0] : 0.f, ah[2], al[2]);
        split(j1 < k && m1 < k ? w[j1 * k + m1] : 0.f, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (n0 + j >= nts) break;
          const int c = 8 * (n0 + j) + g;
          uint32_t bh[2], bl[2];
          split(j0 < k ? h[j0 * ldh + c] : 0.f, bh[0], bl[0]);
          split(j1 < k ? h[j1 * ldh + c] : 0.f, bh[1], bl[1]);
          mma(s[j], al, bh[0], bh[1]);
          mma(s[j], ah, bl[0], bl[1]);
          mma(s[j], ah, bh[0], bh[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n0 + j >= nts) break;
        const int c = 8 * (n0 + j) + 2 * t;
        if (m0 < k && c < c2) dst[m0 * c2 + c] = s[j][0];
        if (m0 < k && c + 1 < c2) dst[m0 * c2 + c + 1] = s[j][1];
        if (m1 < k && c < c2) dst[m1 * c2 + c] = s[j][2];
        if (m1 < k && c + 1 < c2) dst[m1 * c2 + c + 1] = s[j][3];
      }
    }
  }
}

// Tile `tile` of the grid: its cloud, first query and real queries (0
// past the last tile).
struct TilePos {
  long long cloud;
  int q0, valid;
};

__device__ inline TilePos tile_pos(long long tile, long long tiles_total,
                                   int n, int T) {
  TilePos t{0, 0, 0};
  if (tile < tiles_total) {
    const int tiles = (n + T - 1) / T;
    t.cloud = tile / tiles;
    t.q0 = (int)(tile - t.cloud * tiles) * T;
    t.valid = min(T, n - t.q0);
  }
  return t;
}

// The local and skip branches of T queries whose grouped rows the caller
// has written to the start of work, region A (stride ld(cf); rows of
// queries past the tile's real ones and rows past T k up to R32 zeroed,
// columns past cf up to up8(cf) zero) and synchronized.  The other block
// of the cluster does the same for its tile; then each block writes its
// slice of the output columns for both tiles' queries (outs[j]: block
// j's).  Every compute
// thread of both blocks must call it, with the ring from ring_start; the
// producer warp arrives on the cluster barrier it holds after the pooling.
__device__ __forceinline__ void tile_mlp(float* work, int T, const Dims& d,
                                         const Params& p,
                                         const TileOut (&outs)[kPair],
                                         Ring& ring) {
  const int k = d.k, cf = d.cf, c2 = d.c2;
  const int R = T * k, R32 = rows32(T, k);
  float* regA = work;
  float* regB = regA + region_a_floats(T, d);
  float* wts = regB + region_b_floats(T, d);
  float* gmax = wts + wts_floats(T, d);
  const int ldg = ld(cf), ldh0 = ld(d.c1), ldh1 = ld(c2);
  const int kc = k * c2, ldp = ld(kc);

  // the pooling weights: the weight net on the centred xyz (lanes 0..2)
  for (int e = threadIdx.x; e < R * k; e += kCompute) {
    const int r = e / k, t = e - r * k;
    const float* gr = regA + (size_t)r * ldg;
    float s = fmaf(gr[0], __ldg(p.ww + t), 0.f);
    s = fmaf(gr[1], __ldg(p.ww + k + t), s);
    s = fmaf(gr[2], __ldg(p.ww + 2 * k + t), s);
    wts[e] = fmaxf(s + __ldg(p.bw + t), 0.f);
  }
  // the skip branch's max over each query's k rows; zero past cf and T
  for (int e = threadIdx.x; e < 8 * ldg; e += kCompute) {
    const int q = e / ldg, c = e - q * ldg;
    float m = 0.f;
    if (q < T && c < cf) {
      const float* gr = regA + (size_t)q * k * ldg + c;
      m = gr[0];
      for (int j = 1; j < k; ++j) m = fmaxf(m, gr[j * ldg]);
    }
    gmax[e] = m;
  }
  const int np0 = passes(d.c1, kConvCols), np1 = passes(c2, kConvCols);
  conv(regA, ldg, R32, p.b0, regB, ldh0, d, 0, np0, ring);
  compute_sync();
  conv(regB, ldh0, R32, p.b1, regA, ldh1, d, np0, np1, ring);
  compute_sync();
  // pool[q, t c2 + c] into region B (h0 is spent), 8 rows, zero past T
  // and from k c2 up to up8(k c2): query q is warp q's
  float* pool = regB;
  const int warp = threadIdx.x >> 5;
  if (warp < T) {
    pool_query(wts + (size_t)warp * k * k, k, regA + (size_t)warp * k * ldh1,
               ldh1, c2, pool + (size_t)warp * ldp);
  } else {
    for (int e = threadIdx.x & 31; e < kc; e += 32)
      pool[(size_t)warp * ldp + e] = 0.f;
  }
  for (int e = threadIdx.x; e < 8 * (up8(kc) - kc); e += kCompute) {
    const int q = e / (up8(kc) - kc);
    pool[(size_t)q * ldp + kc + (e - q * (up8(kc) - kc))] = 0.f;
  }
  compute_sync();
  // the other block's pool into region A (h1 is spent) and its skip max
  // beside this one's, read from its shared memory once both are done
  cluster_sync();
  const int peer = ring.rank ^ 1;
  float* gmax_peer = gmax + 8 * ldg;
  {
    const float4* src = reinterpret_cast<const float4*>(peer_ptr(pool, peer));
    float4* dst = reinterpret_cast<float4*>(regA);
    for (int e = threadIdx.x; e < 2 * ldp; e += kCompute) dst[e] = src[e];
    src = reinterpret_cast<const float4*>(peer_ptr(gmax, peer));
    dst = reinterpret_cast<float4*>(gmax_peer);
    for (int e = threadIdx.x; e < 2 * ldg; e += kCompute) dst[e] = src[e];
  }
  compute_sync();
  const bool first = ring.rank % kPair == 0;
  const float* const pools[kPair] = {first ? pool : regA,
                                     first ? regA : pool};
  const float* const gmaxs[kPair] = {first ? gmax : gmax_peer,
                                     first ? gmax_peer : gmax};
  heads(pools, ldp, gmaxs, ldg, outs, d, p, np0 + np1, ring.rank, ring);
}

// ------------------------------------------------------------ the launch

// Launch kernel over `tiles` tiles (grid rounded up to whole clusters of
// kCluster blocks), or return the error: the attribute, the occupancy
// query (no cluster of this shared memory fits: cudaErrorInvalidValue) or
// the launch.
template <typename... Exp, typename... Act>
inline int launch_clusters(void (*kernel)(Exp...), long long tiles,
                           size_t smem, cudaStream_t stream, Act&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (tiles + kCluster - 1) / kCluster * kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace refine_common
