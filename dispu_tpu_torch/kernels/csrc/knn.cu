// Exact k-nearest-neighbour selection by squared euclidean distance, and
// its packed-key (turbo) variant.
//
// Replaces knn_pallas (dispu_tpu/ops/pallas_kernels.py, forward only), its
// exact variants and variant="packed".  For each query row it forms
// max(q2 - 2 q.p + p2, 0) + bias[j] over every dataset point j (the
// distance code of knn_common.cuh, shared with knn_group.cu).
//
// Exact (knn_stream_kernel for k <= 32, the radix form beyond): the k
// smallest in lexicographic (distance, index) order, ascending: equal
// distances go to the lower index, as lax.top_k and the Pallas lane order
// do.  A bias of 1e30 pushes padding and duplicate columns last.  A +inf or
// NaN distance is never selected; a slot left unfilled reports (+inf,
// INT_MAX).
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
// shape), and the selection's compares and insertions.  A row form that
// gives each query one warp, reading the whole cloud again with lanes c
// floats apart (32 sectors for 128 useful bytes at c = 48) and making k
// passes over the row, took 7.8 ms, 160x the bound, at pass 2's c = 48
// shape on an H100 80GB HBM3 at 700 W.  Design: knn_common.cuh's tiled
// form (stream_topk): a block of 4 warps takes 32 queries of one cloud and
// streams the cloud through shared memory in coalesced tiles of 128
// points, each lane a register tile of 8 queries x 4 points, and each
// query's k best stay sorted in its warp's registers, so the row never
// goes to shared memory and n is not limited.  The packed selection at
// k <= 32 (pass 2's refiner of a 16x turbo request, 32 x 4096 queries over
// 4096 points, k 16) is the same stream over its int keys (knn_common.cuh's
// PackedOrder), formed where the tile's distance is; the row form took 6.3
// ms there.  Packed past k = 32 (no caller; the JAX gate admits k <= 128):
// knn_common.cuh's row form, one warp per query row, its n keys in shared
// memory, k rounds of a strided pass and a butterfly (n + c <= 58,112).
//
// Exact, k > 32: the radix form.  Its callers: the patch cut of every
// whole-cloud request (k = patch_num_point = 256 over the cloud, 24
// queries at 2,048 points, 703 at 60,000; k 512 under 'megafused' at patch
// 512), the GCN backbone's k 48 graph (28 x 256 rows of 256 points).  The
// row form it replaces kept each row in one warp's shared memory and took
// k serial rounds over it (n k / 32 steps a lane), and past the row's n
// ran over chunks of the row and merged the chunks' candidates: 0.2325 ms
// at the 2,048-point cut and 3.982 ms at the 60,000-point one, against
// 1.179 for cdist + topk (H100 80GB HBM3, 700 W).  Bound: reading the
// cloud and writing the k pairs (2.21e-5 ms at the 2,048-point cut), or
// the distances' FMAs, b m n (2 c + 4) operations (6.30e-3 ms at the
// 60,000-point cut): microseconds.  What the radix form costs instead is
// a few block-wide passes over each row, each a handful of barriers, and
// at the 60,000-point cut two passes over the cloud from L2 a row.
//
// Design.  The lexicographic k smallest (distance, index) pairs are the
// k smallest of one integer per entry, the composite (key << jb) | j with
// jb = bit_length(n - 1): key is the distance's bits made order-preserving
// as an unsigned int (radix_key: -0.0 read as +0.0, which compare equal;
// negative distances, from a negative bias, flipped), so the composite's
// integer order is the (distance, index) order and no two entries share
// one.  One block a query row finds the k-th smallest composite digit by
// digit, 8 bits a pass from the top: a pass builds a 256-bin histogram in
// shared memory over the entries that share the prefix resolved so far
// (an atomic an entry), and one warp's scan finds the digit that holds
// the k-th.  The descent stops as soon as every entry
// that shares the prefix is taken (count == need): where the k-th distance
// is unique that is after the distance's bits (two or three passes), and a
// tie at the k-th, however wide (a block of 1e30-biased columns, a
// repeated point), costs a pass or two over the index's bits, never a
// buffer sized by the tie.  Then every entry at or below the prefix is
// taken, exactly min(k, the selectable entries), and a bitonic sort of
// those (d, j) pairs by (key, j), padded virtually to a power of two (the
// comparators past the count are skipped; stages spanning at most 64
// entries meet at __syncwarp), gives the ascending order.  Slots past the
// selectable entries report (+inf, INT_MAX).  With knn_common.cuh's
// distance code the result is the row form's, bit for bit.
//
// Two regimes (kernels/knn.py:knn_form picks by shape, radix_plan sizes
// them).  'row', knn_radix_row_kernel: the row's n distances in shared
// memory beside a 272-word head and the query (it takes n + c <= 57,840;
// the gate gives it n <= 4,096), the block sized to the row (two warps at
// 256 points); each pass sweeps shared memory.  'split',
// knn_radix_cloud_kernel (LAUNCHES["knn_split"]), past 4,096 points, where
// it measured no slower (dispu_tpu_torch/time_knn_forms.py --regimes):
// each pass recomputes the distances from the cloud, which stays in L2
// (60,000 x 12 bytes), until the tied group fits a buffer of cap pairs in
// shared memory; the pass that collects the entries below it
// takes the group into the buffer, and the remaining passes run there.
// Usually two passes over the cloud, each lane reading kCloudSteps points
// a step with their loads issued together.  It needs no device scratch and
// no merge, so n is limited only by int32 indices.  In both, the k pairs
// sort in shared memory where they fit beside the rest, else in place in
// the output rows.  The alternatives measured beside it are
// dispu_tpu_torch/time_knn_forms.py's RADIX_VARIANTS (--radix).

#include "knn_common.cuh"

namespace {

using namespace knn_common;

// ------------------------------------------------------------ radix form

constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
// words ahead of the query: the histogram, then control words (ctl[0..3]
// a pass's digit, count below it, its count, the total; ctl[4], ctl[5]
// the collected and the buffered counts)
constexpr int kRadixHead = kBins + 16;
constexpr int kRadixMaxThreads = 1024;
constexpr int kWarpSpan = 64;  // entries a warp's 32 comparators span
// 'split': points a lane a step (one: 0.358 ms against 0.341 at the
// 60,000-point cut)
constexpr int kCloudSteps = 4;

// The distance's bits as an unsigned int in float order: -0.0 as +0.0,
// negatives flipped whole, non-negatives with the sign bit set.
__device__ __forceinline__ unsigned radix_key(float d) {
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// false for +inf and NaN, which the row form never selects
__device__ __forceinline__ bool selectable(float d) {
  return d < __int_as_float(0x7f800000);
}

__device__ __forceinline__ bool pair_less(float da, int ja, float db,
                                          int jb) {
  const unsigned ka = radix_key(da), kb = radix_key(db);
  return ka < kb || (ka == kb && ja < jb);
}

// How a radix kernel reads a point: kC3, c = 3 as a constant (the xyz of
// every patch cut), the loop unrolled; kC4, c % 4 == 0 with the cloud
// 16-byte aligned, four coordinates a load (lanes read points c floats
// apart: a quarter of the loads; 0.066 against 0.094 ms at the GCN graph's
// c = 24, and kC3 0.341 against 0.438 at the 60,000-point cut,
// dispu_tpu_torch/time_knn_forms.py --radix); kAnyC, one at a time.
enum PointRead { kAnyC, kC3, kC4 };

// knn_common.cuh's point_distance, read as kRead says: the same fmaf chain
// in the same order, so the same bits.
template <int kRead>
__device__ __forceinline__ float radix_distance(const float* q, float q2,
                                                const float* __restrict__ p,
                                                float bj, int c) {
  if constexpr (kRead == kAnyC) return point_distance(q, q2, p, bj, c);
  if constexpr (kRead == kC3) return point_distance(q, q2, p, bj, 3);
  float qp = 0.f, p2 = 0.f;
  for (int t = 0; t < c; t += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + t);
    qp = fmaf(q[t], v.x, qp);
    p2 = fmaf(v.x, v.x, p2);
    qp = fmaf(q[t + 1], v.y, qp);
    p2 = fmaf(v.y, v.y, p2);
    qp = fmaf(q[t + 2], v.z, qp);
    p2 = fmaf(v.z, v.z, p2);
    qp = fmaf(q[t + 3], v.w, qp);
    p2 = fmaf(v.w, v.w, p2);
  }
  const float e = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, qp)), p2);
  return __fadd_rn(fmaxf(e, 0.f), bj);
}

inline PointRead point_read(const float* points, int c) {
  if (c == 3) return kC3;
  return c % 4 == 0 && (reinterpret_cast<size_t>(points) & 15) == 0 ? kC4
                                                                   : kAnyC;
}

// The kernel instantiated for ``read``.
template <class Kernel>
Kernel pick_read(PointRead read, Kernel any, Kernel c3, Kernel c4) {
  return read == kC3 ? c3 : read == kC4 ? c4 : any;
}

// The descent's state, the same in every thread: the composites' top
// ``resolved`` bits equal to ``prefix`` make the tied group, ``count``
// entries, of which the ``need`` smallest are taken; every selectable
// entry with a smaller prefix is taken.
struct RadixSel {
  unsigned long long prefix;
  int resolved;
  int need;
  int count;
};

struct RadixBlock {
  unsigned* hist;
  int* ctl;
  int jb, total;  // total = 32 + jb composite bits
  int tid, threads, lane;
};

// The top ``bits`` bits (0 .. r.total) of the composite of entry (d, j),
// (radix_key(d) << jb) | j, which has r.total <= 63 bits.
__device__ __forceinline__ unsigned long long comp_top(const RadixBlock& r,
                                                       unsigned key, int j,
                                                       int bits) {
  return (((unsigned long long)key << r.jb) | (unsigned)j) >>
         (r.total - bits);
}

// hist[bin] += 1 for each lane with ``take``: an atomic each (one a bin a
// warp, by __match_any_sync, took 0.376 ms against 0.341 at the
// 60,000-point cut, dispu_tpu_torch/time_knn_forms.py --radix).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin,
                                         bool take) {
  if (take) atomicAdd(&hist[bin], 1u);
}

// A slot in a buffer for each lane with ``take``, from the shared
// ``counter``; one atomic a warp, none where no lane takes.
__device__ __forceinline__ int warp_append(int* counter, bool take,
                                           int lane) {
  const unsigned mask = __ballot_sync(kFull, take);
  if (mask == 0u) return 0;
  int base = 0;
  if (lane == 0) base = atomicAdd(counter, __popc(mask));
  base = __shfl_sync(kFull, base, 0);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// Warp 0: the digit that holds the need-th smallest entry of the
// histogram (ctl[0]), the entries below it (ctl[1]) and in it (ctl[2]),
// and the histogram's total (ctl[3]).  Lane l reads bins 8 l .. 8 l + 7.
__device__ __forceinline__ void radix_scan(const unsigned* hist, int need,
                                           int* ctl, int lane) {
  const uint4 a = reinterpret_cast<const uint4*>(hist)[2 * lane];
  const uint4 b = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
  const int v[8] = {(int)a.x, (int)a.y, (int)a.z, (int)a.w,
                    (int)b.x, (int)b.y, (int)b.z, (int)b.w};
  int own = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) own += v[i];
  int incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  const int excl = incl - own;
  if (lane == 31) ctl[3] = incl;
  if (excl < need && need <= incl) {
    int cum = excl;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (cum + v[i] >= need) {
        ctl[0] = 8 * lane + i;
        ctl[1] = cum;
        ctl[2] = v[i];
        break;
      }
      cum += v[i];
    }
  }
}

// One digit pass over the entries that ``visit`` presents: visit(f) calls
// f(active, d, j) for every entry, the same number of times in every lane
// of a warp.  Must be called by every thread of the block.
template <class Visit>
__device__ __forceinline__ void radix_pass(const RadixBlock& r, RadixSel& s,
                                           Visit visit) {
  const int w = min(kRadixBits, r.total - s.resolved);
  for (int i = r.tid; i < kBins; i += r.threads) r.hist[i] = 0u;
  __syncthreads();
  visit([&](bool active, float d, int j) {
    bool take = active && selectable(d);
    unsigned bin = 0u;
    if (take) {
      const unsigned key = radix_key(d);
      take = comp_top(r, key, j, s.resolved) == s.prefix;
      bin = (unsigned)comp_top(r, key, j, s.resolved + w) & ((1u << w) - 1u);
    }
    hist_add(r.hist, bin, take);
  });
  __syncthreads();
  if (r.tid < 32) radix_scan(r.hist, s.need, r.ctl, r.lane);
  __syncthreads();
  const int total = r.ctl[3];
  if (total <= s.need) {  // the first pass, with at most k selectable
    s.need = s.count = total;
  } else {
    s.prefix = (s.prefix << w) | (unsigned)r.ctl[0];
    s.need -= r.ctl[1];
    s.count = r.ctl[2];
    s.resolved += w;
  }
}

// Appends each entry below the prefix, and with ``all`` each of the tied
// group, to (od, oj) at ctl[4]; without ``all`` the tied group goes to
// (cd, cj) at ctl[5].  Must be called by every thread of the block.
template <class Visit>
__device__ __forceinline__ void radix_collect(const RadixBlock& r,
                                              const RadixSel& s, bool all,
                                              Visit visit, float* od,
                                              int* oj, float* cd, int* cj) {
  visit([&](bool active, float d, int j) {
    bool out = false, tie = false;
    if (active && selectable(d)) {
      const unsigned long long p = comp_top(r, radix_key(d), j, s.resolved);
      out = p < s.prefix || (all && p == s.prefix);
      tie = !all && p == s.prefix;
    }
    const int po = warp_append(&r.ctl[4], out, r.lane);
    if (out) {
      od[po] = d;
      oj[po] = j;
    }
    if (!all) {
      const int pc = warp_append(&r.ctl[5], tie, r.lane);
      if (tie) {
        cd[pc] = d;
        cj[pc] = j;
      }
    }
  });
}

__device__ __forceinline__ void compare_swap(float* d, int* j, int a,
                                             int b) {
  const float da = d[a], db = d[b];
  const int ja = j[a], jb = j[b];
  if (pair_less(db, jb, da, ja)) {
    d[a] = db;
    d[b] = da;
    j[a] = jb;
    j[b] = ja;
  }
}

// Ascending bitonic sort of cnt (d, j) pairs by (key, j), in place, in
// shared or device memory; the padding to a power of two is virtual (a
// comparator reaching past cnt would keep +inf in place, so it is
// skipped).  Pair i of a stage belongs to warp (i / 32) % warps in every
// stage, so stages whose comparators span at most kWarpSpan entries meet
// at __syncwarp.  Must be called by every thread; ends with a barrier.
__device__ void radix_sort(float* d, int* j, int cnt, int tid, int threads) {
  int N = 1;
  while (N < cnt) N <<= 1;
  const int pairs = N >> 1;
  int last = 0;  // span of the previous stage
  auto barrier = [&](int span) {
    if (last <= kWarpSpan && span <= kWarpSpan)
      __syncwarp();
    else
      __syncthreads();
    last = span;
  };
  for (int size = 2; size <= N; size <<= 1) {
    const int lh = __ffs(size) - 2;  // log2(size / 2)
    barrier(size);
    for (int i = tid; i < pairs; i += threads) {
      const int base = (i >> lh) * size, off = i & ((size >> 1) - 1);
      const int b = base + size - 1 - off;
      if (b < cnt) compare_swap(d, j, base + off, b);
    }
    for (int h = size >> 2; h > 0; h >>= 1) {
      const int lg = __ffs(h) - 1;
      barrier(2 * h);
      for (int i = tid; i < pairs; i += threads) {
        const int a = ((i >> lg) << (lg + 1)) + (i & (h - 1));
        if (a + h < cnt) compare_swap(d, j, a, a + h);
      }
    }
  }
  __syncthreads();
}

// The row's k slots from the sorted pairs; past cnt, (+inf, INT_MAX).
__device__ __forceinline__ void radix_write(const float* od, const int* oj,
                                            int cnt, int k, float* drow,
                                            int* irow, bool copy, int tid,
                                            int threads) {
  for (int r = tid; r < k; r += threads) {
    if (r >= cnt) {
      drow[r] = __int_as_float(0x7f800000);
      irow[r] = INT_MAX;
    } else if (copy) {
      drow[r] = od[r];
      irow[r] = oj[r];
    }
  }
}

// 'row': one block a query row, the row's n distances in shared memory.
// A null bias adds +0.f, as a zero bias does.  Dynamic shared memory: kRadixHead words, the query (c), the row (n),
// then with out_smem the k pairs.
template <int kRead>
__global__ void __launch_bounds__(kRadixMaxThreads)
    knn_radix_row_kernel(const float* __restrict__ points,
                         const float* __restrict__ queries,
                         const float* __restrict__ bias,
                         float* __restrict__ dists, int* __restrict__ idx,
                         int n, int m, int c, int k, int jb, int out_smem) {
  extern __shared__ __align__(16) unsigned radix_smem_words[];
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid & 31;
  const long long row = blockIdx.x;
  const long long cloud = row / m;
  float* q = reinterpret_cast<float*>(radix_smem_words + kRadixHead);
  float* d = q + c;
  for (int t = tid; t < c; t += threads) q[t] = queries[row * c + t];
  __syncthreads();
  const float q2 = query_sq(q, c);
  const float* pts = points + (size_t)cloud * n * c;
  const float* bs = bias ? bias + (size_t)cloud * n : nullptr;
  for (int j = tid; j < n; j += threads)
    d[j] = radix_distance<kRead>(q, q2, pts + (size_t)j * c,
                                 bs ? bs[j] : 0.f, c);

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  float* od = out_smem ? d + n : drow;
  int* oj = out_smem ? reinterpret_cast<int*>(d + n + k) : irow;
  const RadixBlock r{radix_smem_words, reinterpret_cast<int*>(
                         radix_smem_words + kBins), jb, 32 + jb, tid,
                     threads, lane};
  auto visit = [&](auto f) {
    for (int j0 = tid - lane; j0 < n; j0 += threads) {
      const int j = j0 + lane;
      const bool active = j < n;
      f(active, active ? d[j] : 0.f, j);
    }
  };
  RadixSel s{0ull, 0, k, 0};
  do radix_pass(r, s, visit);
  while (s.count != s.need);
  if (tid == 0) r.ctl[4] = 0;
  __syncthreads();
  radix_collect(r, s, true, visit, od, oj, nullptr, nullptr);
  __syncthreads();
  const int cnt = r.ctl[4];
  radix_sort(od, oj, cnt, tid, threads);
  radix_write(od, oj, cnt, k, drow, irow, out_smem, tid, threads);
}

// 'split': one block a query row, the distances recomputed from the cloud
// each pass until the tied group fits cap pairs in shared memory.
// Dynamic shared memory: kRadixHead words, the query (c), the buffer (cap
// distances, cap indices), then with out_smem the k pairs.
template <int kRead>
__global__ void __launch_bounds__(kRadixMaxThreads)
    knn_radix_cloud_kernel(const float* __restrict__ points,
                           const float* __restrict__ queries,
                           const float* __restrict__ bias,
                           float* __restrict__ dists, int* __restrict__ idx,
                           int n, int m, int c, int k, int jb, int cap,
                           int out_smem) {
  extern __shared__ __align__(16) unsigned radix_smem_words[];
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid & 31;
  const long long row = blockIdx.x;
  const long long cloud = row / m;
  float* q = reinterpret_cast<float*>(radix_smem_words + kRadixHead);
  float* cd = q + c;
  int* cj = reinterpret_cast<int*>(cd + cap);
  for (int t = tid; t < c; t += threads) q[t] = queries[row * c + t];
  __syncthreads();
  const float q2 = query_sq(q, c);
  const float* pts = points + (size_t)cloud * n * c;
  const float* bs = bias ? bias + (size_t)cloud * n : nullptr;

  float* drow = dists + row * k;
  int* irow = idx + row * k;
  float* od = out_smem ? reinterpret_cast<float*>(cj + cap) : drow;
  int* oj = out_smem ? reinterpret_cast<int*>(od + k) : irow;
  const RadixBlock r{radix_smem_words, reinterpret_cast<int*>(
                         radix_smem_words + kBins), jb, 32 + jb, tid,
                     threads, lane};
  // kCloudSteps points a lane a step, their loads issued together
  auto cloud_visit = [&](auto f) {
    for (unsigned j0 = tid - lane; j0 < (unsigned)n;
         j0 += kCloudSteps * threads) {
      float dd[kCloudSteps];
      unsigned jj[kCloudSteps];
#pragma unroll
      for (int u = 0; u < kCloudSteps; ++u) {
        jj[u] = j0 + u * threads + lane;
        dd[u] = jj[u] < (unsigned)n
                    ? radix_distance<kRead>(q, q2, pts + (size_t)jj[u] * c,
                                            bs ? bs[jj[u]] : 0.f, c)
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kCloudSteps; ++u)
        f(jj[u] < (unsigned)n, dd[u], (int)jj[u]);
    }
  };
  RadixSel s{0ull, 0, k, 0};
  do radix_pass(r, s, cloud_visit);
  while (s.count != s.need && s.count > cap);
  const bool done = s.count == s.need;
  if (tid == 0) r.ctl[4] = r.ctl[5] = 0;
  __syncthreads();
  radix_collect(r, s, done, cloud_visit, od, oj, cd, cj);
  __syncthreads();
  if (!done) {
    const int held = r.ctl[5];
    auto held_visit = [&](auto f) {
      for (int i0 = tid - lane; i0 < held; i0 += threads) {
        const int i = i0 + lane;
        const bool active = i < held;
        f(active, active ? cd[i] : 0.f, active ? cj[i] : 0);
      }
    };
    do radix_pass(r, s, held_visit);
    while (s.count != s.need);
    radix_collect(r, s, true, held_visit, od, oj, nullptr, nullptr);
    __syncthreads();
  }
  const int cnt = r.ctl[4];
  radix_sort(od, oj, cnt, tid, threads);
  radix_write(od, oj, cnt, k, drow, irow, out_smem, tid, threads);
}

// Dynamic shared memory of the radix form, in bytes, for a row of
// row_words words (the 'row' regime's n distances, the 'split' regime's
// 2 cap), and whether the k pairs fit beside it; 0 when the row does not
// fit.  kernels/knn.py:radix_smem is the same formula.
inline size_t radix_smem(long long row_words, int c, int k, int& out_smem) {
  const long long base = (long long)kRadixHead + c + row_words;
  out_smem = 0;
  if (base * 4 > (long long)kMaxSmem) return 0;
  if ((base + 2LL * k) * 4 <= (long long)kMaxSmem) {
    out_smem = 1;
    return (size_t)(base + 2LL * k) * 4;
  }
  return (size_t)base * 4;
}

inline int index_bits(int n) {
  int jb = 0;
  while (jb < 31 && (1LL << jb) < n) ++jb;
  return jb;
}

inline bool radix_threads_ok(int threads) {
  return threads >= 32 && threads <= kRadixMaxThreads && threads % 32 == 0;
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

// threads: the radix form's block (k > kStreamK), kernels/knn.py's
// radix_threads; the tiled form ignores it.  bias may be null past
// kStreamK only.
extern "C" int dispu_knn(const float* points, const float* queries,
                         const float* bias, float* dists, int* idx, int b,
                         int n, int m, int c, int k, int threads,
                         void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n ||
      (bias == nullptr && k <= kStreamK))
    return (int)cudaErrorInvalidValue;
  if (k <= kStreamK) {
    knn_stream_kernel<<<tile_blocks(b, m), kTileThreads, 0,
                        (cudaStream_t)stream>>>(points, queries, bias, dists,
                                                idx, n, m, c, k);
    return (int)cudaGetLastError();
  }
  int out_smem;
  const size_t smem = radix_smem(n, c, k, out_smem);
  const long long rows = (long long)b * m;
  if (smem == 0 || !radix_threads_ok(threads) || rows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto kernel = pick_read(
      point_read(points, c), knn_radix_row_kernel<kAnyC>,
      knn_radix_row_kernel<kC3>, knn_radix_row_kernel<kC4>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, n, m, c, k, index_bits(n),
      out_smem);
  return (int)cudaGetLastError();
}

// The exact selection for k > kStreamK at any n: the radix form's 'split'
// regime, the distances recomputed each pass, a buffer of cap pairs.
extern "C" int dispu_knn_split(const float* points, const float* queries,
                               const float* bias, float* dists, int* idx,
                               int b, int n, int m, int c, int k,
                               int threads, int cap, void* stream) {
  if (b < 1 || m < 1 || c < 1 || k < 1 || k > n || cap < 1)
    return (int)cudaErrorInvalidValue;  // bias may be null
  int out_smem;
  const size_t smem = radix_smem(2LL * cap, c, k, out_smem);
  const long long rows = (long long)b * m;
  if (smem == 0 || !radix_threads_ok(threads) || rows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const auto kernel = pick_read(
      point_read(points, c), knn_radix_cloud_kernel<kAnyC>,
      knn_radix_cloud_kernel<kC3>, knn_radix_cloud_kernel<kC4>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      points, queries, bias, dists, idx, n, m, c, k, index_bits(n), cap,
      out_smem);
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
