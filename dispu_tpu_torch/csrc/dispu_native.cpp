// dispu_native — host-side native library, the port's own copy of
// native/dispu_native.cpp (the code below the header is that file's).
//
// C++ counterparts of the reference's non-TF native components, written
// from scratch (no vendored nanoflann/CGAL):
//   * knn_batch          — exact KD-tree kNN      (ref: libs/nearest_neighbors, N10)
//   * grid_subsample     — voxel-grid barycenters (ref: libs/cpp_wrappers,      N11)
//   * render_points      — z-buffer ball splatter (ref: tf_ops/renderball,      N12)
//   * point_to_mesh      — exact point-triangle distances, multithreaded
//                          (ref: evaluation_code/evaluation.cpp,               N13)
//
// The device path never calls it: it serves host-side tooling (CPU data
// preprocessing, offline evaluation) and independent checks of the device
// ops.  Exposed via extern "C" for ctypes.
//
// Build: dispu_tpu_torch/native.py compiles it with g++ at first use
// (native/Makefile's flags) into dispu_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ----------------------------------------------------------------- KD-tree

struct KDNode {
  int32_t left = -1, right = -1;  // children, -1 = leaf
  int32_t begin = 0, end = 0;     // point range for leaves
  int axis = 0;
  float split = 0.f;
};

class KDTree3 {
 public:
  KDTree3(const float* pts, int n, int leaf_size = 16)
      : pts_(pts), idx_(n), leaf_size_(leaf_size) {
    for (int i = 0; i < n; ++i) idx_[i] = i;
    nodes_.reserve(2 * n / leaf_size + 4);
    root_ = build(0, n);
  }

  // k nearest neighbors of q (indices ascending by distance).
  void query(const float* q, int k, int32_t* out_idx, float* out_d2) const {
    // max-heap of (dist2, index)
    std::priority_queue<std::pair<float, int32_t>> heap;
    search(root_, q, k, heap);
    int cnt = static_cast<int>(heap.size());
    for (int i = cnt - 1; i >= 0; --i) {
      out_idx[i] = heap.top().second;
      if (out_d2) out_d2[i] = heap.top().first;
      heap.pop();
    }
    // pad (fewer points than k) by repeating the last found
    for (int i = cnt; i < k; ++i) {
      out_idx[i] = cnt ? out_idx[cnt - 1] : 0;
      if (out_d2) out_d2[i] = cnt ? out_d2[cnt - 1] : 0.f;
    }
  }

 private:
  int32_t build(int begin, int end) {
    KDNode node;
    node.begin = begin;
    node.end = end;
    int32_t id = static_cast<int32_t>(nodes_.size());
    nodes_.push_back(node);
    if (end - begin <= leaf_size_) return id;

    // widest axis
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = begin; i < end; ++i) {
      const float* p = pts_ + 3 * idx_[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;

    int mid = (begin + end) / 2;
    std::nth_element(
        idx_.begin() + begin, idx_.begin() + mid, idx_.begin() + end,
        [&](int32_t a, int32_t b) {
          return pts_[3 * a + axis] < pts_[3 * b + axis];
        });
    float split = pts_[3 * idx_[mid] + axis];

    int32_t l = build(begin, mid);
    int32_t r = build(mid, end);
    nodes_[id].left = l;
    nodes_[id].right = r;
    nodes_[id].axis = axis;
    nodes_[id].split = split;
    return id;
  }

  void search(int32_t id, const float* q, int k,
              std::priority_queue<std::pair<float, int32_t>>& heap) const {
    const KDNode& node = nodes_[id];
    if (node.left < 0) {  // leaf
      for (int i = node.begin; i < node.end; ++i) {
        const float* p = pts_ + 3 * idx_[i];
        float d2 = 0;
        for (int a = 0; a < 3; ++a) {
          float d = p[a] - q[a];
          d2 += d * d;
        }
        if ((int)heap.size() < k)
          heap.emplace(d2, idx_[i]);
        else if (d2 < heap.top().first) {
          heap.pop();
          heap.emplace(d2, idx_[i]);
        }
      }
      return;
    }
    float delta = q[node.axis] - node.split;
    int32_t near = delta <= 0 ? node.left : node.right;
    int32_t far = delta <= 0 ? node.right : node.left;
    search(near, q, k, heap);
    if ((int)heap.size() < k || delta * delta < heap.top().first)
      search(far, q, k, heap);
  }

  const float* pts_;
  std::vector<int32_t> idx_;
  std::vector<KDNode> nodes_;
  int leaf_size_;
  int32_t root_;
};

// -------------------------------------------------- point-triangle distance

inline float point_tri_d2(const float* p, const float* a, const float* b,
                          const float* c, float* nearest) {
  float ab[3], ac[3], ap[3];
  for (int i = 0; i < 3; ++i) {
    ab[i] = b[i] - a[i];
    ac[i] = c[i] - a[i];
    ap[i] = p[i] - a[i];
  }
  auto dot = [](const float* x, const float* y) {
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
  };
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  float out[3];
  auto finish = [&](const float* pt) {
    std::memcpy(nearest, pt, 3 * sizeof(float));
    float dd = 0;
    for (int i = 0; i < 3; ++i) {
      float d = p[i] - pt[i];
      dd += d * d;
    }
    return dd;
  };
  if (d1 <= 0 && d2 <= 0) return finish(a);

  float bp[3], cp[3];
  for (int i = 0; i < 3; ++i) {
    bp[i] = p[i] - b[i];
    cp[i] = p[i] - c[i];
  }
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return finish(b);

  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float t = d1 / (d1 - d3);
    for (int i = 0; i < 3; ++i) out[i] = a[i] + t * ab[i];
    return finish(out);
  }

  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return finish(c);

  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float t = d2 / (d2 - d6);
    for (int i = 0; i < 3; ++i) out[i] = a[i] + t * ac[i];
    return finish(out);
  }

  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    for (int i = 0; i < 3; ++i) out[i] = b[i] + t * (c[i] - b[i]);
    return finish(out);
  }

  float denom = 1.0f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  for (int i = 0; i < 3; ++i) out[i] = a[i] + v * ab[i] + w * ac[i];
  return finish(out);
}

}  // namespace

extern "C" {

// Exact batched kNN: support (b, n, 3), queries (b, m, 3) → idx (b, m, k).
// Distances optional (pass nullptr to skip).  Parity target:
// ref:libs/nearest_neighbors/knn_.cxx (nanoflann + OpenMP batch).
void dispu_knn_batch(const float* support, const float* queries, int b, int n,
                     int m, int k, int32_t* out_idx, float* out_d2) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int bi = 0; bi < b; ++bi) {
    KDTree3 tree(support + (size_t)bi * n * 3, n);
    for (int qi = 0; qi < m; ++qi) {
      tree.query(queries + ((size_t)bi * m + qi) * 3, k,
                 out_idx + ((size_t)bi * m + qi) * k,
                 out_d2 ? out_d2 + ((size_t)bi * m + qi) * k : nullptr);
    }
  }
}

// Single-cloud exact kNN, any dimensionality: points (n, dim), queries
// (m, dim) → idx (m, k) ascending by distance [, d2].  Parity target:
// ref:libs/nearest_neighbors/knn_.cxx:21-67 (cpp_knn / cpp_knn_omp) /
// knn.pyx:33-71.  dim==3 rides the KD-tree; other dims use an exact
// partial-selection scan (the reference's callers only ever pass dim=3).
void dispu_knn(const float* points, int n, int dim, const float* queries,
               int m, int k, int32_t* out_idx, float* out_d2) {
  if (dim == 3) {
    KDTree3 tree(points, n);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int qi = 0; qi < m; ++qi) {
      tree.query(queries + (size_t)qi * 3, k, out_idx + (size_t)qi * k,
                 out_d2 ? out_d2 + (size_t)qi * k : nullptr);
    }
    return;
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int qi = 0; qi < m; ++qi) {
    const float* q = queries + (size_t)qi * dim;
    std::priority_queue<std::pair<float, int32_t>> heap;  // max-heap
    for (int i = 0; i < n; ++i) {
      const float* p = points + (size_t)i * dim;
      float d2 = 0;
      for (int a = 0; a < dim; ++a) {
        float d = p[a] - q[a];
        d2 += d * d;
      }
      if ((int)heap.size() < k)
        heap.emplace(d2, i);
      else if (d2 < heap.top().first) {
        heap.pop();
        heap.emplace(d2, i);
      }
    }
    int cnt = (int)heap.size();
    for (int i = cnt - 1; i >= 0; --i) {
      out_idx[(size_t)qi * k + i] = heap.top().second;
      if (out_d2) out_d2[(size_t)qi * k + i] = heap.top().first;
      heap.pop();
    }
    for (int i = cnt; i < k; ++i) {
      out_idx[(size_t)qi * k + i] = cnt ? out_idx[(size_t)qi * k + cnt - 1] : 0;
      if (out_d2)
        out_d2[(size_t)qi * k + i] =
            cnt ? out_d2[(size_t)qi * k + cnt - 1] : 0.f;
    }
  }
}

// Coverage-balanced query picking + kNN ("distance pick"): per batch,
// repeatedly pick a random point among the LEAST-USED ones, take its k
// nearest neighbors, and bump usage counts (+1 per neighbor, +100 for the
// picked point) so later picks spread across the cloud.  Semantics match
// ref:libs/nearest_neighbors/knn_.cxx:138-203 / knn.pyx:115-148
// (cpp_knn_batch_distance_pick) with one deliberate change: the RNG is a
// caller-seeded mt19937 per batch element instead of a single
// time(0)-seeded stream (the reference's OpenMP variant even races that
// shared stream) — runs are reproducible and batch-order independent.
// Outputs: out_queries (b, m, dim) picked points, out_idx (b, m, k).
void dispu_knn_batch_distance_pick(const float* batch_data, int b, int n,
                                   int dim, int m, int k, uint64_t seed,
                                   float* out_queries, int32_t* out_idx) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int bid = 0; bid < b; ++bid) {
    const float* points = batch_data + (size_t)bid * n * dim;
    std::mt19937 rng((uint32_t)(seed + (uint64_t)bid * 0x9e3779b9u));
    KDTree3* tree = dim == 3 ? new KDTree3(points, n) : nullptr;
    std::vector<int> used(n, 0);
    std::vector<int32_t> ids(k);
    std::vector<size_t> possible;
    int current_id = 0;
    for (int ptid = 0; ptid < m; ++ptid) {
      possible.clear();
      while (possible.empty()) {
        for (int i = 0; i < n; ++i)
          if (used[i] == current_id) possible.push_back(i);
        if (possible.empty())
          current_id = *std::min_element(used.begin(), used.end());
      }
      size_t index = possible[rng() % possible.size()];
      const float* q = points + index * dim;
      if (tree) {
        tree->query(q, k, ids.data(), nullptr);
      } else {
        dispu_knn(points, n, dim, q, 1, k, ids.data(), nullptr);
      }
      for (int i = 0; i < k; ++i) used[ids[i]] += 1;
      used[index] += 100;
      for (int i = 0; i < k; ++i)
        out_idx[((size_t)bid * m + ptid) * k + i] = ids[i];
      for (int a = 0; a < dim; ++a)
        out_queries[((size_t)bid * m + ptid) * dim + a] = q[a];
    }
    delete tree;
  }
}

// Voxel-grid subsampling with barycenter + feature averaging.
// points (n, 3), features (n, fdim) or nullptr.  Returns count written
// (≤ max_out).  Output order follows first-touch voxel order, matching the
// insertion-ordered map semantics of ref:libs/cpp_wrappers/cpp_subsampling/
// grid_subsampling/grid_subsampling.cpp:5-106.
int dispu_grid_subsample(const float* points, const float* features, int n,
                         int fdim, float cell, float* out_points,
                         float* out_features, int max_out) {
  if (n <= 0 || cell <= 0) return 0;
  float lo[3] = {1e30f, 1e30f, 1e30f};
  for (int i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) lo[a] = std::min(lo[a], points[3 * i + a]);

  struct Acc {
    double p[3] = {0, 0, 0};
    std::vector<double> f;
    int count = 0;
  };
  std::unordered_map<uint64_t, int> voxel_slot;
  std::vector<Acc> accs;
  for (int i = 0; i < n; ++i) {
    const float* p = points + 3 * i;
    uint64_t kx = (uint64_t)((p[0] - lo[0]) / cell);
    uint64_t ky = (uint64_t)((p[1] - lo[1]) / cell);
    uint64_t kz = (uint64_t)((p[2] - lo[2]) / cell);
    uint64_t key = (kx << 42) | (ky << 21) | kz;
    auto it = voxel_slot.find(key);
    int slot;
    if (it == voxel_slot.end()) {
      slot = static_cast<int>(accs.size());
      voxel_slot.emplace(key, slot);
      accs.emplace_back();
      if (fdim > 0) accs[slot].f.assign(fdim, 0.0);
    } else {
      slot = it->second;
    }
    Acc& acc = accs[slot];
    for (int a = 0; a < 3; ++a) acc.p[a] += p[a];
    if (fdim > 0 && features)
      for (int fjs = 0; fjs < fdim; ++fjs)
        acc.f[fjs] += features[(size_t)i * fdim + fjs];
    acc.count += 1;
  }
  int out = std::min((int)accs.size(), max_out);
  for (int s = 0; s < out; ++s) {
    for (int a = 0; a < 3; ++a)
      out_points[3 * s + a] = (float)(accs[s].p[a] / accs[s].count);
    if (fdim > 0 && out_features)
      for (int fjs = 0; fjs < fdim; ++fjs)
        out_features[(size_t)s * fdim + fjs] =
            (float)(accs[s].f[fjs] / accs[s].count);
  }
  return out;
}

// Z-buffer ball splatter: points (n, 3) normalized to [-1, 1] → grayscale
// image (size, size).  Parity target: ref:tf_ops/renderball/
// render_balls_so.cpp (depth-shaded disks, nearest wins).
void dispu_render_points(const float* points, int n, int size, int radius,
                         float* out_img) {
  std::vector<float> zbuf((size_t)size * size,
                          -std::numeric_limits<float>::infinity());
  std::fill(out_img, out_img + (size_t)size * size, 0.f);
  float half = size / 2.0f;
  float scale = size / 2.2f;
  for (int i = 0; i < n; ++i) {
    const float* p = points + 3 * i;
    int cx = (int)(p[0] * scale + half);
    int cy = (int)(p[1] * scale + half);
    float z = p[2];
    for (int dy = -radius; dy <= radius; ++dy) {
      for (int dx = -radius; dx <= radius; ++dx) {
        if (dx * dx + dy * dy > radius * radius) continue;
        int x = cx + dx, y = cy + dy;
        if (x < 0 || x >= size || y < 0 || y >= size) continue;
        size_t pix = (size_t)y * size + x;
        if (z > zbuf[pix]) {
          zbuf[pix] = z;
          float shade =
              1.0f - 0.6f * std::sqrt((float)(dx * dx + dy * dy)) / radius;
          out_img[pix] = std::max(0.2f, shade) * (0.5f + 0.5f * (z + 1) / 2);
        }
      }
    }
  }
}

// Faithful reimplementation of the reference's color ball renderer
// (ref:tf_ops/renderball/render_balls_so.cpp:14-57): integer pixel
// coordinates, per-point colors, sphere-shaded disk pattern (dz/r),
// depth test on z + dz, intensity from the global z range, and the
// reference's channel-order quirk (out[0] = b·c2, out[1] = g·c0,
// out[2] = r·c1) preserved bit-for-bit so renders match.
void dispu_render_ball(int h, int w, uint8_t* show, int n,
                       const int32_t* xyzs, const float* c0, const float* c1,
                       const float* c2, int r) {
  r = std::max(r, 1);
  std::vector<int> depth((size_t)h * w, -2100000000);
  struct Pat { int x, y, z; float s; };
  std::vector<Pat> pattern;
  for (int dx = -r; dx <= r; ++dx)
    for (int dy = -r; dy <= r; ++dy)
      if (dx * dx + dy * dy < r * r) {
        double dz = std::sqrt(double(r * r - dx * dx - dy * dy));
        pattern.push_back({dx, dy, (int)dz, (float)(dz / r)});
      }
  double zmin = 0, zmax = 0;
  for (int i = 0; i < n; ++i) {
    if (i == 0) {
      zmin = xyzs[2] - r;
      zmax = xyzs[2] + r;
    } else {
      zmin = std::min(zmin, double(xyzs[i * 3 + 2] - r));
      zmax = std::max(zmax, double(xyzs[i * 3 + 2] + r));
    }
  }
  for (int i = 0; i < n; ++i) {
    int x = xyzs[i * 3], y = xyzs[i * 3 + 1], z = xyzs[i * 3 + 2];
    for (const Pat& p : pattern) {
      int x2 = x + p.x, y2 = y + p.y, z2 = z + p.z;
      if (x2 < 0 || x2 >= h || y2 < 0 || y2 >= w) continue;
      size_t pix = (size_t)x2 * w + y2;
      if (depth[pix] < z2) {
        depth[pix] = z2;
        double intensity =
            std::min(1.0, (z2 - zmin) / (zmax - zmin) * 0.7 + 0.3);
        show[pix * 3 + 0] = (uint8_t)(p.s * c2[i] * intensity);
        show[pix * 3 + 1] = (uint8_t)(p.s * c0[i] * intensity);
        show[pix * 3 + 2] = (uint8_t)(p.s * c1[i] * intensity);
      }
    }
  }
}

// Exact point-to-mesh distances, multithreaded over points.
// points (np, 3); verts (nv, 3); faces (nf, 3) int32.
// out_dist (np,), out_nearest (np, 3) — euclidean distance + mapped point.
// Parity target: ref:evaluation_code/evaluation.cpp:202-212 (CGAL AABB
// locate), computed brute-force per face (exact, no tree).
void dispu_point_to_mesh(const float* points, int np, const float* verts,
                         int nv, const int32_t* faces, int nf,
                         float* out_dist, float* out_nearest) {
  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  auto worker = [&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      const float* p = points + 3 * i;
      float best = std::numeric_limits<float>::infinity();
      float best_pt[3] = {0, 0, 0};
      float cand[3];
      for (int f = 0; f < nf; ++f) {
        const float* a = verts + 3 * faces[3 * f + 0];
        const float* b = verts + 3 * faces[3 * f + 1];
        const float* c = verts + 3 * faces[3 * f + 2];
        float d2 = point_tri_d2(p, a, b, c, cand);
        if (d2 < best) {
          best = d2;
          std::memcpy(best_pt, cand, sizeof(best_pt));
        }
      }
      out_dist[i] = std::sqrt(best);
      if (out_nearest) std::memcpy(out_nearest + 3 * i, best_pt, sizeof(best_pt));
    }
  };
  std::vector<std::thread> threads;
  int chunk = (np + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int begin = t * chunk, end = std::min(np, begin + chunk);
    if (begin >= end) break;
    threads.emplace_back(worker, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
