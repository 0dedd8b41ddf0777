// Host-side k-nearest-neighbour engine for the FD stencils of meshes above
// 2048 points: the port's own copy of pnmol_tpu/native/knn.cpp, the same
// algorithm and the same results.
//
// Design: classic in-place KD-tree over an index permutation (median split
// on the widest-spread axis), iterative best-first descent with a bounded
// max-heap per query, OpenMP across queries. C ABI for ctypes binding.
//
// Build (pnmol_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -fopenmp knn.cpp -o libknn.so

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Node {
  int32_t left = -1;    // child node index
  int32_t right = -1;   // child node index
  int32_t begin = 0;    // leaf: range into perm
  int32_t end = 0;
  int32_t axis = -1;    // split axis (-1: leaf)
  double split = 0.0;   // split coordinate
};

struct Tree {
  const double* pts;
  int64_t n;
  int64_t dim;
  std::vector<int32_t> perm;
  std::vector<Node> nodes;
  static constexpr int kLeafSize = 16;

  Tree(const double* points, int64_t n_, int64_t dim_)
      : pts(points), n(n_), dim(dim_), perm(n_) {
    for (int64_t i = 0; i < n; ++i) perm[i] = static_cast<int32_t>(i);
    nodes.reserve(2 * n / kLeafSize + 4);
    build(0, static_cast<int32_t>(n));
  }

  double coord(int32_t idx, int64_t ax) const { return pts[idx * dim + ax]; }

  int32_t build(int32_t begin, int32_t end) {
    const int32_t node_id = static_cast<int32_t>(nodes.size());
    nodes.emplace_back();
    Node& node = nodes.back();
    node.begin = begin;
    node.end = end;
    if (end - begin <= kLeafSize) return node_id;

    // pick the axis with the widest spread over this range
    int64_t best_axis = 0;
    double best_spread = -1.0;
    for (int64_t ax = 0; ax < dim; ++ax) {
      double lo = DBL_MAX, hi = -DBL_MAX;
      for (int32_t i = begin; i < end; ++i) {
        const double c = coord(perm[i], ax);
        lo = std::min(lo, c);
        hi = std::max(hi, c);
      }
      if (hi - lo > best_spread) {
        best_spread = hi - lo;
        best_axis = ax;
      }
    }
    if (best_spread <= 0.0) return node_id;  // all duplicates -> leaf

    const int32_t mid = begin + (end - begin) / 2;
    std::nth_element(
        perm.begin() + begin, perm.begin() + mid, perm.begin() + end,
        [&](int32_t a, int32_t b) { return coord(a, best_axis) < coord(b, best_axis); });

    // fill split info (note: nodes vector may reallocate during recursion,
    // so finish writes through the index, not the reference)
    nodes[node_id].axis = static_cast<int32_t>(best_axis);
    nodes[node_id].split = coord(perm[mid], best_axis);
    const int32_t left = build(begin, mid);
    const int32_t right = build(mid, end);
    nodes[node_id].left = left;
    nodes[node_id].right = right;
    return node_id;
  }
};

// bounded max-heap of (distance, index)
struct KHeap {
  double* dist;
  int32_t* idx;
  int32_t k;
  int32_t size = 0;

  void push(double d, int32_t i) {
    if (size < k) {
      dist[size] = d;
      idx[size] = i;
      ++size;
      sift_up(size - 1);
    } else if (d < dist[0]) {
      dist[0] = d;
      idx[0] = i;
      sift_down(0);
    }
  }
  double worst() const { return size < k ? DBL_MAX : dist[0]; }

  void sift_up(int32_t i) {
    while (i > 0) {
      int32_t parent = (i - 1) / 2;
      if (dist[parent] >= dist[i]) break;
      std::swap(dist[parent], dist[i]);
      std::swap(idx[parent], idx[i]);
      i = parent;
    }
  }
  void sift_down(int32_t i) {
    for (;;) {
      int32_t largest = i, l = 2 * i + 1, r = 2 * i + 2;
      if (l < size && dist[l] > dist[largest]) largest = l;
      if (r < size && dist[r] > dist[largest]) largest = r;
      if (largest == i) break;
      std::swap(dist[largest], dist[i]);
      std::swap(idx[largest], idx[i]);
      i = largest;
    }
  }
  void sort_ascending() {
    // heap-sort in place: max-heap extraction fills back-to-front, leaving
    // the array nearest-first
    int32_t original = size;
    while (size > 1) {
      --size;
      std::swap(dist[0], dist[size]);
      std::swap(idx[0], idx[size]);
      sift_down(0);
    }
    size = original;
  }
};

void query_one(const Tree& tree, const double* q, KHeap& heap) {
  // explicit stack: (node, lower-bound distance)
  struct Frame {
    int32_t node;
    double bound;
  };
  std::vector<Frame> stack;
  stack.push_back({0, 0.0});
  while (!stack.empty()) {
    Frame frame = stack.back();
    stack.pop_back();
    if (frame.bound >= heap.worst()) continue;
    const Node& node = tree.nodes[frame.node];
    if (node.axis < 0) {  // leaf
      for (int32_t i = node.begin; i < node.end; ++i) {
        const int32_t p = tree.perm[i];
        double d = 0.0;
        for (int64_t ax = 0; ax < tree.dim; ++ax) {
          const double diff = q[ax] - tree.coord(p, ax);
          d += diff * diff;
        }
        heap.push(d, p);
      }
      continue;
    }
    const double delta = q[node.axis] - node.split;
    const int32_t near = delta < 0.0 ? node.left : node.right;
    const int32_t far = delta < 0.0 ? node.right : node.left;
    const double far_bound = std::max(frame.bound, delta * delta);
    stack.push_back({far, far_bound});
    stack.push_back({near, frame.bound});
  }
}

}  // namespace

extern "C" {

// points (n x dim), queries (q x dim), row-major float64.
// Writes out_indices (q x k) and out_distances (q x k), nearest first.
void pnmol_knn_query(const double* points, int64_t n, int64_t dim,
                     const double* queries, int64_t q, int64_t k,
                     int32_t* out_indices, double* out_distances) {
  if (k > n) k = n;
  Tree tree(points, n, dim);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t qi = 0; qi < q; ++qi) {
    KHeap heap{out_distances + qi * k, out_indices + qi * k,
               static_cast<int32_t>(k)};
    query_one(tree, queries + qi * dim, heap);
    heap.sort_ascending();
    for (int32_t j = 0; j < heap.size; ++j)
      out_distances[qi * k + j] = std::sqrt(out_distances[qi * k + j]);
  }
}

}  // extern "C"
