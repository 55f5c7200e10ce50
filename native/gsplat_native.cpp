// gsplat_native: C++ host runtime for the JAX gaussian-splatting framework.
//
// Native equivalents of the reference's C++ host layer (dataloader +
// gaussian-init KNN + PLY writer; see src/colmap.cpp,
// gaussian.cpp, utils.cpp): a fast points3D.bin parser, an OpenMP kd-tree
// k-nearest-neighbor mean-distance pass (replacing nanoflann), and a binary
// PLY writer. Exposed as a C ABI consumed from Python via ctypes
// (gsplat_jax/io/native.py); pure-Python fallbacks exist for every entry.
//
// Build: make -C native   (produces libgsplat_native.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <numeric>
#include <queue>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// points3D.bin parser (format: colmap.cpp:154-198)
// ---------------------------------------------------------------------------

// Returns number of points on success (>=0), -1 on error. Caller passes
// buffers sized via gsplat_count_points3d.
long long gsplat_count_points3d(const char *path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  uint64_t n = 0;
  if (!f.read(reinterpret_cast<char *>(&n), 8)) return -1;
  return static_cast<long long>(n);
}

long long gsplat_parse_points3d(const char *path, long long cap,
                                double *xyz /* cap*3 */,
                                uint8_t *rgb /* cap*3 */,
                                double *error /* cap */,
                                uint64_t *ids /* cap */) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  uint64_t n = 0;
  if (!f.read(reinterpret_cast<char *>(&n), 8)) return -1;
  if (static_cast<long long>(n) > cap) return -1;

  // Buffer the whole file for speed; points3D.bin can be hundreds of MB.
  std::vector<char> buf((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());
  const char *p = buf.data();
  const char *end = p + buf.size();
  for (uint64_t i = 0; i < n; ++i) {
    // id(8) xyz(24) rgb(3) error(8) track_len(8) track(8*len)
    if (p + 51 > end) return -1;
    std::memcpy(&ids[i], p, 8);
    p += 8;
    std::memcpy(&xyz[i * 3], p, 24);
    p += 24;
    std::memcpy(&rgb[i * 3], p, 3);
    p += 3;
    std::memcpy(&error[i], p, 8);
    p += 8;
    uint64_t track = 0;
    std::memcpy(&track, p, 8);
    p += 8;
    if (p + 8 * track > end) return -1;
    p += 8 * track;
  }
  return static_cast<long long>(n);
}

// ---------------------------------------------------------------------------
// kd-tree 3-D k-nearest-neighbors mean distance (gaussian.cpp:59-96)
// ---------------------------------------------------------------------------

namespace {

struct KdTree {
  // Implicit balanced kd-tree over index array (nth_element splits).
  const double *pts;  // (n, 3)
  std::vector<int> idx;

  explicit KdTree(const double *p, int n) : pts(p), idx(n) {
    std::iota(idx.begin(), idx.end(), 0);
    build(0, n, 0);
  }

  void build(int lo, int hi, int axis) {
    if (hi - lo <= 1) return;
    int mid = (lo + hi) / 2;
    const double *p = pts;
    std::nth_element(
        idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
        [p, axis](int a, int b) { return p[a * 3 + axis] < p[b * 3 + axis]; });
    build(lo, mid, (axis + 1) % 3);
    build(mid + 1, hi, (axis + 1) % 3);
  }

  // max-heap of (dist_sq, idx) for the k best
  using Heap = std::priority_queue<std::pair<double, int>>;

  void query(const double *q, int k, int self, Heap &heap, int lo, int hi,
             int axis) const {
    if (hi <= lo) return;
    int mid = (lo + hi) / 2;
    int id = idx[mid];
    if (id != self) {
      double dx = q[0] - pts[id * 3], dy = q[1] - pts[id * 3 + 1],
             dz = q[2] - pts[id * 3 + 2];
      double d2 = dx * dx + dy * dy + dz * dz;
      if (static_cast<int>(heap.size()) < k)
        heap.emplace(d2, id);
      else if (d2 < heap.top().first) {
        heap.pop();
        heap.emplace(d2, id);
      }
    }
    double delta = q[axis] - pts[id * 3 + axis];
    int next_axis = (axis + 1) % 3;
    int near_lo = delta < 0 ? lo : mid + 1;
    int near_hi = delta < 0 ? mid : hi;
    int far_lo = delta < 0 ? mid + 1 : lo;
    int far_hi = delta < 0 ? hi : mid;
    query(q, k, self, heap, near_lo, near_hi, next_axis);
    if (static_cast<int>(heap.size()) < k ||
        delta * delta < heap.top().first)
      query(q, k, self, heap, far_lo, far_hi, next_axis);
  }
};

}  // namespace

// Mean distance to each point's k nearest neighbors (self excluded);
// isolated points get 0.01 (gaussian.cpp:87).
int gsplat_knn_mean_dist(const double *xyz, long long n, int k,
                         float *out_mean) {
  if (n <= 0) return -1;
  if (n == 1) {
    out_mean[0] = 0.01f;
    return 0;
  }
  KdTree tree(xyz, static_cast<int>(n));
#pragma omp parallel for schedule(dynamic, 256)
  for (long long i = 0; i < n; ++i) {
    KdTree::Heap heap;
    tree.query(&xyz[i * 3], k, static_cast<int>(i), heap, 0,
               static_cast<int>(n), 0);
    double total = 0.0;
    int count = 0;
    while (!heap.empty()) {
      total += std::sqrt(heap.top().first);
      heap.pop();
      ++count;
    }
    out_mean[i] = count > 0 ? static_cast<float>(total / count) : 0.01f;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Binary PLY writer (utils.cpp:88-175 format)
// ---------------------------------------------------------------------------

int gsplat_save_ply(const char *path, long long n, int num_sh,
                    const float *xyz, const float *rgb, const float *opacity,
                    const float *scale, const float *quat /* normalized */,
                    const float *sh /* n*num_sh or null */) {
  std::ofstream f(path, std::ios::binary);
  if (!f) return -1;
  f << "ply\nformat binary_little_endian 1.0\nelement vertex " << n << "\n";
  const char *base[] = {"x", "y", "z", "nx", "ny", "nz",
                        "f_dc_0", "f_dc_1", "f_dc_2"};
  for (const char *p : base) f << "property float " << p << "\n";
  for (int i = 0; i < num_sh; ++i) f << "property float f_rest_" << i << "\n";
  const char *tail[] = {"opacity", "scale_0", "scale_1", "scale_2",
                        "rot_0", "rot_1", "rot_2", "rot_3"};
  for (const char *p : tail) f << "property float " << p << "\n";
  f << "end_header\n";

  const float zeros[3] = {0, 0, 0};
  std::vector<char> row(4 * (9 + num_sh + 8));
  for (long long i = 0; i < n; ++i) {
    char *w = row.data();
    std::memcpy(w, &xyz[i * 3], 12); w += 12;
    std::memcpy(w, zeros, 12); w += 12;
    std::memcpy(w, &rgb[i * 3], 12); w += 12;
    if (num_sh) { std::memcpy(w, &sh[i * num_sh], 4 * num_sh); w += 4 * num_sh; }
    std::memcpy(w, &opacity[i], 4); w += 4;
    std::memcpy(w, &scale[i * 3], 12); w += 12;
    std::memcpy(w, &quat[i * 4], 16); w += 16;
    f.write(row.data(), row.size());
  }
  return f.good() ? 0 : -1;
}

}  // extern "C"
