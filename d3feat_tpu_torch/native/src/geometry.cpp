// Native host-side geometry ops for d3feat_tpu_torch: a copy of the JAX
// package's d3feat_tpu/native/src/geometry.cpp, so that both packages give
// the same answers bit for bit.
//
// C++ counterparts of the on-device geometry ops, with the same observable
// semantics as the reference's native pipeline
// (reference: cpp_wrappers/cpp_subsampling/grid_subsampling/grid_subsampling.cpp
// barycenter accumulation; cpp_wrappers/cpp_neighbors/neighbors/neighbors.cpp
// distance-sorted radius rows with shadow padding), but a different design:
//  * subsampling emits voxels deterministically sorted by (cloud, z, y, x)
//    cell — not unordered_map iteration order;
//  * the radius search is a uniform cell grid (cell edge = radius, 27-cell
//    probe) instead of a KD-tree — O(1) per query at fixed density.
//
// Used for offline dataset preparation and host-side checks; exposed to
// Python over a plain C ABI via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Vec3 {
  float x, y, z;
};

inline int64_t cell_key(int cx, int cy, int cz) {
  // 21 bits per axis, offset to keep coordinates non-negative.
  const int64_t off = 1 << 20;
  return (((int64_t)(cz + off)) << 42) | (((int64_t)(cy + off)) << 21) |
         (int64_t)(cx + off);
}

}  // namespace

extern "C" {

// Batched voxel-grid barycenter subsampling.
//   points      [sum(lengths), 3] float32, clouds stacked contiguously
//   lengths     [num_clouds] int32
//   voxel       cell edge length
//   out_points  [capacity, 3] float32 (caller-allocated); rows beyond the
//               emitted count are left untouched
//   out_lengths [num_clouds] int32 per-cloud emitted counts (possibly
//               truncated to fit capacity)
//   out_total   emitted row count
// Returns 0 on success, 1 if the occupied-voxel count exceeded capacity
// (output truncated per cloud in key order — the overflow signal mirrors
// the on-device op's `overflow` flag).
int d3f_grid_subsample_batch(const float* points, const int32_t* lengths,
                             int num_clouds, float voxel, float* out_points,
                             int capacity, int32_t* out_lengths,
                             int32_t* out_total) {
  int overflow = 0;
  int emitted = 0;
  int64_t base = 0;
  for (int c = 0; c < num_clouds; ++c) {
    const int n = lengths[c];
    const float* pts = points + 3 * base;
    // per-cloud origin: floor(min / voxel) * voxel
    float mn[3] = {INFINITY, INFINITY, INFINITY};
    for (int i = 0; i < n; ++i)
      for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], pts[3 * i + d]);
    float origin[3];
    for (int d = 0; d < 3; ++d) origin[d] = std::floor(mn[d] / voxel) * voxel;

    struct Acc {
      double sx = 0, sy = 0, sz = 0;
      int cnt = 0;
    };
    std::unordered_map<int64_t, Acc> cells;
    cells.reserve((size_t)n / 2 + 1);
    for (int i = 0; i < n; ++i) {
      const float* p = pts + 3 * i;
      int cx = (int)std::floor((p[0] - origin[0]) / voxel);
      int cy = (int)std::floor((p[1] - origin[1]) / voxel);
      int cz = (int)std::floor((p[2] - origin[2]) / voxel);
      Acc& a = cells[cell_key(cx, cy, cz)];
      a.sx += p[0];
      a.sy += p[1];
      a.sz += p[2];
      a.cnt += 1;
    }
    std::vector<std::pair<int64_t, Acc>> sorted(cells.begin(), cells.end());
    std::sort(sorted.begin(), sorted.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });

    int kept = 0;
    for (const auto& kv : sorted) {
      if (emitted >= capacity) {
        overflow = 1;
        break;
      }
      out_points[3 * emitted + 0] = (float)(kv.second.sx / kv.second.cnt);
      out_points[3 * emitted + 1] = (float)(kv.second.sy / kv.second.cnt);
      out_points[3 * emitted + 2] = (float)(kv.second.sz / kv.second.cnt);
      ++emitted;
      ++kept;
    }
    out_lengths[c] = kept;
    base += n;
  }
  *out_total = emitted;
  return overflow;
}

// Batched fixed-width radius neighbor search over a uniform cell grid.
//   queries   [sum(q_lengths), 3], supports [sum(s_lengths), 3]
//   out       [sum(q_lengths), max_k] int32, rows sorted ascending by
//             distance, padded with shadow index == sum(s_lengths)
// Cloud c queries only match cloud c supports. Returns 0.
int d3f_radius_neighbors_batch(const float* queries, const int32_t* q_lengths,
                               const float* supports, const int32_t* s_lengths,
                               int num_clouds, float radius, int max_k,
                               int32_t* out) {
  int64_t nq_total = 0, ns_total = 0;
  for (int c = 0; c < num_clouds; ++c) {
    nq_total += q_lengths[c];
    ns_total += s_lengths[c];
  }
  const int32_t shadow = (int32_t)ns_total;
  const float r2 = radius * radius;

  int64_t qbase = 0, sbase = 0;
  for (int c = 0; c < num_clouds; ++c) {
    const int nq = q_lengths[c];
    const int ns = s_lengths[c];
    const float* qp = queries + 3 * qbase;
    const float* sp = supports + 3 * sbase;

    // bucket supports into cells of edge `radius`
    std::unordered_map<int64_t, std::vector<int32_t>> grid;
    grid.reserve((size_t)ns / 2 + 1);
    for (int i = 0; i < ns; ++i) {
      const float* p = sp + 3 * i;
      grid[cell_key((int)std::floor(p[0] / radius),
                    (int)std::floor(p[1] / radius),
                    (int)std::floor(p[2] / radius))]
          .push_back(i);
    }

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int i = 0; i < nq; ++i) {
      const float* q = qp + 3 * i;
      const int qcx = (int)std::floor(q[0] / radius);
      const int qcy = (int)std::floor(q[1] / radius);
      const int qcz = (int)std::floor(q[2] / radius);

      // k-best insertion lists (small max_k: linear insert is fastest)
      std::vector<float> best_d(max_k, INFINITY);
      std::vector<int32_t> best_i(max_k, shadow);
      int count = 0;
      for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            auto it = grid.find(cell_key(qcx + dx, qcy + dy, qcz + dz));
            if (it == grid.end()) continue;
            for (int32_t j : it->second) {
              const float* s = sp + 3 * j;
              const float ddx = s[0] - q[0], ddy = s[1] - q[1],
                          ddz = s[2] - q[2];
              const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
              if (d2 > r2 || d2 >= best_d[max_k - 1]) continue;
              int pos = max_k - 1;
              while (pos > 0 && best_d[pos - 1] > d2) {
                best_d[pos] = best_d[pos - 1];
                best_i[pos] = best_i[pos - 1];
                --pos;
              }
              best_d[pos] = d2;
              best_i[pos] = j;
              if (count < max_k) ++count;
            }
          }
      int32_t* row = out + (qbase + i) * max_k;
      for (int k = 0; k < max_k; ++k)
        row[k] = best_i[k] == shadow ? shadow : best_i[k] + (int32_t)sbase;
    }
    qbase += nq;
    sbase += ns;
  }
  return 0;
}

}  // extern "C"
