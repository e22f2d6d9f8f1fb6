// Host-side nearest-neighbour / Chamfer kernels (C++), the CPU-native
// counterpart of the TPU Pallas kernel in lemo_tpu/ops/chamfer_pallas.py.
//
// Role: the reference depends on external native ops (a CUDA Chamfer
// extension and the psbody C++ mesh library) for its host-side tooling;
// this library provides the equivalent native tier for lemo_tpu's data
// preparation paths (scene scan deduplication, occlusion-mask
// precomputation, golden-output evaluation) where spinning up the XLA
// runtime is overkill. Exposed through ctypes (lemo_tpu/ops/native.py).
//
// Build: see native/build.sh (g++ -O3 -march=native -shared -fPIC).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <algorithm>
#include <vector>

extern "C" {

// For each of n queries find the squared distance to, and index of, the
// nearest of m points. O(n*m) blocked for cache friendliness.
void nn_distance_f32(const float* query, int64_t n,
                     const float* points, int64_t m,
                     const uint8_t* mask,  // may be null; 1 = valid
                     float* out_dist, int32_t* out_idx) {
  constexpr int64_t BLOCK = 256;
  for (int64_t qs = 0; qs < n; qs += BLOCK) {
    const int64_t qe = qs + BLOCK < n ? qs + BLOCK : n;
    for (int64_t i = qs; i < qe; ++i) {
      out_dist[i] = FLT_MAX;
      out_idx[i] = 0;
    }
    for (int64_t ps = 0; ps < m; ps += BLOCK) {
      const int64_t pe = ps + BLOCK < m ? ps + BLOCK : m;
      for (int64_t i = qs; i < qe; ++i) {
        const float qx = query[3 * i], qy = query[3 * i + 1],
                    qz = query[3 * i + 2];
        float best = out_dist[i];
        int32_t besti = out_idx[i];
        for (int64_t j = ps; j < pe; ++j) {
          if (mask && !mask[j]) continue;
          const float dx = qx - points[3 * j];
          const float dy = qy - points[3 * j + 1];
          const float dz = qz - points[3 * j + 2];
          const float d = dx * dx + dy * dy + dz * dz;
          if (d < best) {
            best = d;
            besti = static_cast<int32_t>(j);
          }
        }
        out_dist[i] = best;
        out_idx[i] = besti;
      }
    }
  }
}

// Bidirectional Chamfer (the CUDA extension's interface,
// temp_prox/dist_chamfer.py:27-45).
void chamfer_f32(const float* a, int64_t n, const float* b, int64_t m,
                 float* dist_a, int32_t* idx_a,
                 float* dist_b, int32_t* idx_b) {
  nn_distance_f32(a, n, b, m, nullptr, dist_a, idx_a);
  nn_distance_f32(b, m, a, n, nullptr, dist_b, idx_b);
}

// Uniform-grid accelerated variant for large clouds: hash points into a
// voxel grid, search the 27-neighborhood first, fall back to brute force
// for empty neighborhoods. Grid resolution picked from the cloud extent.
void nn_distance_grid_f32(const float* query, int64_t n,
                          const float* points, int64_t m,
                          float cell,  // voxel edge; <=0 -> auto
                          float* out_dist, int32_t* out_idx) {
  if (m == 0) return;
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int64_t j = 0; j < m; ++j)
    for (int k = 0; k < 3; ++k) {
      const float v = points[3 * j + k];
      if (v < lo[k]) lo[k] = v;
      if (v > hi[k]) hi[k] = v;
    }
  if (cell <= 0.f) {
    const float vol = (hi[0] - lo[0] + 1e-3f) * (hi[1] - lo[1] + 1e-3f) *
                      (hi[2] - lo[2] + 1e-3f);
    cell = std::cbrt(vol / static_cast<float>(m)) * 2.0f + 1e-6f;
  }
  int64_t dims[3];
  for (int k = 0; k < 3; ++k) {
    dims[k] = static_cast<int64_t>((hi[k] - lo[k]) / cell) + 1;
    if (dims[k] < 1) dims[k] = 1;
    if (dims[k] > 256) dims[k] = 256;
  }
  const float inv_cell_x = dims[0] / (hi[0] - lo[0] + 1e-6f);
  const float inv_cell_y = dims[1] / (hi[1] - lo[1] + 1e-6f);
  const float inv_cell_z = dims[2] / (hi[2] - lo[2] + 1e-6f);
  const int64_t ncells = dims[0] * dims[1] * dims[2];

  auto cell_of = [&](const float* p) -> int64_t {
    int64_t cx = static_cast<int64_t>((p[0] - lo[0]) * inv_cell_x);
    int64_t cy = static_cast<int64_t>((p[1] - lo[1]) * inv_cell_y);
    int64_t cz = static_cast<int64_t>((p[2] - lo[2]) * inv_cell_z);
    if (cx < 0) cx = 0; if (cx >= dims[0]) cx = dims[0] - 1;
    if (cy < 0) cy = 0; if (cy >= dims[1]) cy = dims[1] - 1;
    if (cz < 0) cz = 0; if (cz >= dims[2]) cz = dims[2] - 1;
    return (cx * dims[1] + cy) * dims[2] + cz;
  };

  // counting sort of points into cells
  std::vector<int64_t> counts(ncells + 1, 0);
  std::vector<int64_t> cell_id(m);
  for (int64_t j = 0; j < m; ++j) {
    cell_id[j] = cell_of(points + 3 * j);
    counts[cell_id[j] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  std::vector<int32_t> order(m);
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t j = 0; j < m; ++j)
      order[cursor[cell_id[j]]++] = static_cast<int32_t>(j);
  }

  for (int64_t i = 0; i < n; ++i) {
    const float* q = query + 3 * i;
    float best = FLT_MAX;
    int32_t besti = 0;
    // expanding ring search: radius r in cells until a hit is found and
    // the best distance is covered by the searched radius
    int64_t qc[3] = {
        static_cast<int64_t>((q[0] - lo[0]) * inv_cell_x),
        static_cast<int64_t>((q[1] - lo[1]) * inv_cell_y),
        static_cast<int64_t>((q[2] - lo[2]) * inv_cell_z)};
    for (int k = 0; k < 3; ++k) {
      if (qc[k] < 0) qc[k] = 0;
      if (qc[k] >= dims[k]) qc[k] = dims[k] - 1;
    }
    const int64_t max_r =
        std::max(std::max(dims[0], dims[1]), dims[2]);
    for (int64_t r = 0; r <= max_r; ++r) {
      bool shell_nonempty = false;
      for (int64_t dx = -r; dx <= r; ++dx) {
        const int64_t cx = qc[0] + dx;
        if (cx < 0 || cx >= dims[0]) continue;
        for (int64_t dy = -r; dy <= r; ++dy) {
          const int64_t cy = qc[1] + dy;
          if (cy < 0 || cy >= dims[1]) continue;
          for (int64_t dz = -r; dz <= r; ++dz) {
            // shell only
            if (std::max(std::max(std::llabs(dx), std::llabs(dy)),
                         std::llabs(dz)) != r)
              continue;
            const int64_t cz = qc[2] + dz;
            if (cz < 0 || cz >= dims[2]) continue;
            const int64_t c = (cx * dims[1] + cy) * dims[2] + cz;
            for (int64_t s = counts[c]; s < counts[c + 1]; ++s) {
              const int32_t j = order[s];
              const float ddx = q[0] - points[3 * j];
              const float ddy = q[1] - points[3 * j + 1];
              const float ddz = q[2] - points[3 * j + 2];
              const float d = ddx * ddx + ddy * ddy + ddz * ddz;
              shell_nonempty = true;
              if (d < best) {
                best = d;
                besti = j;
              }
            }
          }
        }
      }
      // stop once the found best is closer than the next unsearched shell
      if (best < FLT_MAX) {
        const float safe = static_cast<float>(r) * cell;
        if (best <= safe * safe || r == max_r) break;
      }
      (void)shell_nonempty;
    }
    out_dist[i] = best;
    out_idx[i] = besti;
  }
}

}  // extern "C"
