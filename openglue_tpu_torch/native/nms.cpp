// Host-native greedy radius NMS for keypoint selection (a copy of
// openglue_tpu/native/nms.cpp; the port builds and loads its own).
//
// The reference's host-side feature-selection hot loop (reference
// models/features/opencv/base.py:161-182: response-sorted greedy suppression
// via a scipy KD-tree, called once per image in the offline feature cacher).
// The Python loop + KD-tree ball queries dominate extract-features wall clock
// at dense detection (thresholds disabled => tens of thousands of raw
// keypoints per image); this implementation uses a uniform grid hash (cell =
// radius) so each acceptance probes at most 9 cells, giving O(N log N) total
// (the sort) with a tiny constant.
//
// Exposed as a C ABI for ctypes. Semantics are identical to
// openglue_tpu_torch.features.opencv_features.nms_keypoints_scipy: visit
// keypoints in decreasing-response order, accept if not yet suppressed, then
// suppress every keypoint within `radius` (ties in response are broken by
// index for determinism).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// xy:    [n * 2] float32 keypoint coordinates
// resp:  [n] float32 responses
// keep:  [n] uint8 output mask (1 = kept)
// returns the number of kept keypoints, or -1 on invalid input / when the
// grid would be degenerate (the caller raises)
static int og_nms_radius_impl(const float* xy, const float* resp, int n,
                              float radius, unsigned char* keep) {
  if (n < 0 || radius < 0.f || !xy || !resp || !keep) return -1;
  if (n == 0) return 0;
  std::fill(keep, keep + n, 0);

  float min_x = xy[0], min_y = xy[1];
  float max_x = xy[0], max_y = xy[1];
  for (int i = 1; i < n; ++i) {
    min_x = std::min(min_x, xy[2 * i]);
    max_x = std::max(max_x, xy[2 * i]);
    min_y = std::min(min_y, xy[2 * i + 1]);
    max_y = std::max(max_y, xy[2 * i + 1]);
  }
  if (!std::isfinite(min_x) || !std::isfinite(max_x) ||
      !std::isfinite(min_y) || !std::isfinite(max_y))
    return -1;
  // Correctness of the 9-cell probe only needs cell >= radius; a larger cell
  // just means more candidates per cell. Clamping the cell to extent/4096
  // bounds the grid at ~16M cells regardless of how small the radius is (the
  // radius == 0 case — which suppresses distance-0 duplicates to match scipy
  // query_ball_point(r=0) — runs the normal loop with this extent-based
  // cell), so a tiny radius over a large extent can no longer allocate
  // gigabytes or overflow the cell index.
  const float extent = std::max(max_x - min_x, max_y - min_y);
  const float cell = std::max({radius, extent / 4096.0f, 1e-12f});
  const int64_t gw = static_cast<int64_t>((max_x - min_x) / cell) + 1;
  const int64_t gh = static_cast<int64_t>((max_y - min_y) / cell) + 1;
  const int64_t kMaxCells = int64_t(64) * 1024 * 1024;  // defense in depth
  if (gw <= 0 || gh <= 0 || gw > kMaxCells || gh > kMaxCells ||
      gw * gh > kMaxCells)
    return -1;

  // counting-sort keypoints into grid cells (CSR layout)
  std::vector<int64_t> cell_of(n);
  std::vector<int32_t> counts(gw * gh + 1, 0);
  for (int i = 0; i < n; ++i) {
    const int64_t cx = static_cast<int64_t>((xy[2 * i] - min_x) / cell);
    const int64_t cy = static_cast<int64_t>((xy[2 * i + 1] - min_y) / cell);
    cell_of[i] = cy * gw + cx;
    ++counts[cell_of[i] + 1];
  }
  for (size_t c = 1; c < counts.size(); ++c) counts[c] += counts[c - 1];
  std::vector<int32_t> items(n);
  {
    std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
    for (int i = 0; i < n; ++i) items[cursor[cell_of[i]]++] = i;
  }

  // response-descending visit order, index-ascending on ties
  std::vector<int32_t> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (resp[a] != resp[b]) return resp[a] > resp[b];
    return a < b;
  });

  std::vector<uint8_t> removed(n, 0);
  const float r2 = radius * radius;
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int32_t i = order[oi];
    if (removed[i]) continue;
    keep[i] = 1;
    ++kept;
    const float px = xy[2 * i], py = xy[2 * i + 1];
    const int64_t cx = static_cast<int64_t>((px - min_x) / cell);
    const int64_t cy = static_cast<int64_t>((py - min_y) / cell);
    for (int64_t dy = -1; dy <= 1; ++dy) {
      const int64_t ny = cy + dy;
      if (ny < 0 || ny >= gh) continue;
      for (int64_t dx = -1; dx <= 1; ++dx) {
        const int64_t nx = cx + dx;
        if (nx < 0 || nx >= gw) continue;
        const int64_t c = ny * gw + nx;
        for (int32_t s = counts[c]; s < counts[c + 1]; ++s) {
          const int32_t j = items[s];
          if (removed[j]) continue;
          const float ddx = xy[2 * j] - px;
          const float ddy = xy[2 * j + 1] - py;
          if (ddx * ddx + ddy * ddy <= r2) removed[j] = 1;
        }
      }
    }
  }
  return kept;
}

int og_nms_radius(const float* xy, const float* resp, int n, float radius,
                  unsigned char* keep) {
  // An exception crossing the C ABI would std::terminate the host process;
  // report failure instead, which the ctypes caller raises.
  try {
    return og_nms_radius_impl(xy, resp, n, radius, keep);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
