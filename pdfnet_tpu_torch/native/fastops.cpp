// Host-side data-path kernels (C++), exposed via ctypes.
//
// The training input pipeline is CPU-bound (this box feeds a TPU from few
// host cores): depth->point-cloud lifting and CenterNet gaussian splatting
// run per sample per hand.  These replace the numpy implementations with
// single-pass loops (no intermediate H*W*3 temporaries).
//
// Build: g++ -O3 -march=native -shared -fPIC fastops.cpp -o libfastops.so
// (pdfnet_tpu_torch.native builds it into pdfnet_tpu_torch/_build/ at first
// use and raises with the compiler's message when the build fails).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>

extern "C" {

// Depth -> banded camera-space point cloud sample.
//
// depth:    H*W masked metric depth (0 = invalid)
// K_inv:    row-major 3x3 inverse intrinsics
// num_points, min_pixels, z_min/z_max/band: sampling params
// seed:     RNG seed for the random subset + shuffle
// out_choose: num_points flat pixel indices
// out_cloud:  num_points*3 xyz
// returns 1 if the hand is valid (enough banded pixels), else 0.
int sample_hand_cloud(const float* depth, int H, int W, const float* K_inv,
                      int num_points, int min_pixels, float z_min,
                      float z_max, float band, uint64_t seed,
                      int64_t* out_choose, float* out_cloud) {
  const int n = H * W;
  // pass 1: mean of nonzero depths
  double sum = 0.0;
  int64_t cnt = 0;
  for (int i = 0; i < n; ++i) {
    if (depth[i] != 0.0f) {
      sum += depth[i];
      ++cnt;
    }
  }
  if (cnt == 0) {
    std::memset(out_choose, 0, sizeof(int64_t) * num_points);
    std::memset(out_cloud, 0, sizeof(float) * num_points * 3);
    return 0;
  }
  const float mean = static_cast<float>(sum / cnt);
  const float lo = std::max(z_min, mean - band);
  const float hi = std::min(z_max, mean + band);

  // pass 2: collect banded indices
  int64_t* idx = new int64_t[cnt];
  int64_t m = 0;
  for (int i = 0; i < n; ++i) {
    const float z = depth[i];
    if (z > lo && z < hi) idx[m++] = i;
  }
  if (m < min_pixels) {
    delete[] idx;
    std::memset(out_choose, 0, sizeof(int64_t) * num_points);
    std::memset(out_cloud, 0, sizeof(float) * num_points * 3);
    return 0;
  }

  std::mt19937_64 rng(seed);
  if (m > num_points) {
    // partial Fisher-Yates: first num_points entries become a uniform subset
    for (int i = 0; i < num_points; ++i) {
      const int64_t j = i + static_cast<int64_t>(rng() % (m - i));
      std::swap(idx[i], idx[j]);
    }
    m = num_points;
    for (int i = 0; i < num_points; ++i) out_choose[i] = idx[i];
  } else {
    for (int64_t i = 0; i < m; ++i) out_choose[i] = idx[i];
    for (int i = static_cast<int>(m); i < num_points; ++i)
      out_choose[i] = idx[i % m];  // wrap padding
    // shuffle the padded sequence (reference shuffles after padding)
    for (int i = num_points - 1; i > 0; --i) {
      const int j = static_cast<int>(rng() % (i + 1));
      std::swap(out_choose[i], out_choose[j]);
    }
  }
  delete[] idx;

  // backproject only the chosen pixels
  const float k00 = K_inv[0], k01 = K_inv[1], k02 = K_inv[2];
  const float k10 = K_inv[3], k11 = K_inv[4], k12 = K_inv[5];
  for (int i = 0; i < num_points; ++i) {
    const int64_t p = out_choose[i];
    const float z = depth[p];
    const float x = static_cast<float>(p % W);
    const float y = static_cast<float>(p / W);
    out_cloud[i * 3 + 0] = (k00 * x + k01 * y + k02) * z;
    out_cloud[i * 3 + 1] = (k10 * x + k11 * y + k12) * z;
    out_cloud[i * 3 + 2] = z;
  }
  return 1;
}

// Max-composited 2D gaussian splat (draw_umich_gaussian).
void draw_gaussian(float* heatmap, int H, int W, int cx, int cy, int radius) {
  if (cx < 0 || cy < 0 || cx >= W || cy >= H) return;
  const int d = 2 * radius + 1;
  const float sigma = d / 6.0f;
  const float inv = 1.0f / (2.0f * sigma * sigma);
  const int x0 = std::max(0, cx - radius), x1 = std::min(W, cx + radius + 1);
  const int y0 = std::max(0, cy - radius), y1 = std::min(H, cy + radius + 1);
  for (int y = y0; y < y1; ++y) {
    const float dy = static_cast<float>(y - cy);
    for (int x = x0; x < x1; ++x) {
      const float dx = static_cast<float>(x - cx);
      const float g = std::exp(-(dx * dx + dy * dy) * inv);
      float& h = heatmap[y * W + x];
      if (g > h) h = g;
    }
  }
}

}  // extern "C"
