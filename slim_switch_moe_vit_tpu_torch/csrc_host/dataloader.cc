// Native host-side image pipeline: crop + bicubic resize, batched + threaded.
//
// A copy of the JAX package's native/dataloader.cc for the PyTorch port: the
// per-sample geometry (RandomResizedCrop / center crop, reference
// datasets.py:294-318) runs here as a C++ thread pool over the batch,
// feeding contiguous uint8 NHWC buffers ready for one host->device copy.
// Photometric augmentation stays on the device (data/device_aug.py). The
// code is the JAX package's, line for line, so the two crop paths give the
// same pixels.
//
// Bicubic uses the Catmull-Rom-family kernel with a=-0.5 (the convention PIL
// and most frameworks use). PIL additionally applies a box prefilter when
// downscaling ("support scaling"); we match that by area-averaging with the
// scaled kernel width, like PIL's resample implementation.
//
// Built with the host C++ compiler at first use by data/native_loader.py
// (into the package's _build/), and bound there with ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float cubic_kernel(float x) {
  // a = -0.5 (PIL's BICUBIC)
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// Resample one axis (separable bicubic with PIL-style support scaling).
// in: (n_rows, in_len, C) strided; out: (n_rows, out_len, C).
struct Weights {
  std::vector<int> start;     // first source index per output pixel
  std::vector<int> count;     // taps per output pixel
  std::vector<float> values;  // taps, max_taps per output pixel
  int max_taps;
};

Weights compute_weights(int in_len, int out_len, float in_off, float in_size) {
  Weights w;
  const float scale = in_size / out_len;
  const float filter_scale = std::max(scale, 1.0f);
  const float support = 2.0f * filter_scale;
  w.max_taps = (int)std::ceil(support) * 2 + 1;
  w.start.resize(out_len);
  w.count.resize(out_len);
  w.values.assign((size_t)out_len * w.max_taps, 0.0f);
  for (int i = 0; i < out_len; ++i) {
    const float center = in_off + (i + 0.5f) * scale;
    int lo = (int)std::floor(center - support + 0.5f);
    int hi = (int)std::floor(center + support + 0.5f);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_len);
    float sum = 0.0f;
    int cnt = hi - lo;
    for (int j = 0; j < cnt; ++j) {
      float v = cubic_kernel((lo + j - center + 0.5f) / filter_scale);
      w.values[(size_t)i * w.max_taps + j] = v;
      sum += v;
    }
    if (sum != 0.0f) {
      for (int j = 0; j < cnt; ++j) w.values[(size_t)i * w.max_taps + j] /= sum;
    }
    w.start[i] = lo;
    w.count[i] = cnt;
  }
  return w;
}

inline uint8_t clamp_u8(float v) {
  return (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
}

}  // namespace

extern "C" {

// Crop region (y0, x0, ch, cw) from src (H, W, 3) u8 and bicubic-resize to
// dst (S, S, 3).
void ssmv_crop_resize_u8(const uint8_t* src, int H, int W, int y0, int x0,
                         int ch, int cw, uint8_t* dst, int S) {
  // horizontal pass: (ch, cw, 3) -> float (ch, S, 3)
  Weights wx = compute_weights(W, S, (float)x0, (float)cw);
  Weights wy = compute_weights(H, S, (float)y0, (float)ch);
  // only source rows inside the vertical filter support are needed
  int row_lo = H, row_hi = 0;
  for (int y = 0; y < S; ++y) {
    row_lo = std::min(row_lo, wy.start[y]);
    row_hi = std::max(row_hi, wy.start[y] + wy.count[y]);
  }
  std::vector<float> tmp((size_t)H * S * 3);
  for (int y = row_lo; y < row_hi; ++y) {
    const uint8_t* row = src + (size_t)y * W * 3;
    float* orow = tmp.data() + (size_t)y * S * 3;
    for (int x = 0; x < S; ++x) {
      const float* vals = wx.values.data() + (size_t)x * wx.max_taps;
      int lo = wx.start[x], cnt = wx.count[x];
      float r = 0, g = 0, b = 0;
      for (int j = 0; j < cnt; ++j) {
        const float v = vals[j];
        const uint8_t* p = row + (size_t)(lo + j) * 3;
        r += v * p[0];
        g += v * p[1];
        b += v * p[2];
      }
      orow[x * 3 + 0] = r;
      orow[x * 3 + 1] = g;
      orow[x * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int y = 0; y < S; ++y) {
    const float* vals = wy.values.data() + (size_t)y * wy.max_taps;
    int lo = wy.start[y], cnt = wy.count[y];
    uint8_t* orow = dst + (size_t)y * S * 3;
    for (int x = 0; x < S * 3; ++x) {
      float acc = 0;
      for (int j = 0; j < cnt; ++j) {
        acc += vals[j] * tmp[(size_t)(lo + j) * S * 3 + x];
      }
      orow[x] = clamp_u8(acc);
    }
  }
}

// Batched, threaded variant. srcs: n pointers; dims: (n, 2) int32 [H, W];
// crops: (n, 4) int32 [y0, x0, ch, cw]; dst: (n, S, S, 3) u8.
void ssmv_batch_crop_resize_u8(const uint8_t** srcs, const int32_t* dims,
                               const int32_t* crops, uint8_t* dst, int n,
                               int S, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      ssmv_crop_resize_u8(srcs[i], dims[i * 2], dims[i * 2 + 1],
                          crops[i * 4], crops[i * 4 + 1], crops[i * 4 + 2],
                          crops[i * 4 + 3], dst + (size_t)i * S * S * 3, S);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < num_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

// Reflect-pad random crop for small inputs (reference transforms:
// RandomCrop(padding=4, padding_mode='reflect'), datasets.py:304-307,
// augment.py:104). src: (H, W, 3); dst: (S, S, 3); (y0, x0) in padded coords.
void ssmv_pad_reflect_crop_u8(const uint8_t* src, int H, int W, int pad,
                              int y0, int x0, uint8_t* dst, int S) {
  for (int y = 0; y < S; ++y) {
    int sy = y0 + y - pad;
    if (sy < 0) sy = -sy;
    if (sy >= H) sy = 2 * H - 2 - sy;
    for (int x = 0; x < S; ++x) {
      int sx = x0 + x - pad;
      if (sx < 0) sx = -sx;
      if (sx >= W) sx = 2 * W - 2 - sx;
      std::memcpy(dst + ((size_t)y * S + x) * 3,
                  src + ((size_t)sy * W + sx) * 3, 3);
    }
  }
}

int ssmv_version() { return 1; }

}  // extern "C"
