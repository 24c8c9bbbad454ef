// fastio: the data pipeline's fused float passes (crop + optional gamma +
// ImageNet normalisation, uint8 -> float32, the nearest GT pyramid), the
// port's copy of the JAX package's native/fastio.cpp, entry points and
// arithmetic unchanged, so its float32 results equal that library's bit for
// bit (data/native.py builds it without -march=native or fast-math, and with
// -ffp-contract=off, so every product and sum rounds as written).
//
// Contiguous float32 / uint8 row-major buffers; the caller checks shapes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// crop_h x crop_w crop from (h, w, 3) float32 [0,1] image at (oy, ox), then
// ImageNet-normalize, optional gamma, into out (crop_h, crop_w, 3).
void crop_normalize_f32(const float* img, int h, int w, int oy, int ox,
                        int crop_h, int crop_w, float gamma, float* out) {
  static const float mean[3] = {0.485f, 0.456f, 0.406f};
  static const float stdv[3] = {0.229f, 0.224f, 0.225f};
  const bool do_gamma = gamma > 0.f && std::fabs(gamma - 1.f) > 1e-6f;
  for (int y = 0; y < crop_h; ++y) {
    const float* src = img + ((size_t)(oy + y) * w + ox) * 3;
    float* dst = out + (size_t)y * crop_w * 3;
    for (int x = 0; x < crop_w; ++x) {
      for (int c = 0; c < 3; ++c) {
        float v = src[x * 3 + c];
        if (do_gamma) v = std::pow(std::min(std::max(v, 0.f), 1.f), gamma);
        dst[x * 3 + c] = (v - mean[c]) / stdv[c];
      }
    }
  }
}

// uint8 HWC image -> float32 [0,1]
void u8_to_f32(const uint8_t* src, int64_t n, float* dst) {
  constexpr float k = 1.f / 255.f;
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * k;
}

// nearest-neighbour pyramid of a (h, w) float32 map into 4 levels with
// strides 8/4/2/1 (cv2 INTER_NEAREST src index: floor(dst * in/out)).
void stage_pyramid_f32(const float* src, int h, int w, float* s1, float* s2,
                       float* s3, float* s4) {
  struct Level { float* dst; int f; };
  Level levels[3] = {{s1, 8}, {s2, 4}, {s3, 2}};
  for (const auto& lv : levels) {
    const int oh = h / lv.f, ow = w / lv.f;
    for (int y = 0; y < oh; ++y) {
      const int sy = (int)((int64_t)y * h / oh);
      const float* row = src + (size_t)sy * w;
      float* drow = lv.dst + (size_t)y * ow;
      for (int x = 0; x < ow; ++x) drow[x] = row[(int)((int64_t)x * w / ow)];
    }
  }
  std::memcpy(s4, src, (size_t)h * w * sizeof(float));
}

// multi-threaded batched crop+normalize: n images laid out contiguously.
void batch_crop_normalize_f32(const float* imgs, int n, int h, int w,
                              const int* oys, const int* oxs, int crop_h,
                              int crop_w, float gamma, float* out,
                              int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      crop_normalize_f32(imgs + (size_t)i * h * w * 3, h, w, oys[i], oxs[i],
                         crop_h, crop_w, gamma,
                         out + (size_t)i * crop_h * crop_w * 3);
    }
  };
  std::vector<std::thread> ts;
  const int nt = std::min(n_threads, n);
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

}  // extern "C"
