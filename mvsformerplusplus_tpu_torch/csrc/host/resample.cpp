// OpenCV's resizes and 8-bit hue shift as the data pipeline uses them: the
// C++ counterparts of data/image.py's numpy versions (resize_area's shrink,
// resize_nearest, resize_linear, rgb_to_hsv_u8 + hsv_to_rgb_u8), the same
// arithmetic in the same order and precision, so the same values bit for
// bit. data/native.py builds this file with -ffp-contract=off: every float
// product and sum rounds on its own, as numpy's separate passes do.
//
// The area shrinks write a window [oy, oy + wh) x [ox, ox + ww) of their
// (dh, dw) output (get_sample's crop): every output pixel depends only on
// its own source cell, so a window equals the same window of the whole
// output. Buffers are contiguous row-major [h, w, c]; the caller checks
// shapes and the window. Each call runs in the calling thread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int { kOk = 0, kBadArgument = 5 };

bool bad_window(int64_t dh, int64_t dw, int64_t oy, int64_t ox, int64_t wh, int64_t ww) {
  return oy < 0 || ox < 0 || wh < 0 || ww < 0 || oy + wh > dh || ox + ww > dw;
}

// One axis of OpenCV's computeResizeAreaTab (image._area_table): per
// destination index its source indices and float32 weights, in OpenCV's
// order, the weights computed in double as Python computes them.
struct AreaTab {
  std::vector<int64_t> start;  // entries of index d: [start[d], start[d + 1])
  std::vector<int64_t> index;
  std::vector<float> weight;
};

AreaTab area_table(int64_t ssize, int64_t dsize) {
  AreaTab t;
  const double scale = 1.0 / (double(dsize) / double(ssize));
  t.start.push_back(0);
  for (int64_t dx = 0; dx < dsize; ++dx) {
    const double fsx1 = double(dx) * scale;
    const double fsx2 = fsx1 + scale;
    const double cell = std::min(scale, double(ssize) - fsx1);
    int64_t sx1 = int64_t(std::ceil(fsx1)), sx2 = int64_t(std::floor(fsx2));
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (double(sx1) - fsx1 > 1e-3) {
      t.index.push_back(sx1 - 1);
      t.weight.push_back(float((double(sx1) - fsx1) / cell));
    }
    for (int64_t sx = sx1; sx < sx2; ++sx) {
      t.index.push_back(sx);
      t.weight.push_back(float(1.0 / cell));
    }
    if (fsx2 - double(sx2) > 1e-3) {
      t.index.push_back(sx2);
      t.weight.push_back(float(std::min(std::min(fsx2 - double(sx2), 1.0), cell) / cell));
    }
    t.start.push_back(int64_t(t.index.size()));
  }
  return t;
}

// The fractional area shrink of float32 [sh, sw, c] into the window: each
// needed source row across its x-cells (acc = acc + s * w from 0, in the
// table's order), then those rows down each y-cell. The numpy version pads
// every cell's entries to the longest cell's count with zero weights; a
// zero-weight product adds +-0, which leaves every finite sum as it is.
void area_general(const float* src, int64_t sh, int64_t sw, int64_t c, int64_t dh, int64_t dw,
                  int64_t oy, int64_t ox, int64_t wh, int64_t ww, float* out) {
  const AreaTab xt = area_table(sw, dw), yt = area_table(sh, dh);
  if (wh == 0 || ww == 0) return;
  const int64_t r0 = yt.index[yt.start[oy]], r1 = yt.index[yt.start[oy + wh] - 1];
  const int64_t rw = ww * c;
  std::vector<float> rows((r1 - r0 + 1) * rw);
  for (int64_t r = r0; r <= r1; ++r) {
    const float* s = src + r * sw * c;
    float* o = &rows[(r - r0) * rw];
    for (int64_t x = 0; x < ww; ++x) {
      const int64_t e0 = xt.start[ox + x], e1 = xt.start[ox + x + 1];
      for (int64_t ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int64_t e = e0; e < e1; ++e) acc = acc + s[xt.index[e] * c + ch] * xt.weight[e];
        o[x * c + ch] = acc;
      }
    }
  }
  for (int64_t y = 0; y < wh; ++y) {
    const int64_t e0 = yt.start[oy + y], e1 = yt.start[oy + y + 1];
    float* o = out + y * rw;
    for (int64_t i = 0; i < rw; ++i) o[i] = 0.f;
    for (int64_t e = e0; e < e1; ++e) {
      const float* row = &rows[(yt.index[e] - r0) * rw];
      const float wt = yt.weight[e];
      for (int64_t i = 0; i < rw; ++i) o[i] = o[i] + row[i] * wt;
    }
  }
}

// image._area_fast: an integer shrink (fy, fx); each output the float32 sum
// of its cell's pixels, row-major in groups of four
// (total + (((a + b) + c) + d)), the rest one by one, times
// float32(1 / (fy fx)); for a 2 x 2 shrink of 1 or 4 channels, the values of
// a full output row before its last (row length mod 4) are
// ((a + b) + (c + d)) * 0.25 (OpenCV's vector loop).
void area_fast(const float* src, int64_t sw, int64_t c, int64_t dw, int64_t fy, int64_t fx,
               int64_t oy, int64_t ox, int64_t wh, int64_t ww, float* out) {
  const float inv = float(1.0 / double(fy * fx));
  const bool vector = fy == 2 && fx == 2 && (c == 1 || c == 4);
  const int64_t nvec = vector ? (dw * c) / 4 * 4 : 0;
  const int64_t n = fy * fx;
  std::vector<const float*> cell(n);
  for (int64_t y = 0; y < wh; ++y) {
    const int64_t sy = (oy + y) * fy;
    for (int64_t x = 0; x < ww; ++x) {
      const int64_t sx = (ox + x) * fx;
      for (int64_t i = 0; i < fy; ++i)
        for (int64_t j = 0; j < fx; ++j) cell[i * fx + j] = src + ((sy + i) * sw + sx + j) * c;
      for (int64_t ch = 0; ch < c; ++ch) {
        float* o = out + (y * ww + x) * c + ch;
        if ((ox + x) * c + ch < nvec) {
          *o = ((cell[0][ch] + cell[1][ch]) + (cell[2][ch] + cell[3][ch])) * 0.25f;
          continue;
        }
        float total = 0.f;
        int64_t k = 0;
        for (; k + 4 <= n; k += 4)
          total = total + (((cell[k][ch] + cell[k + 1][ch]) + cell[k + 2][ch]) + cell[k + 3][ch]);
        for (; k < n; ++k) total = total + cell[k][ch];
        *o = total * inv;
      }
    }
  }
}

// image._linear_taps for one axis: per destination index the two source
// indices and the float32 weight of the second, the ratio ssize / dsize.
void linear_taps(int64_t ssize, int64_t dsize, std::vector<int64_t>* s0, std::vector<int64_t>* s1,
                 std::vector<float>* frac) {
  const double scale = double(ssize) / double(dsize);
  s0->resize(dsize);
  s1->resize(dsize);
  frac->resize(dsize);
  for (int64_t d = 0; d < dsize; ++d) {
    const double f = (double(d) + 0.5) * scale - 0.5;
    const double fl = std::floor(f);
    int64_t s = int64_t(fl);
    float a = float(f - fl);
    if (s < 0 || s >= ssize - 1) {
      a = 0.f;
      s = s < 0 ? 0 : ssize - 1;
    }
    (*s0)[d] = s;
    (*s1)[d] = std::min(s + 1, ssize - 1);
    (*frac)[d] = a;
  }
}

// image._lerp: a + (b - a) t, b - a in float32, the product and sum in
// double, rounded once to float32 at the end.
inline float lerp(float a, float b, float t) {
  return float(double(b - a) * double(t) + double(a));
}

// image._lerp_twice: the product and the sum each rounded to float32.
inline float lerp_twice(float a, float b, float t) { return (b - a) * t + a; }

// image._edge_runs: the float elements of a row (indices into [dw * c])
// whose vertical tap pair IPP rounds twice. Each clamped region (n pixels
// from its first) is blocks of 16 pixels, rounded twice at 4 channels, and
// the remainder n % 16, rounded twice when it is 5 pixels or more: every
// channel at 4 channels, channels 0 and 1 at 3.
std::vector<int64_t> edge_runs(int64_t sw, int64_t dw, int64_t c) {
  const double scale = double(sw) / double(dw);
  int64_t left = 0, right = 0;
  for (int64_t d = 0; d < dw; ++d) {
    const double f = (double(d) + 0.5) * scale - 0.5;
    left += f < 0;
    right += f >= double(sw - 1);
  }
  std::vector<int64_t> out;
  const int64_t starts[2] = {0, dw - right}, counts[2] = {left, right};
  for (int k = 0; k < 2; ++k) {
    const int64_t start = starts[k], n = counts[k], tail = start + n / 16 * 16;
    for (int64_t x = start; x < start + n; ++x)
      for (int64_t ch = 0; ch < c; ++ch) {
        const bool in_block = x < tail && c == 4;
        const bool in_rest = x >= tail && n % 16 >= 5 && (c == 4 || (c == 3 && ch < 2));
        if (in_block || in_rest) out.push_back(x * c + ch);
      }
  }
  return out;
}

// image._SDIV and image._HDIV180: round((255 << 12) / v) and
// round((180 << 12) / (6 v)), half to even, 0 at 0.
struct HsvTables {
  int64_t sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int v = 1; v < 256; ++v) {
      sdiv[v] = int64_t(std::nearbyint(double(255 << 12) / double(v)));
      hdiv[v] = int64_t(std::nearbyint(double(180 << 12) / (6.0 * double(v))));
    }
  }
};

// image._SECTORS: per sector the table entries of (b, g, r)
constexpr int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

}  // namespace

extern "C" {

// cv2 INTER_AREA shrink of float32 [sh, sw, c] to (dh, dw), the window
// (oy, ox, wh, ww) of it into out [wh, ww, c]; fy, fx > 0 take the integer
// path (image._area_fast) with those factors, 0 the fractional one.
int resize_area_f32(const float* src, int64_t sh, int64_t sw, int64_t c, int64_t dh, int64_t dw,
                    int64_t fy, int64_t fx, int64_t oy, int64_t ox, int64_t wh, int64_t ww,
                    float* out) {
  if (sh < 1 || sw < 1 || c < 1 || dh < 1 || dw < 1 || dh > sh || dw > sw ||
      bad_window(dh, dw, oy, ox, wh, ww))
    return kBadArgument;
  if (fy > 0 && fx > 0) {
    if (dh * fy > sh || dw * fx > sw) return kBadArgument;
    area_fast(src, sw, c, dw, fy, fx, oy, ox, wh, ww, out);
  } else {
    area_general(src, sh, sw, c, dh, dw, oy, ox, wh, ww, out);
  }
  return kOk;
}

// The same shrink of uint8 [sh, sw, c] (image.resize_area's uint8 rules): an
// integer shrink sums each cell exactly, then a 2 x 2 one of 1, 3 or 4
// channels rounds half up, (sum + 2) >> 2, and any other takes
// float32(sum) * float32(1 / n) to nearest, ties to even; a fractional
// shrink takes the float32 path and rounds the same way, clamped to 0-255.
int resize_area_u8(const uint8_t* src, int64_t sh, int64_t sw, int64_t c, int64_t dh, int64_t dw,
                   int64_t fy, int64_t fx, int64_t oy, int64_t ox, int64_t wh, int64_t ww,
                   uint8_t* out) {
  if (sh < 1 || sw < 1 || c < 1 || dh < 1 || dw < 1 || dh > sh || dw > sw ||
      bad_window(dh, dw, oy, ox, wh, ww))
    return kBadArgument;
  if (fy > 0 && fx > 0) {
    if (dh * fy > sh || dw * fx > sw) return kBadArgument;
    const bool half_up = fy == 2 && fx == 2 && (c == 1 || c == 3 || c == 4);
    const float inv = 1.0f / float(fy * fx);
    for (int64_t y = 0; y < wh; ++y)
      for (int64_t x = 0; x < ww; ++x)
        for (int64_t ch = 0; ch < c; ++ch) {
          int64_t sum = 0;
          for (int64_t i = 0; i < fy; ++i)
            for (int64_t j = 0; j < fx; ++j)
              sum += src[(((oy + y) * fy + i) * sw + (ox + x) * fx + j) * c + ch];
          out[(y * ww + x) * c + ch] =
              half_up ? uint8_t((sum + 2) >> 2)
                      : uint8_t(std::min(std::nearbyint(float(sum) * inv), 255.f));
        }
    return kOk;
  }
  std::vector<float> f(sh * sw * c), o(wh * ww * c);
  for (int64_t i = 0; i < sh * sw * c; ++i) f[i] = float(src[i]);
  area_general(f.data(), sh, sw, c, dh, dw, oy, ox, wh, ww, o.data());
  for (int64_t i = 0; i < wh * ww * c; ++i)
    out[i] = uint8_t(std::min(std::max(std::nearbyint(o[i]), 0.f), 255.f));
  return kOk;
}

// cv2 INTER_NEAREST of [sh, sw] pixels of `pixel` bytes each to (dh, dw)
// into out: source index floor(d * (1 / (dst / src))) in double, clamped
// to the last pixel.
int resize_nearest(const uint8_t* src, int64_t sh, int64_t sw, int64_t pixel, int64_t dh,
                   int64_t dw, uint8_t* out) {
  if (sh < 1 || sw < 1 || pixel < 1 || dh < 1 || dw < 1) return kBadArgument;
  const double fy = 1.0 / (double(dh) / double(sh)), fx = 1.0 / (double(dw) / double(sw));
  std::vector<int64_t> xs(dw);
  for (int64_t x = 0; x < dw; ++x) xs[x] = std::min(int64_t(std::floor(double(x) * fx)), sw - 1);
  for (int64_t y = 0; y < dh; ++y) {
    const int64_t sy = std::min(int64_t(std::floor(double(y) * fy)), sh - 1);
    const uint8_t* s = src + sy * sw * pixel;
    uint8_t* o = out + y * dw * pixel;
    for (int64_t x = 0; x < dw; ++x) std::memcpy(o + x * pixel, s + xs[x] * pixel, pixel);
  }
  return kOk;
}

// cv2 INTER_LINEAR of float32 [sh, sw, c] to (dh, dw) into out: the
// horizontal pass over every source row, then the vertical one, each tap
// pair lerped, the vertical pair rounded twice where edge_runs says
// (image.resize_linear).
int resize_linear_f32(const float* src, int64_t sh, int64_t sw, int64_t c, int64_t dh,
                      int64_t dw, float* out) {
  if (sh < 1 || sw < 1 || c < 1 || dh < 1 || dw < 1) return kBadArgument;
  std::vector<int64_t> x0, x1, y0, y1;
  std::vector<float> ax, ay;
  linear_taps(sw, dw, &x0, &x1, &ax);
  linear_taps(sh, dh, &y0, &y1, &ay);
  const std::vector<int64_t> twice = edge_runs(sw, dw, c);
  const int64_t rw = dw * c;
  std::vector<float> rows(sh * rw);
  for (int64_t r = 0; r < sh; ++r) {
    const float* s = src + r * sw * c;
    float* o = &rows[r * rw];
    for (int64_t x = 0; x < dw; ++x) {
      const float* a = s + x0[x] * c;
      const float* b = s + x1[x] * c;
      for (int64_t ch = 0; ch < c; ++ch) o[x * c + ch] = lerp(a[ch], b[ch], ax[x]);
    }
  }
  for (int64_t y = 0; y < dh; ++y) {
    const float* a = &rows[y0[y] * rw];
    const float* b = &rows[y1[y] * rw];
    float* o = out + y * rw;
    for (int64_t i = 0; i < rw; ++i) o[i] = lerp(a[i], b[i], ay[y]);
    for (int64_t i : twice) o[i] = lerp_twice(a[i], b[i], ay[y]);
  }
  return kOk;
}

// transforms' hue step on float32 [h, w, 3] RGB in one pass per pixel:
// (img * 255) truncated to uint8, cv2's RGB -> HSV (image.rgb_to_hsv_u8's
// 12-bit tables), the hue plus `shift` mod 180, cv2's HSV -> RGB
// (image.hsv_to_rgb_u8: the float32 sector formula with its fused
// 1 - s h, truncated in the first w // 32 * 32 pixels of each row, rounded
// half to even after them), then / 255 to float32.
void hue_shift_f32(const float* src, int64_t h, int64_t w, int shift, float* out) {
  static const HsvTables t;
  const int64_t half = 1 << 11;
  const float kh = 6.0f / 180.0f, k255 = 1.0f / 255.0f;
  const int64_t nvec = w / 32 * 32;
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      const float* p = src + (y * w + x) * 3;
      const int64_t r = uint8_t(int32_t(p[0] * 255.0f)), g = uint8_t(int32_t(p[1] * 255.0f)),
                    b = uint8_t(int32_t(p[2] * 255.0f));
      const int64_t v = std::max(std::max(b, g), r), vmin = std::min(std::min(b, g), r);
      const int64_t diff = v - vmin;
      const int64_t sat = (diff * t.sdiv[v] + half) >> 12;
      int64_t hue = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
      hue = (hue * t.hdiv[diff] + half) >> 12;
      if (hue < 0) hue += 180;
      hue = std::min<int64_t>(std::max<int64_t>(hue, 0), 255);
      hue = ((hue + shift) % 180 + 180) % 180;
      float hf = float(hue) * kh;
      const float s = float(sat) * k255, val = float(v) * k255;
      const float sector = std::floor(hf);
      hf = hf - sector;
      const int sec = ((int(sector) % 6) + 6) % 6;
      const float tab[4] = {val, val * (1.0f - s), val * float(1.0 - double(s) * double(hf)),
                            val * float(1.0 - double(s) * double(1.0f - hf))};
      const float bgr[3] = {tab[kSectors[sec][0]], tab[kSectors[sec][1]], tab[kSectors[sec][2]]};
      float* o = out + (y * w + x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float f = bgr[2 - ch] * 255.0f;
        const float q = x < nvec ? std::trunc(f) : std::nearbyint(f);
        o[ch] = float(uint8_t(std::min(std::max(q, 0.f), 255.f))) / 255.0f;
      }
    }
}

}  // extern "C"
