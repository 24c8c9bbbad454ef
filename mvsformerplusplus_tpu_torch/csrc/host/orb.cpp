// OpenCV's ORB as the scene converter runs it (cv2.ORB_create(nfeatures)
// then detectAndCompute on a gray image, and BFMatcher(NORM_HAMMING)'s
// knnMatch with k = 2), step for step in OpenCV's arithmetic so that the
// keypoints, their order and the descriptors are cv2's, and the three
// OpenCV primitives it runs: RGB -> gray, the bit-exact uint8 linear resize
// (INTER_LINEAR_EXACT) and the Gaussian blur of each pyramid level.
//
// Each call runs in the calling thread. Images are contiguous row-major
// uint8. data/native.py builds this file with -ffp-contract=off: every
// float product and sum rounds on its own, as OpenCV's x86 baseline build
// (no FMA) rounds them in orb.cpp and fast.cpp. std::nth_element and
// std::partition are libstdc++'s, the same algorithms OpenCV's
// KeyPointsFilter::retainBest runs, so ties keep OpenCV's order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int { kOk = 0, kBadArgument = 5 };

// rBRIEF's 256 point pairs for a 31 x 31 patch, (x, y) of the first point
// then of the second: OpenCV's bit_pattern_31_ (modules/features2d orb.cpp,
// Apache-2.0). tests/data/make_orb_fixtures.py checks it against the table
// in cv2's binary.
// BEGIN bit_pattern_31
const int kBitPattern31[256 * 4] = {
      8,  -3,   9,   5,   4,   2,   7, -12, -11,   9,  -8,   2,   7, -12,  12, -13,
      2, -13,   2,  12,   1,  -7,   1,   6,  -2, -10,  -2,  -4, -13, -13, -11,  -8,
    -13,  -3, -12,  -9,  10,   4,  11,   9, -13,  -8,  -8,  -9, -11,   7,  -9,  12,
      7,   7,  12,   6,  -4,  -5,  -3,   0, -13,   2, -12,  -3,  -9,   0,  -7,   5,
     12,  -6,  12,  -1,  -3,   6,  -2,  12,  -6, -13,  -4,  -8,  11, -13,  12,  -8,
      4,   7,   5,   1,   5,  -3,  10,  -3,   3,  -7,   6,  12,  -8,  -7,  -6,  -2,
     -2,  11,  -1, -10, -13,  12,  -8,  10,  -7,   3,  -5,  -3,  -4,   2,  -3,   7,
    -10, -12,  -6,  11,   5, -12,   6,  -7,   5,  -6,   7,  -1,   1,   0,   4,  -5,
      9,  11,  11, -13,   4,   7,   4,  12,   2,  -1,   4,   4,  -4, -12,  -2,   7,
     -8,  -5,  -7, -10,   4,  11,   9,  12,   0,  -8,   1, -13, -13,  -2,  -8,   2,
     -3,  -2,  -2,   3,  -6,   9,  -4,  -9,   8,  12,  10,   7,   0,   9,   1,   3,
      7,  -5,  11, -10, -13,  -6, -11,   0,  10,   7,  12,   1,  -6,  -3,  -6,  12,
     10,  -9,  12,  -4, -13,   8,  -8, -12, -13,   0,  -8,  -4,   3,   3,   7,   8,
      5,   7,  10,  -7,  -1,   7,   1, -12,   3, -10,   5,   6,   2,  -4,   3, -10,
    -13,   0, -13,   5, -13,  -7, -12,  12, -13,   3, -11,   8,  -7,  12,  -4,   7,
      6, -10,  12,   8,  -9,  -1,  -7,  -6,  -2,  -5,   0,  12, -12,   5,  -7,   5,
      3, -10,   8, -13,  -7,  -7,  -4,   5,  -3,  -2,  -1,  -7,   2,   9,   5, -11,
    -11, -13,  -5, -13,  -1,   6,   0,  -1,   5,  -3,   5,   2,  -4, -13,  -4,  12,
     -9,  -6,  -9,   6, -12, -10,  -8,  -4,  10,   2,  12,  -3,   7,  12,  12,  12,
     -7, -13,  -6,   5,  -4,   9,  -3,   4,   7,  -1,  12,   2,  -7,   6,  -5,   1,
    -13,  11, -12,   5,  -3,   7,  -2,  -6,   7,  -8,  12,  -7, -13,  -7, -11, -12,
      1,  -3,  12,  12,   2,  -6,   3,   0,  -4,   3,  -2, -13,  -1, -13,   1,   9,
      7,   1,   8,  -6,   1,  -1,   3,  12,   9,   1,  12,   6,  -1,  -9,  -1,   3,
    -13, -13, -10,   5,   7,   7,  10,  12,  12,  -5,  12,   9,   6,   3,   7,  11,
      5, -13,   6,  10,   2, -12,   2,   3,   3,   8,   4,  -6,   2,   6,  12, -13,
      9, -12,  10,   3,  -8,   4,  -7,   9, -11,  12,  -4,  -6,   1,  12,   2,  -8,
      6,  -9,   7,  -4,   2,   3,   3,  -2,   6,   3,  11,   0,   3,  -3,   8,  -8,
      7,   8,   9,   3, -11,  -5,  -6,  -4, -10,  11,  -5,  10,  -5,  -8,  -3,  12,
    -10,   5,  -9,   0,   8,  -1,  12,  -6,   4,  -6,   6, -11, -10,  12,  -8,   7,
      4,  -2,   6,   7,  -2,   0,  -2,  12,  -5,  -8,  -5,   2,   7,  -6,  10,  12,
     -9, -13,  -8,  -8,  -5, -13,  -5,  -2,   8,  -8,   9, -13,  -9, -11,  -9,   0,
      1,  -8,   1,  -2,   7,  -4,   9,   1,  -2,   1,  -1,  -4,  11,  -6,  12, -11,
    -12,  -9,  -6,   4,   3,   7,   7,  12,   5,   5,  10,   8,   0,  -4,   2,   8,
     -9,  12,  -5, -13,   0,   7,   2,  12,  -1,   2,   1,   7,   5,  11,   7,  -9,
      3,   5,   6,  -8, -13,  -4,  -8,   9,  -5,   9,  -3,  -3,  -4,  -7,  -3, -12,
      6,   5,   8,   0,  -7,   6,  -6,  12, -13,   6,  -5,  -2,   1, -10,   3,  10,
      4,   1,   8,  -4,  -2,  -2,   2, -13,   2, -12,  12,  12,  -2, -13,   0,  -6,
      4,   1,   9,   3,  -6, -10,  -3,  -5,  -3, -13,  -1,   1,   7,   5,  12, -11,
      4,  -2,   5,  -7, -13,   9,  -9,  -5,   7,   1,   8,   6,   7,  -8,   7,   6,
     -7,  -4,  -7,   1,  -8,  11,  -7,  -8, -13,   6, -12,  -8,   2,   4,   3,   9,
     10,  -5,  12,   3,  -6,  -5,  -6,   7,   8,  -3,   9,  -8,   2, -12,   2,   8,
    -11,  -2, -10,   3, -12, -13,  -7,  -9, -11,   0, -10,  -5,   5,  -3,  11,   8,
     -2, -13,  -1,  12,  -1,  -8,   0,   9, -13, -11, -12,  -5, -10,  -2, -10,  11,
     -3,   9,  -2, -13,   2,  -3,   3,   2,  -9, -13,  -4,   0,  -4,   6,  -3, -10,
     -4,  12,  -2,  -7,  -6, -11,  -4,   9,   6,  -3,   6,  11, -13,  11,  -5,   5,
     11,  11,  12,   6,   7,  -5,  12,  -2,  -1,  12,   0,   7,  -4,  -8,  -3,  -2,
     -7,   1,  -6,   7, -13, -12,  -8, -13,  -7,  -2,  -6,  -8,  -8,   5,  -6,  -9,
     -5,  -1,  -4,   5, -13,   7,  -8,  10,   1,   5,   5, -13,   1,   0,  10, -13,
      9,  12,  10,  -1,   5,  -8,  10,  -9,  -1,  11,   1, -13,  -9,  -3,  -6,   2,
     -1, -10,   1,  12, -13,   1,  -8, -10,   8, -11,  10,  -6,   2, -13,   3,  -6,
      7, -13,  12,  -9, -10, -10,  -5,  -7, -10,  -8,  -8, -13,   4,  -6,   8,   5,
      3,  12,   8, -13,  -4,   2,  -3,  -3,   5, -13,  10, -12,   4, -13,   5,  -1,
     -9,   9,  -4,   3,   0,   3,   3,  -9, -12,   1,  -6,   1,   3,   2,   4,  -8,
    -10, -10, -10,   9,   8, -13,  12,  12,  -8, -12,  -6,  -5,   2,   2,   3,   7,
     10,   6,  11,  -8,   6,   8,   8, -12,  -7,  10,  -6,   5,  -3,  -9,  -3,   9,
     -1, -13,  -1,   5,  -3,  -7,  -3,   4,  -8,  -2,  -8,   3,   4,   2,  12,  12,
      2,  -5,   3,  11,   6,  -9,  11, -13,   3,  -1,   7,  12,  11,  -1,  12,   4,
     -3,   0,  -3,   6,   4, -11,   4,  12,   2,  -4,   2,   1, -10,  -6,  -8,   1,
    -13,   7, -11,   1, -13,  12, -11, -13,   6,   0,  11, -13,   0,  -1,   1,   4,
    -13,   3,  -9,  -2,  -9,   8,  -6,  -3, -13,  -6,  -8,  -2,   5,  -9,   8,  10,
      2,   7,   3,  -9,  -1,  -6,  -1,  -1,   9,   5,  11,  -2,  11,  -3,  12,  -8,
      3,   0,   3,   5,  -1,   4,   0,  10,   3,  -6,   4,   5, -13,   0, -10,   5,
      5,   8,  12,  11,   8,   9,   9,  -6,   7,  -4,   8, -12, -10,   4, -10,   9,
      7,   3,  12,   4,   9,  -7,  10,  -2,   7,   0,  12,  -2,  -1,  -6,   0, -11};
// END bit_pattern_31

inline int round_f(float v) { return int(std::lrint(v)); }   // cvRound(float)
inline int round_d(double v) { return int(std::lrint(v)); }  // cvRound(double)

struct KeyPoint {
  float x, y, size, angle, response;
  int octave;
};

// ---------------------------------------------------------------- FAST-9

// FAST_t<16>'s circle: offsets (x, y) of its 16 pixels, then 9 repeated.
const int kCircle[16][2] = {{0, 3},  {1, 3},   {2, 2},   {3, 1},   {3, 0},  {3, -1},
                            {2, -2}, {1, -3},  {0, -3},  {-1, -3}, {-2, -2}, {-3, -1},
                            {-3, 0}, {-3, 1},  {-2, 2},  {-1, 3}};

// cornerScore<16>: the largest t such that 9 contiguous circle pixels are
// all brighter or all darker than the centre by more than t, at least
// threshold - 1 (OpenCV's max over the 16 arcs, its pruning left out).
int corner_score(const uint8_t* p, const int* pixel, int threshold) {
  const int v = p[0];
  int d[25];
  for (int k = 0; k < 25; ++k) d[k] = v - p[pixel[k]];
  int a0 = threshold;
  for (int k = 0; k < 16; ++k) {
    int a = d[k];
    for (int j = 1; j < 9; ++j) a = std::min(a, d[k + j]);
    a0 = std::max(a0, a);
  }
  int b0 = -a0;
  for (int k = 0; k < 16; ++k) {
    int b = d[k];
    for (int j = 1; j < 9; ++j) b = std::max(b, d[k + j]);
    b0 = std::min(b0, b);
  }
  return -b0 - 1;
}

// FAST_t<16> with non-max suppression over an [h, w] image with row stride
// `step`: keypoints (x, y, score) in OpenCV's order (row by row, then by
// column), appended to out.
void fast9(const uint8_t* img, int64_t step, int h, int w, int threshold,
           std::vector<KeyPoint>* out) {
  int pixel[25];
  for (int k = 0; k < 16; ++k) pixel[k] = kCircle[k][0] + kCircle[k][1] * int(step);
  for (int k = 16; k < 25; ++k) pixel[k] = pixel[k - 16];
  threshold = std::min(std::max(threshold, 0), 255);
  uint8_t tab[512];
  for (int i = -255; i <= 255; ++i)
    tab[i + 255] = uint8_t(i < -threshold ? 1 : i > threshold ? 2 : 0);
  std::vector<uint8_t> buf(3 * std::max(w, 1), 0);
  std::vector<int> cpbuf(3 * (std::max(w, 1) + 1), 0);
  uint8_t* rows[3] = {&buf[0], &buf[w], &buf[2 * w]};
  int* cps[3] = {&cpbuf[1], &cpbuf[w + 2], &cpbuf[2 * w + 3]};
  for (int i = 3; i < h - 2; ++i) {
    uint8_t* curr = rows[(i - 3) % 3];
    int* cornerpos = cps[(i - 3) % 3];
    std::memset(curr, 0, w);
    int ncorners = 0;
    if (i < h - 3) {
      for (int j = 3; j < w - 3; ++j) {
        const uint8_t* p = img + int64_t(i) * step + j;
        const int v = p[0];
        const uint8_t* t = tab - v + 255;
        int d = t[p[pixel[0]]] | t[p[pixel[8]]];
        if (d == 0) continue;
        d &= t[p[pixel[2]]] | t[p[pixel[10]]];
        d &= t[p[pixel[4]]] | t[p[pixel[12]]];
        d &= t[p[pixel[6]]] | t[p[pixel[14]]];
        if (d == 0) continue;
        d &= t[p[pixel[1]]] | t[p[pixel[9]]];
        d &= t[p[pixel[3]]] | t[p[pixel[11]]];
        d &= t[p[pixel[5]]] | t[p[pixel[13]]];
        d &= t[p[pixel[7]]] | t[p[pixel[15]]];
        for (int dark = 1; dark >= 0; --dark) {
          if (!(d & (dark ? 1 : 2))) continue;
          const int vt = dark ? v - threshold : v + threshold;
          int count = 0;
          for (int k = 0; k < 25; ++k) {
            const int x = p[pixel[k]];
            if (dark ? x < vt : x > vt) {
              if (++count > 8) {
                cornerpos[ncorners++] = j;
                curr[j] = uint8_t(corner_score(p, pixel, threshold));
                break;
              }
            } else {
              count = 0;
            }
          }
        }
      }
    }
    cornerpos[-1] = ncorners;
    if (i == 3) continue;
    const uint8_t* prev = rows[(i - 4 + 3) % 3];
    const uint8_t* pprev = rows[(i - 5 + 3) % 3];
    const int* pos = cps[(i - 4 + 3) % 3];
    for (int k = 0; k < pos[-1]; ++k) {
      const int j = pos[k];
      const int s = prev[j];
      if (s > prev[j + 1] && s > prev[j - 1] && s > pprev[j - 1] && s > pprev[j] &&
          s > pprev[j + 1] && s > curr[j - 1] && s > curr[j] && s > curr[j + 1])
        out->push_back(KeyPoint{float(j), float(i - 1), 7.f, -1.f, float(s), 0});
    }
  }
}

// ------------------------------------------------------------- resample

// One axis of OpenCV's interpolationLinear<uint8_t> (INTER_LINEAR_EXACT):
// per destination index the first source index and the 8-bit fixed-point
// weight of the second (0 where clamped to an edge), the position
// (d + 0.5) / (dsize / ssize) - 0.5 in double.
void exact_taps(int64_t ssize, int64_t dsize, std::vector<int64_t>* ofs, std::vector<int>* m1) {
  const double scale = 1.0 / (double(dsize) / double(ssize));
  ofs->assign(dsize, 0);
  m1->assign(dsize, 0);
  for (int64_t d = 0; d < dsize; ++d) {
    const double f = scale * (double(d) + 0.5) - 0.5;
    const int64_t i = int64_t(std::floor(f));
    if (i >= 0 && ssize > 1) {
      if (i < ssize - 1) {
        (*ofs)[d] = i;
        (*m1)[d] = round_d((f - double(i)) * 256.0);
      } else {
        (*ofs)[d] = ssize - 1;
      }
    }
  }
}

void resize_exact(const uint8_t* src, int64_t sh, int64_t sw, int64_t c, int64_t dh, int64_t dw,
                  uint8_t* out) {
  if (sh == dh && sw == dw) {
    std::memcpy(out, src, size_t(sh * sw * c));
    return;
  }
  if (sh == 2 * dh && sw == 2 * dw && c != 2) {  // OpenCV takes INTER_AREA's exact halving
    for (int64_t y = 0; y < dh; ++y)
      for (int64_t x = 0; x < dw; ++x)
        for (int64_t ch = 0; ch < c; ++ch) {
          const uint8_t* p = src + ((2 * y) * sw + 2 * x) * c + ch;
          const int s = p[0] + p[c] + p[sw * c] + p[sw * c + c];
          out[(y * dw + x) * c + ch] = uint8_t((s + 2) >> 2);
        }
    return;
  }
  std::vector<int64_t> xo, yo;
  std::vector<int> xm, ym;
  exact_taps(sw, dw, &xo, &xm);
  exact_taps(sh, dh, &yo, &ym);
  std::vector<int32_t> rows(sh * dw * c);
  for (int64_t r = 0; r < sh; ++r)
    for (int64_t x = 0; x < dw; ++x) {
      const uint8_t* a = src + (r * sw + xo[x]) * c;
      const uint8_t* b = src + (r * sw + std::min(xo[x] + 1, sw - 1)) * c;
      for (int64_t ch = 0; ch < c; ++ch)
        rows[(r * dw + x) * c + ch] = a[ch] * (256 - xm[x]) + b[ch] * xm[x];
    }
  const int64_t rw = dw * c;
  for (int64_t y = 0; y < dh; ++y) {
    const int32_t* a = &rows[yo[y] * rw];
    const int32_t* b = &rows[std::min(yo[y] + 1, sh - 1) * rw];
    for (int64_t i = 0; i < rw; ++i)
      out[y * rw + i] =
          uint8_t((int64_t(a[i]) * (256 - ym[y]) + int64_t(b[i]) * ym[y] + 32768) >> 16);
  }
}

inline int64_t reflect101(int64_t i, int64_t n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

// cv2.sepFilter2D(src, -1, k, k, borderType=BORDER_REFLECT_101) for uint8
// [h, w] and a symmetric float32 kernel of odd length n: OpenCV's float
// path, which GaussianBlur takes for a view into a larger image (ORB's
// pyramid levels). The row pass sums k[j] x[j] in order with fused
// multiply-adds in the x86 build's 32-pixel vector blocks and with separate
// roundings in the scalar loop after them; the column pass is the centre
// tap's product, then a fused multiply-add per pair of taps (k[j] (above +
// below)); cvRound to uint8.
#if defined(__x86_64__)
__attribute__((target_clones("fma", "default")))  // fma in hardware where the CPU has it
#endif
void blur_sep(const uint8_t* src, int64_t h, int64_t w, const float* k, int n, uint8_t* out) {
  const int r = n / 2;
  const int64_t nvec = w / 32 * 32;
  std::vector<float> rows(h * w), line(w + 2 * r);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = src + y * w;
    for (int64_t x = -r; x < w + r; ++x) line[x + r] = float(row[reflect101(x, w)]);
    float* o = &rows[y * w];
    for (int64_t x = 0; x < nvec; ++x) {
      float s = k[0] * line[x];
      for (int j = 1; j < n; ++j) s = std::fma(line[x + j], k[j], s);
      o[x] = s;
    }
    for (int64_t x = nvec; x < w; ++x) {
      float s = k[0] * line[x];
      for (int j = 1; j < n; ++j) s = s + k[j] * line[x + j];
      o[x] = s;
    }
  }
  std::vector<float> acc(w);
  for (int64_t y = 0; y < h; ++y) {
    const float* c = &rows[y * w];
    for (int64_t x = 0; x < w; ++x) acc[x] = k[r] * c[x];
    for (int j = 1; j <= r; ++j) {
      const float* below = &rows[reflect101(y + j, h) * w];
      const float* above = &rows[reflect101(y - j, h) * w];
      for (int64_t x = 0; x < w; ++x) acc[x] = std::fma(k[r + j], below[x] + above[x], acc[x]);
    }
    for (int64_t x = 0; x < w; ++x)
      out[y * w + x] = uint8_t(std::min(std::max(round_f(acc[x]), 0), 255));
  }
}

// ------------------------------------------------------------------ ORB

struct ResponseGreater {
  bool operator()(const KeyPoint& a, const KeyPoint& b) const { return a.response > b.response; }
};

// KeyPointsFilter::retainBest: the n best by response, and every point
// tied with the n-th.
void retain_best(std::vector<KeyPoint>* kp, int n) {
  if (n < 0 || int64_t(kp->size()) <= n) return;
  if (n == 0) {
    kp->clear();
    return;
  }
  std::nth_element(kp->begin(), kp->begin() + n - 1, kp->end(), ResponseGreater());
  const float amb = (*kp)[n - 1].response;
  auto end = std::partition(kp->begin() + n, kp->end(),
                            [amb](const KeyPoint& p) { return p.response >= amb; });
  kp->resize(end - kp->begin());
}

// One pyramid level: its pixels with a reflect-101 border of `border` on
// every side (ORB's copyMakeBorder), row stride `step`.
struct Level {
  int w = 0, h = 0, border = 0;
  int64_t step = 0;
  std::vector<uint8_t> buf;
  uint8_t* at(int y, int x) { return &buf[(int64_t(y) + border) * step + x + border]; }
  const uint8_t* at(int y, int x) const { return &buf[(int64_t(y) + border) * step + x + border]; }
  void make(const uint8_t* img, int hh, int ww, int b) {
    h = hh;
    w = ww;
    border = b;
    step = w + 2 * b;
    buf.assign(size_t(step * (h + 2 * b)), 0);
    std::vector<int64_t> xs(w + 2 * b);
    for (int x = -b; x < w + b; ++x) xs[x + b] = reflect101(x, w);
    for (int y = -b; y < h + b; ++y) {
      const uint8_t* row = img + reflect101(y, h) * w;
      uint8_t* o = &buf[(int64_t(y) + b) * step];
      for (int x = 0; x < b; ++x) o[x] = row[xs[x]];
      std::memcpy(o + b, row, size_t(w));
      for (int x = w + b; x < w + 2 * b; ++x) o[x] = row[xs[x]];
    }
  }
  std::vector<uint8_t> interior() const {
    std::vector<uint8_t> out(size_t(w) * h);
    for (int y = 0; y < h; ++y) std::memcpy(&out[size_t(y) * w], at(y, 0), w);
    return out;
  }
};

void harris(const std::vector<Level>& levels, std::vector<KeyPoint>* pts, int block, float k) {
  const int r = block / 2;
  const float scale = 1.f / ((1 << 2) * block * 255.f);
  const float scale4 = scale * scale * scale * scale;
  for (KeyPoint& p : *pts) {
    const Level& L = levels[p.octave];
    const int64_t step = L.step;
    const uint8_t* p0 = L.at(round_f(p.y) - r, round_f(p.x) - r);
    int a = 0, b = 0, c = 0;
    for (int i = 0; i < block; ++i)
      for (int j = 0; j < block; ++j) {
        const uint8_t* q = p0 + i * step + j;
        const int ix =
            (q[1] - q[-1]) * 2 + (q[-step + 1] - q[-step - 1]) + (q[step + 1] - q[step - 1]);
        const int iy =
            (q[step] - q[-step]) * 2 + (q[step - 1] - q[-step - 1]) + (q[step + 1] - q[-step + 1]);
        a += ix * ix;
        b += iy * iy;
        c += ix * iy;
      }
    const float fa = float(a), fb = float(b), fc = float(c);
    p.response = (fa * fb - fc * fc - k * (fa + fb) * (fa + fb)) * scale4;
  }
}

// cv::fastAtan2: degrees in [0, 360) from a 7th-order polynomial.
float fast_atan2(float y, float x) {
  const float p1 = 0.9997878412794807f * float(180 / M_PI);
  const float p3 = -0.3258083974640975f * float(180 / M_PI);
  const float p5 = 0.1555786518463281f * float(180 / M_PI);
  const float p7 = -0.04432655554792128f * float(180 / M_PI);
  const float ax = std::fabs(x), ay = std::fabs(y);
  float a;
  if (ax >= ay) {
    const float c = ay / (ax + float(2.220446049250313e-16)), c2 = c * c;
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
  } else {
    const float c = ax / (ay + float(2.220446049250313e-16)), c2 = c * c;
    a = 90.f - (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

// ICAngles: the intensity centroid's angle over the circular patch of
// radius `half` (umax: each row's half width).
void ic_angles(const std::vector<Level>& levels, std::vector<KeyPoint>* pts,
               const std::vector<int>& umax, int half) {
  for (KeyPoint& p : *pts) {
    const Level& L = levels[p.octave];
    const int64_t step = L.step;
    const uint8_t* c = L.at(round_f(p.y), round_f(p.x));
    int m01 = 0, m10 = 0;
    for (int u = -half; u <= half; ++u) m10 += u * c[u];
    for (int v = 1; v <= half; ++v) {
      int vsum = 0;
      const int d = umax[v];
      for (int u = -d; u <= d; ++u) {
        const int plus = c[u + v * step], minus = c[u - v * step];
        vsum += plus - minus;
        m10 += u * (plus + minus);
      }
      m01 += v * vsum;
    }
    p.angle = fast_atan2(float(m01), float(m10));
  }
}

}  // namespace

extern "C" {

// The rBRIEF point pairs, 1024 int32 (orb_detect_compute's table).
void orb_pattern(int32_t* out) {
  for (int i = 0; i < 256 * 4; ++i) out[i] = kBitPattern31[i];
}

// cv2.cvtColor(rgb, COLOR_RGB2GRAY) for n uint8 RGB pixels: OpenCV's
// 15-bit fixed point, (9798 R + 19235 G + 3735 B + 2^14) >> 15.
void rgb_to_gray_u8(const uint8_t* rgb, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = rgb + 3 * i;
    out[i] = uint8_t((p[0] * 9798 + p[1] * 19235 + p[2] * 3735 + (1 << 14)) >> 15);
  }
}

// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR_EXACT) for uint8
// [sh, sw, c]: 8-bit fixed-point taps, the horizontal pass exact in int,
// the vertical one rounded once ((sum + 2^15) >> 16); OpenCV's exact
// halving (INTER_AREA, (a + b + c + d + 2) >> 2) when both sides halve.
int resize_linear_exact_u8(const uint8_t* src, int64_t sh, int64_t sw, int64_t c, int64_t dh,
                           int64_t dw, uint8_t* out) {
  if (sh < 1 || sw < 1 || c < 1 || dh < 1 || dw < 1) return kBadArgument;
  resize_exact(src, sh, sw, c, dh, dw, out);
  return kOk;
}

// blur_sep (cv2.sepFilter2D's float path) of a uint8 [h, w] image with a
// symmetric kernel of n float32 taps (n odd).
int blur_sep_u8(const uint8_t* src, int64_t h, int64_t w, const float* k, int n, uint8_t* out) {
  if (h < 1 || w < 1 || n < 1 || n % 2 == 0) return kBadArgument;
  blur_sep(src, h, w, k, n, out);
  return kOk;
}

// FastFeatureDetector_create(threshold, True).detect on uint8 [h, w]: up
// to cap keypoints as (x, y, score) float32 rows in OpenCV's order.
// Returns their count, or minus the count when more than cap.
int64_t fast9_u8(const uint8_t* img, int64_t h, int64_t w, int threshold, float* out, int64_t cap) {
  std::vector<KeyPoint> kp;
  fast9(img, w, int(h), int(w), threshold, &kp);
  const int64_t n = int64_t(kp.size());
  if (n > cap) return -n;
  for (int64_t i = 0; i < n; ++i) {
    out[3 * i] = kp[i].x;
    out[3 * i + 1] = kp[i].y;
    out[3 * i + 2] = kp[i].response;
  }
  return n;
}

// cv2.ORB_create(nfeatures, scale_factor, nlevels, edge_threshold, 0, 2,
// HARRIS_SCORE, patch_size = 31, fast_threshold).detectAndCompute(gray,
// None) on uint8 [h, w]: keypoints as float32 rows (x, y, size, angle,
// response, octave) into kp_out and 32-byte descriptors into desc_out, in
// cv2's order, at most cap of them. `pattern` is the 1024-int32 rBRIEF
// table (null: OpenCV's), `blur_taps` the 7 float taps of the descriptor's Gaussian blur,
// harris_k the Harris constant (OpenCV's 0.04f). Returns the keypoint
// count, minus it when more than cap, or -2^40 for bad arguments.
int64_t orb_detect_compute(const uint8_t* gray, int64_t h, int64_t w, int nfeatures,
                           double scale_factor, int nlevels, int edge_threshold,
                           int fast_threshold, float harris_k, const int32_t* pattern,
                           const float* blur_taps, float* kp_out, uint8_t* desc_out,
                           int64_t cap) {
  const int64_t kBad = -(int64_t(1) << 40);
  if (h < 1 || w < 1 || nlevels < 1 || nfeatures < 0 || scale_factor <= 1.0) return kBad;
  const int patch = 31, half = patch / 2;
  const int desc_patch = int(std::ceil(half * std::sqrt(2.0)));
  const int border = std::max(edge_threshold, std::max(desc_patch, 9 / 2)) + 1;
  if (pattern == nullptr) pattern = kBitPattern31;

  // the pyramid: level sizes from the float inverse scale, each level the
  // exact linear resize of the one before
  std::vector<float> scales(nlevels);
  std::vector<Level> levels(nlevels);
  std::vector<uint8_t> prev(gray, gray + h * w);
  int ph = int(h), pw = int(w);
  for (int lv = 0; lv < nlevels; ++lv) {
    scales[lv] = float(std::pow(scale_factor, double(lv)));
    const float inv = 1.0f / scales[lv];
    const int lw = round_f(float(w) * inv), lh = round_f(float(h) * inv);
    if (lw < 1 || lh < 1) return kBad;
    std::vector<uint8_t> cur(size_t(lw) * lh);
    if (lv == 0)
      cur = prev;
    else
      resize_exact(prev.data(), ph, pw, 1, lh, lw, cur.data());
    levels[lv].make(cur.data(), lh, lw, border);
    prev.swap(cur);
    ph = lh;
    pw = lw;
  }

  // features per level
  std::vector<int> per_level(nlevels);
  const float factor = float(1.0 / scale_factor);
  float desired = float(nfeatures) * (1 - factor) /
                  (1 - float(std::pow(double(factor), double(nlevels))));
  int sum = 0;
  for (int lv = 0; lv < nlevels - 1; ++lv) {
    per_level[lv] = round_f(desired);
    sum += per_level[lv];
    desired *= factor;
  }
  per_level[nlevels - 1] = std::max(nfeatures - sum, 0);

  // umax: the half width of each row of the circular patch
  std::vector<int> umax(half + 2);
  const int vmax = int(std::floor(half * std::sqrt(2.f) / 2 + 1));
  const int vmin = int(std::ceil(half * std::sqrt(2.f) / 2));
  for (int v = 0; v <= vmax; ++v) umax[v] = round_d(std::sqrt(double(half) * half - v * v));
  for (int v = half, v0 = 0; v >= vmin; --v) {
    while (umax[v0] == umax[v0 + 1]) ++v0;
    umax[v] = v0;
    ++v0;
  }

  // FAST per level, the border filter, the best 2n by FAST score
  std::vector<KeyPoint> all;
  std::vector<int> counts(nlevels);
  for (int lv = 0; lv < nlevels; ++lv) {
    Level& L = levels[lv];
    std::vector<KeyPoint> kp;
    fast9(L.at(0, 0), L.step, L.h, L.w, fast_threshold, &kp);
    if (L.h <= edge_threshold * 2 || L.w <= edge_threshold * 2) {
      kp.clear();
    } else if (edge_threshold > 0) {
      const float x0 = float(edge_threshold), y0 = float(edge_threshold);
      const float x1 = float(L.w - edge_threshold), y1 = float(L.h - edge_threshold);
      kp.erase(std::remove_if(kp.begin(), kp.end(), [&](const KeyPoint& p) {
                 return !(x0 <= p.x && p.x < x1 && y0 <= p.y && p.y < y1);
               }), kp.end());
    }
    retain_best(&kp, 2 * per_level[lv]);
    for (KeyPoint& p : kp) {
      p.octave = lv;
      p.size = patch * scales[lv];
    }
    counts[lv] = int(kp.size());
    all.insert(all.end(), kp.begin(), kp.end());
  }
  if (all.empty()) return 0;

  // Harris responses, then the best n of each level by them
  harris(levels, &all, 7, harris_k);
  std::vector<KeyPoint> kept;
  int64_t offset = 0;
  for (int lv = 0; lv < nlevels; ++lv) {
    std::vector<KeyPoint> kp(all.begin() + offset, all.begin() + offset + counts[lv]);
    offset += counts[lv];
    retain_best(&kp, per_level[lv]);
    kept.insert(kept.end(), kp.begin(), kp.end());
  }
  ic_angles(levels, &kept, umax, half);
  for (KeyPoint& p : kept) {
    const float s = scales[p.octave];
    p.x *= s;
    p.y *= s;
  }
  const int64_t n = int64_t(kept.size());
  if (n > cap) return -n;

  // rBRIEF on each level blurred (7 x 7, reflect-101)
  for (Level& L : levels) {
    std::vector<uint8_t> img = L.interior(), out(img.size());
    blur_sep(img.data(), L.h, L.w, blur_taps, 7, out.data());
    for (int y = 0; y < L.h; ++y) std::memcpy(L.at(y, 0), &out[size_t(y) * L.w], L.w);
  }
  for (int64_t j = 0; j < n; ++j) {
    const KeyPoint& p = kept[j];
    const Level& L = levels[p.octave];
    const float scale = 1.f / scales[p.octave];
    const float angle = p.angle * float(M_PI / 180.f);
    const float a = float(std::cos(double(angle))), b = float(std::sin(double(angle)));
    const uint8_t* c = L.at(round_f(p.y * scale), round_f(p.x * scale));
    const int64_t step = L.step;
    auto value = [&](int idx) {
      const float x = pattern[2 * idx] * a - pattern[2 * idx + 1] * b;
      const float y = pattern[2 * idx] * b + pattern[2 * idx + 1] * a;
      return int(c[round_f(y) * step + round_f(x)]);
    };
    uint8_t* desc = desc_out + 32 * j;
    for (int i = 0; i < 32; ++i) {
      int val = 0;
      for (int bit = 0; bit < 8; ++bit) {
        const int idx = 16 * i + 2 * bit;
        val |= (value(idx) < value(idx + 1)) << bit;
      }
      desc[i] = uint8_t(val);
    }
    float* o = kp_out + 6 * j;
    o[0] = p.x;
    o[1] = p.y;
    o[2] = p.size;
    o[3] = p.angle;
    o[4] = p.response;
    o[5] = float(p.octave);
  }
  return n;
}

// BFMatcher(NORM_HAMMING).knnMatch(a, b, k=2) on 32-byte descriptors: per
// row of a the two rows of b nearest in Hamming distance, the first index
// winning a tie, into idx [na, 2] and dist [na, 2] (-1 where b has fewer
// rows).
#if defined(__x86_64__)
__attribute__((target("popcnt")))  // the popcnt instruction; the counts are the same
#endif
void hamming_knn2(const uint8_t* a, int64_t na, const uint8_t* b, int64_t nb, int32_t* idx,
                  int32_t* dist) {
  for (int64_t i = 0; i < na; ++i) {
    uint64_t q[4], t[4];
    std::memcpy(q, a + 32 * i, 32);
    int d0 = INT32_MAX, d1 = INT32_MAX, i0 = -1, i1 = -1;
    for (int64_t j = 0; j < nb; ++j) {
      std::memcpy(t, b + 32 * j, 32);
      const int d = __builtin_popcountll(q[0] ^ t[0]) + __builtin_popcountll(q[1] ^ t[1]) +
                    __builtin_popcountll(q[2] ^ t[2]) + __builtin_popcountll(q[3] ^ t[3]);
      if (d < d1) {
        if (d0 > d) {
          d1 = d0;
          i1 = i0;
          d0 = d;
          i0 = int(j);
        } else {
          d1 = d;
          i1 = int(j);
        }
      }
    }
    idx[2 * i] = i0;
    idx[2 * i + 1] = i1;
    dist[2 * i] = i0 < 0 ? -1 : d0;
    dist[2 * i + 1] = i1 < 0 ? -1 : d1;
  }
}

}  // extern "C"
