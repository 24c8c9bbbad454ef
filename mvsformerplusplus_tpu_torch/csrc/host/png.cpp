// PNG row unfiltering (PNG specification, section 9): filter types None,
// Sub, Up, Average and Paeth, row by row, each byte from its left (a),
// upper (b) and upper-left (c) neighbours, the row above the first and the
// pixels left of each row being zero.

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: h rows of (1 + stride) bytes, each a filter type byte then the
// filtered row; out: h x stride reconstructed bytes; bpp: bytes per pixel.
// Returns 0, or 6 when a row's filter type is not 0-4 (out is then partial).
int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int bpp, uint8_t* out) {
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t f = raw[r * (stride + 1)];
    const uint8_t* x = raw + r * (stride + 1) + 1;
    uint8_t* o = out + r * stride;
    const uint8_t* up = r ? o - stride : nullptr;
    switch (f) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) o[i] = x[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) o[i] = x[i] + (i >= bpp ? o[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) o[i] = x[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = x[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          o[i] = x[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
        }
        break;
      default:
        return 6;
    }
  }
  return 0;
}

}  // extern "C"
