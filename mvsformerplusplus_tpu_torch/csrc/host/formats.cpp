// The byte-level decoders of the BMP and TIFF readers in data/io.py: TIFF's
// LZW and PackBits strips and tiles, and BMP's RLE8 and RLE4 pixel data;
// and the LZW encoder of the TIFF writer in data/synthetic.py. The headers,
// the Deflate streams (zlib), the predictor and the colour conversions stay
// in numpy. Each call runs in the calling thread.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int { kOk = 0, kCorrupt = 1, kBadArgument = 5 };

}  // namespace

extern "C" {

// TIFF LZW (compression 5): codes MSB first, 9 to 12 bits wide, the width
// growing one code early, Clear 256, EndOfInformation 257. Writes at most
// cap bytes to dst; returns the bytes written, or -1 for a corrupt stream.
int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  uint8_t stack[4096];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xffff;
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  int next = 258, width = 9, old = -1;
  int64_t out = 0, bitpos = 0;
  const int64_t nbits = n * 8;
  while (bitpos + width <= nbits) {
    int code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      width = 9;
      old = -1;
      continue;
    }
    int cur;
    if (old < 0) {
      if (code > 255) return -1;
      cur = code;
    } else if (code < next) {
      cur = code;
      if (next < 4096) {
        prefix[next] = uint16_t(old);
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = uint16_t(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = uint16_t(old);
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = uint16_t(length[old] + 1);
      cur = next++;
    } else {
      return -1;
    }
    int sp = 0;
    for (int c = cur; c != 0xffff; c = prefix[c]) stack[sp++] = suffix[c];
    for (int i = sp - 1; i >= 0 && out < cap; --i) dst[out++] = stack[i];
    old = cur;
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  return out;
}

// The TIFF LZW stream of n bytes (what tiff_lzw_decode reads back): Clear
// first and whenever the table is full, codes MSB first, the width growing
// one code early, EndOfInformation last. dst must hold 2 n + 8 bytes;
// returns the bytes written.
int64_t tiff_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst) {
  std::vector<int16_t> child(4096 * 256, -1);
  int next = 258, width = 9;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t out = 0;
  auto emit = [&](int code) {
    acc = (acc << width) | uint64_t(code);
    nacc += width;
    while (nacc >= 8) {
      dst[out++] = uint8_t(acc >> (nacc - 8));
      nacc -= 8;
    }
  };
  emit(256);
  if (n > 0) {
    int cur = src[0];
    for (int64_t i = 1; i < n; ++i) {
      const uint8_t b = src[i];
      const int c = child[cur * 256 + b];
      if (c >= 0) {
        cur = c;
        continue;
      }
      emit(cur);
      child[cur * 256 + b] = int16_t(next++);
      if (next >= (1 << width) && width < 12) ++width;
      if (next >= 4094) {
        emit(256);
        std::fill(child.begin(), child.end(), int16_t(-1));
        next = 258;
        width = 9;
      }
      cur = b;
    }
    emit(cur);
  }
  emit(257);
  if (nacc > 0) dst[out++] = uint8_t(acc << (8 - nacc));
  return out;
}

// PackBits (compression 32773): n in 0..127 copies the next n + 1 bytes,
// -127..-1 repeats the next byte 1 - n times, -128 is skipped. Returns
// the bytes written (at most cap).
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = int8_t(src[i++]);
    if (c >= 0) {
      for (int k = 0; k <= c && i < n && out < cap; ++k) dst[out++] = src[i++];
    } else if (c != -128) {
      if (i >= n) break;
      const uint8_t v = src[i++];
      for (int k = 0; k < 1 - c && out < cap; ++k) dst[out++] = v;
    }
  }
  return out;
}

// BMP RLE8 (bits 8) or RLE4 (bits 4) into palette indices dst [h, w], rows
// bottom-up as stored (row 0 of dst is the file's first, the bottom one).
// Encoded runs, absolute runs (padded to 16 bits), end of line, end of
// bitmap and delta escapes; pixels no code reaches stay index 0. Returns 0,
// or 1 when a run or delta leaves the image.
int bmp_rle_decode(const uint8_t* src, int64_t n, int64_t w, int64_t h, int bits, uint8_t* dst) {
  if (bits != 4 && bits != 8) return kBadArgument;
  std::memset(dst, 0, size_t(w * h));
  int64_t x = 0, y = 0, i = 0;
  auto put = [&](uint8_t v) {
    if (x >= w || y >= h) return false;
    dst[y * w + x++] = v;
    return true;
  };
  while (i + 1 < n) {
    const int count = src[i], value = src[i + 1];
    i += 2;
    if (count > 0) {
      for (int k = 0; k < count; ++k) {
        const uint8_t v = bits == 8 ? uint8_t(value)
                                    : uint8_t(k % 2 == 0 ? value >> 4 : value & 15);
        if (!put(v)) return kCorrupt;
      }
    } else if (value == 0) {
      x = 0;
      ++y;
    } else if (value == 1) {
      break;
    } else if (value == 2) {
      if (i + 1 >= n) return kCorrupt;
      x += src[i];
      y += src[i + 1];
      i += 2;
      if (x > w || y > h) return kCorrupt;
    } else {
      const int64_t nbytes = bits == 8 ? value : (value + 1) / 2;
      if (i + nbytes > n) return kCorrupt;
      for (int k = 0; k < value; ++k) {
        const uint8_t b = src[i + (bits == 8 ? k : k / 2)];
        const uint8_t v = bits == 8 ? b : uint8_t(k % 2 == 0 ? b >> 4 : b & 15);
        if (!put(v)) return kCorrupt;
      }
      i += nbytes + (nbytes & 1);
    }
  }
  return kOk;
}

}  // extern "C"
