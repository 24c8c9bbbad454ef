// JPEG, the per-symbol and per-pixel work of data/jpeg.py's numpy codec in
// C++, step for step the same integer arithmetic (libjpeg-turbo's),
// so it gives the numpy codec's pixels and bytes. Marker parsing, tables and
// error messages stay in Python; these return an error code it turns into
// the numpy codec's ValueError.
//
// decode: jpeg_decode_scan Huffman-decodes one sequential scan (every restart
// interval) straight into the coefficient array, jpeg_decode_progressive one
// scan of a progressive file (jdphuff.c's four kinds: DC first, DC
// refinement, AC first with EOB runs, AC refinement with its correction
// bits), jpeg_decode_arith one arithmetic-coded scan, sequential or
// progressive (jdarith.c, with the DAC marker's conditioning), and
// jpeg_decode_lossless / jpeg_undifference a lossless scan's differences
// and its predictors (jdlhuff.c, jdlossls.c); jpeg_reconstruct dequantises,
// runs the islow IDCT (jidctint.c),
// crops, upsamples 4:2:2 / 4:2:0 chroma (fancy, jdsample.c) and converts
// YCbCr to RGB (jdcolor.c), or YCCK to inverted CMYK as PIL reads Adobe
// files.
// encode: jpeg_encode_entropy converts RGB to YCbCr (jccolor.c) with edge
// replication to whole 16 x 16 MCUs, downsamples chroma h2v2 (jcsample.c),
// runs the islow forward DCT (jfdctint.c), quantises by libjpeg-turbo's
// reciprocals (jcdctmgr.c) and writes the Huffman-coded, byte-stuffed scan.
//
// Every value is int64, as the numpy codec's, so a hostile file's large
// coefficients wrap nowhere; every read is bounds-checked.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int {
  kOk = 0,
  kCorrupt = 1,       // invalid code, read past the end, DC out of range
  kAcPastEnd = 2,     // AC coefficients run past the end of a block
  kBadTable = 3,      // Huffman codes overflow their lengths
  kNoCode = 4,        // encode: a symbol has no Huffman code
  kBadArgument = 5,   // block offsets or sizes outside the buffers
};

// a DHT table lists at most 16 x 255 symbols
constexpr int kMaxSymbols = 16 * 255;

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// islow constants: FIX(x) = round(x * 2^13)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270;
constexpr int64_t F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137;
constexpr int64_t F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

constexpr int64_t fix16(double x) { return int64_t(x * 65536 + 0.5); }

// ------------------------------------------------------------ entropy decode

// The 16-bit look-ahead table of one Huffman table: per 16-bit prefix of the
// bit stream, the length of the code it starts with (0: no code) and that
// code's symbol.
struct Lookup {
  std::vector<uint8_t> len, sym;
};

int build_lookup(const uint8_t* counts, const uint8_t* symbols, int nsym, Lookup* t) {
  t->len.assign(1 << 16, 0);
  t->sym.assign(1 << 16, 0);
  int64_t code = 0;
  int k = 0;
  for (int length = 1; length <= 16; ++length) {
    for (int i = 0; i < counts[length - 1]; ++i, ++code, ++k) {
      if (k >= nsym || (code >> length)) return kBadTable;
      const int64_t lo = code << (16 - length), n = int64_t(1) << (16 - length);
      std::memset(&t->len[lo], length, n);
      std::memset(&t->sym[lo], symbols[k], n);
    }
    code <<= 1;
  }
  return kOk;
}

// The destuffed bytes of one restart interval, read as the numpy decoder's
// 24-bit windows: zeros past the end, and reading a window that starts two
// or more bytes past the end fails.
struct BitReader {
  const uint8_t* b;
  int64_t n;
  inline int byte(int64_t i) const { return i < n ? b[i] : 0; }
  // the 16 bits at bit p into *w; false past the readable windows
  inline bool peek(int64_t p, uint32_t* w) const {
    const int64_t i = p >> 3;
    if (i >= n + 2) return false;
    const uint32_t v = (uint32_t(byte(i)) << 16) | (uint32_t(byte(i + 1)) << 8) | byte(i + 2);
    *w = (v >> (8 - (p & 7))) & 0xFFFF;
    return true;
  }
};

inline int64_t extend(int64_t t, int s) {
  if (s == 0) return 0;
  return (t >> (s - 1)) ? t : t - (int64_t(1) << s) + 1;
}

// One symbol and its value bits at bit *p: as the numpy tables, the value
// comes from the same 16-bit window when code and value fit in 16 bits,
// else from a second window after the code.
inline int read_symbol(const BitReader& br, const Lookup& t, int64_t* p, int* sym,
                       int64_t* value) {
  uint32_t w;
  if (!br.peek(*p, &w)) return kCorrupt;
  const int len = t.len[w];
  if (!len) return kCorrupt;
  *sym = t.sym[w];
  const int s = *sym & 15;
  if (len + s <= 16) {
    *value = extend((w >> (16 - len - s)) & ((1u << s) - 1), s);
    *p += len + s;
  } else {
    *p += len;
    if (!br.peek(*p, &w)) return kCorrupt;
    *value = extend(w >> (16 - s), s);
    *p += s;
  }
  return kOk;
}

int decode_interval(const BitReader& br, const int64_t* bases, const int32_t* slots,
                    int64_t nblocks, const Lookup* dc, const Lookup* ac, int nslots,
                    int64_t* coefs, int64_t ncoefs) {
  int64_t pred[4] = {0, 0, 0, 0};
  int64_t p = 0;
  for (int64_t i = 0; i < nblocks; ++i) {
    const int ci = slots[i];
    const int64_t base = bases[i];
    if (ci < 0 || ci >= nslots || base < 0 || base + 64 > ncoefs) return kBadArgument;
    int sym;
    int64_t v;
    int err = read_symbol(br, dc[ci], &p, &sym, &v);
    if (err) return err;
    pred[ci] += v;
    // the numpy decoder packs each value in 16 bits beside its index
    if (pred[ci] < -32768 || pred[ci] > 32767) return kCorrupt;
    coefs[base] = pred[ci];
    int k = 1;
    while (k < 64) {
      err = read_symbol(br, ac[ci], &p, &sym, &v);
      if (err) return err;
      k += sym == 0 ? 128 : sym >> 4;  // EOB ends the block; ZRL skips 16 with value 0
      if (v && k < 64) coefs[base + kZigzag[k]] = v;
      ++k;
    }
    if (k > 64 && k < 128) return kAcPastEnd;
  }
  return kOk;
}

// One progressive scan's restart interval (jdphuff.c): `tables` per slot
// the DC table (DC first) or the AC table (AC scans; one slot). Bits read
// as BitReader's windows; a symbol's size is its low four bits, as in the
// sequential decoder. A coefficient outside JCOEF's 16 bits is corrupt
// data, and an AC coefficient past Se ends the block with kAcPastEnd.
struct Progressive {
  const BitReader& br;
  int64_t p = 0;
  bool get_bits(int n, int64_t* v) {
    if (n == 0) {
      *v = 0;
      return true;
    }
    uint32_t w;
    if (!br.peek(p, &w)) return false;
    *v = w >> (16 - n);
    p += n;
    return true;
  }
  bool symbol(const Lookup& t, int* sym) {
    uint32_t w;
    if (!br.peek(p, &w) || !t.len[w]) return false;
    *sym = t.sym[w];
    p += t.len[w];
    return true;
  }
};

inline bool in_jcoef(int64_t v) { return v >= -32768 && v <= 32767; }

// the refinement of an already non-zero coefficient: one correction bit
inline int refine(Progressive& pr, int64_t* c, int64_t p1) {
  int64_t bit;
  if (!pr.get_bits(1, &bit)) return kCorrupt;
  if (bit && (*c & p1) == 0) *c += *c >= 0 ? p1 : -p1;
  return in_jcoef(*c) ? kOk : kCorrupt;
}

int decode_progressive_interval(const BitReader& br, const int64_t* bases, const int32_t* slots,
                                int64_t nblocks, const Lookup* tables, int nslots, int ss, int se,
                                int ah, int al, int64_t* coefs, int64_t ncoefs) {
  Progressive pr{br};
  int64_t pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  const int64_t p1 = int64_t(1) << al;
  for (int64_t i = 0; i < nblocks; ++i) {
    const int ci = slots[i];
    const int64_t base = bases[i];
    if (ci < 0 || ci >= nslots || base < 0 || base + 64 > ncoefs) return kBadArgument;
    int64_t* blk = coefs + base;
    int64_t v;
    int sym;
    if (ss == 0 && ah == 0) {  // DC first
      if (!pr.symbol(tables[ci], &sym)) return kCorrupt;
      const int s = sym & 15;
      if (!pr.get_bits(s, &v)) return kCorrupt;
      pred[ci] += extend(v, s);
      const int64_t dc = pred[ci] * p1;
      if (!in_jcoef(dc)) return kCorrupt;
      blk[0] = dc;
    } else if (ss == 0) {  // DC refinement
      if (!pr.get_bits(1, &v)) return kCorrupt;
      if (v) blk[0] |= p1;
    } else if (ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        continue;
      }
      for (int k = ss; k <= se; ++k) {
        if (!pr.symbol(tables[ci], &sym)) return kCorrupt;
        const int r = sym >> 4, s = sym & 15;
        if (s) {
          k += r;
          if (k > se) return kAcPastEnd;
          if (!pr.get_bits(s, &v)) return kCorrupt;
          const int64_t ac = extend(v, s) * p1;
          if (!in_jcoef(ac)) return kCorrupt;
          blk[kZigzag[k]] = ac;
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = int64_t(1) << r;
          if (r) {
            if (!pr.get_bits(r, &v)) return kCorrupt;
            eobrun += v;
          }
          --eobrun;
          break;
        }
      }
    } else {  // AC refinement
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          if (!pr.symbol(tables[ci], &sym)) return kCorrupt;
          int r = sym >> 4;
          int64_t s = sym & 15;
          if (s) {  // a newly non-zero coefficient, its sign in one bit
            if (!pr.get_bits(1, &v)) return kCorrupt;
            s = v ? p1 : -p1;
          } else if (r != 15) {
            eobrun = int64_t(1) << r;
            if (r) {
              if (!pr.get_bits(r, &v)) return kCorrupt;
              eobrun += v;
            }
            break;
          }
          // skip r zero coefficients, refining the non-zero ones passed
          do {
            int64_t* c = blk + kZigzag[k];
            if (*c != 0) {
              const int err = refine(pr, c, p1);
              if (err) return err;
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) {
            if (k > se) return kAcPastEnd;
            blk[kZigzag[k]] = s;
          }
        }
      }
      if (eobrun > 0) {  // the band's rest: refine its non-zero coefficients
        for (; k <= se; ++k) {
          int64_t* c = blk + kZigzag[k];
          if (*c != 0) {
            const int err = refine(pr, c, p1);
            if (err) return err;
          }
        }
        --eobrun;
      }
    }
  }
  return kOk;
}

// ------------------------------------------------------ arithmetic decode

// Table D.3 of ITU-T T.81 as jaricom.c packs it: per state Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; state 113 is the
// fixed one-half estimate of sign and DC-refinement bits
constexpr int64_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
};

// jdarith.c's arith_decode on one restart interval's destuffed bytes,
// zeros past their end (libjpeg supplies zeros after a marker)
struct ArithDecoder {
  const uint8_t* b;
  int64_t n, pos = 0, c = 0, a = 0;
  int ct = -16;
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | (pos < n ? b[pos] : 0);
        ++pos;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF), nm = int((qe >> 8) & 0xFF);
    qe >>= 16;
    a -= qe;
    const int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

inline int64_t wrap16(int64_t v) { return int64_t(int16_t(uint16_t(v & 0xFFFF))); }

// Figures F.23 and F.24: further magnitude-category bits from bin `top`
// (m the category so far, a power of two), then the magnitude bits 14 bins
// after the last category bin; |v| - 1 into *v, false past 15 bits
inline bool arith_magnitude(ArithDecoder& d, uint8_t* stats, int top, int64_t m, int64_t* v) {
  int st = top;
  while (d.decode(stats + st)) {
    if ((m <<= 1) == 0x8000) return false;
    ++st;
  }
  *v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(stats + st)) *v |= m;
  return true;
}

// an AC coefficient's value (Figures F.21-F.24), its bins from st
inline bool arith_ac_value(ArithDecoder& d, uint8_t* stats, uint8_t* fixed, int st, int k,
                           int kx, int64_t* out) {
  const int sign = d.decode(fixed);
  st += 2;
  int64_t v = 0;
  if (d.decode(stats + st)) {
    if (!d.decode(stats + st)) {
      v = 1;
    } else if (!arith_magnitude(d, stats, k <= kx ? 189 : 217, 2, &v)) {
      return false;
    }
  }
  *out = sign ? -(v + 1) : v + 1;
  return true;
}

struct ArithScan {
  int progressive, ss, se, ah, al;
  const int32_t* tables;  // per slot DC, AC conditioning table
  const int32_t *dc_l, *dc_u, *ac_k;
};

// One restart interval of an arithmetic-coded scan (jdarith.c's
// decode_mcu, decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine),
// statistics, DC predictions and contexts afresh
int decode_arith_interval(const ArithScan& sc, ArithDecoder& d, const int64_t* bases,
                          const int32_t* slots, int64_t nblocks, int nslots, int64_t* coefs,
                          int64_t ncoefs) {
  uint8_t dc_stats[4][64], ac_stats[4][256], fixed = 113;
  std::memset(dc_stats, 0, sizeof dc_stats);
  std::memset(ac_stats, 0, sizeof ac_stats);
  int64_t last[4] = {0, 0, 0, 0};
  int ctx[4] = {0, 0, 0, 0};
  const int64_t p1 = int64_t(1) << sc.al;
  for (int64_t b = 0; b < nblocks; ++b) {
    const int ci = slots[b];
    const int64_t base = bases[b];
    if (ci < 0 || ci >= nslots || base < 0 || base + 64 > ncoefs) return kBadArgument;
    int64_t* c = coefs + base;
    const int td = sc.tables[2 * ci], ta = sc.tables[2 * ci + 1];
    uint8_t* ac = ac_stats[ta];
    if (!sc.progressive || (sc.ss == 0 && sc.ah == 0)) {  // DC
      uint8_t* st = dc_stats[td];
      if (d.decode(st + ctx[ci]) == 0) {
        ctx[ci] = 0;
      } else {
        const int sign = d.decode(st + ctx[ci] + 1);
        const int at = ctx[ci] + 2 + sign;
        int64_t v = 0, m = 0;
        if (d.decode(st + at)) {
          if (!arith_magnitude(d, st, 20, 1, &v)) return kCorrupt;
          m = int64_t(1) << (63 - __builtin_clzll(uint64_t(v)));
        }
        if (m < ((int64_t(1) << sc.dc_l[td]) >> 1))
          ctx[ci] = 0;
        else if (m > ((int64_t(1) << sc.dc_u[td]) >> 1))
          ctx[ci] = 12 + 4 * sign;
        else
          ctx[ci] = 4 + 4 * sign;
        last[ci] = (last[ci] + (sign ? -(v + 1) : v + 1)) & 0xFFFF;
      }
      c[0] = wrap16(last[ci] << sc.al);
      if (sc.progressive) continue;
      int k = 0;
      while (k < 63) {
        int st3 = 3 * k;
        if (d.decode(ac + st3)) break;
        for (;;) {
          ++k;
          if (d.decode(ac + st3 + 1)) break;
          st3 += 3;
          if (k >= 63) return kAcPastEnd;
        }
        int64_t v;
        if (!arith_ac_value(d, ac, &fixed, st3, k, sc.ac_k[ta], &v)) return kCorrupt;
        c[kZigzag[k]] = wrap16(v);
      }
    } else if (sc.ss == 0) {  // DC refinement
      if (d.decode(&fixed)) c[0] |= p1;
    } else if (sc.ah == 0) {  // AC first
      for (int k = sc.ss; k <= sc.se; ++k) {
        int st3 = 3 * (k - 1);
        if (d.decode(ac + st3)) break;
        while (d.decode(ac + st3 + 1) == 0) {
          st3 += 3;
          if (++k > sc.se) return kAcPastEnd;
        }
        int64_t v;
        if (!arith_ac_value(d, ac, &fixed, st3, k, sc.ac_k[ta], &v)) return kCorrupt;
        c[kZigzag[k]] = wrap16(v << sc.al);
      }
    } else {  // AC refinement
      int kex = sc.se;
      while (kex > 0 && !c[kZigzag[kex]]) --kex;
      for (int k = sc.ss; k <= sc.se; ++k) {
        int st3 = 3 * (k - 1);
        if (k > kex && d.decode(ac + st3)) break;
        for (;;) {
          int64_t* coef = c + kZigzag[k];
          if (*coef) {
            if (d.decode(ac + st3 + 2)) *coef = wrap16(*coef + (*coef < 0 ? -p1 : p1));
            break;
          }
          if (d.decode(ac + st3 + 1)) {
            *coef = d.decode(&fixed) ? -p1 : p1;
            break;
          }
          st3 += 3;
          if (++k > sc.se) return kAcPastEnd;
        }
      }
    }
  }
  return kOk;
}

// ---------------------------------------------------------------- lossless

// One Huffman-coded lossless difference (jdlhuff.c) at bit *p: category 16
// is 32768 with no value bits, a category past 16 is corrupt
inline int read_difference(const BitReader& br, const Lookup& t, int64_t* p, int64_t* value) {
  uint32_t w;
  if (!br.peek(*p, &w)) return kCorrupt;
  const int len = t.len[w];
  if (!len) return kCorrupt;
  const int s = t.sym[w];
  *p += len;
  if (s == 16) {
    *value = 32768;
  } else if (s > 16) {
    return kCorrupt;
  } else if (s) {
    if (!br.peek(*p, &w)) return kCorrupt;
    *value = extend(w >> (16 - s), s);
    *p += s;
  } else {
    *value = 0;
  }
  return kOk;
}

// -------------------------------------------------------------------- IDCT

// The islow butterfly on x[0..7] (stride apart): the eight sums before their
// descale.
inline void idct_1d(const int64_t* x, int stride, int64_t* o) {
  const int64_t x0 = x[0], x1 = x[stride], x2 = x[2 * stride], x3 = x[3 * stride];
  const int64_t x4 = x[4 * stride], x5 = x[5 * stride], x6 = x[6 * stride], x7 = x[7 * stride];
  int64_t z1 = (x2 + x6) * F0_541;
  const int64_t tmp2 = z1 - x6 * F1_847, tmp3 = z1 + x2 * F0_765;
  const int64_t tmp0 = (x0 + x4) * (int64_t(1) << kConstBits);
  const int64_t tmp1 = (x0 - x4) * (int64_t(1) << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x7, t1 = x5, t2 = x3, t3 = x1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * F1_175;
  t0 *= F0_298;
  t1 *= F2_053;
  t2 *= F3_072;
  t3 *= F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 = z3 * -F1_961 + z5;
  z4 = z4 * -F0_390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[1] = tmp11 + t2;
  o[2] = tmp12 + t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
  o[5] = tmp12 - t1;
  o[6] = tmp11 - t2;
  o[7] = tmp10 - t3;
}

// Dequantized coefficients (natural order) -> 8 x 8 samples into out with
// row pitch `pitch`: columns, then rows, clamped after the +128 shift. A
// column whose AC terms are all zero takes the butterfly's result directly
// (its eight outputs are x0 << 13).
void idct_islow(const int64_t* c, uint8_t* out, int64_t pitch) {
  int64_t ws[64], o[8];
  for (int j = 0; j < 8; ++j) {
    const int64_t* col = c + j;
    bool ac = false;
    for (int i = 1; i < 8; ++i) ac |= col[8 * i] != 0;
    if (!ac) {
      const int64_t v = descale(col[0] * (int64_t(1) << kConstBits), kConstBits - kPass1Bits);
      for (int i = 0; i < 8; ++i) ws[8 * i + j] = v;
      continue;
    }
    idct_1d(col, 8, o);
    for (int i = 0; i < 8; ++i) ws[8 * i + j] = descale(o[i], kConstBits - kPass1Bits);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* row = ws + 8 * r;
    idct_1d(row, 1, o);
    uint8_t* dst = out + r * pitch;
    for (int i = 0; i < 8; ++i) {
      const int64_t v = descale(o[i], kConstBits + kPass1Bits + 3) + 128;
      dst[i] = uint8_t(std::min<int64_t>(std::max<int64_t>(v, 0), 255));
    }
  }
}

// ---------------------------------------------------- upsampling, colour

// jdsample.c h2v1_fancy_upsample of a [h, w] plane into [h, 2w]; a plane 2
// or fewer samples wide is replicated.
void upsample_h2v1(const uint8_t* in, int64_t h, int64_t w, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* x = in + y * w;
    uint8_t* o = out + y * 2 * w;
    for (int64_t i = 0; i < w; ++i) {
      if (w <= 2) {
        o[2 * i] = o[2 * i + 1] = x[i];
        continue;
      }
      const int prev = x[i ? i - 1 : 0], next = x[i + 1 < w ? i + 1 : w - 1];
      o[2 * i] = uint8_t((3 * x[i] + prev + 1) >> 2);
      o[2 * i + 1] = uint8_t((3 * x[i] + next + 2) >> 2);
    }
  }
}

// jdsample.c h2v2_fancy_upsample of a [h, w] plane into [2h, 2w]: column
// sums 3 in[row] + the row above (upper output row) or below (lower), then
// (3 c[i] + c[i-1] + 8) >> 4 and (3 c[i] + c[i+1] + 7) >> 4, edges
// repeated; a plane 2 or fewer samples wide is replicated.
void upsample_h2v2(const uint8_t* in, int64_t h, int64_t w, uint8_t* out) {
  std::vector<int> sums(w);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* x = in + y * w;
    for (int half = 0; half < 2; ++half) {
      uint8_t* o = out + (2 * y + half) * 2 * w;
      if (w <= 2) {
        for (int64_t i = 0; i < w; ++i) o[2 * i] = o[2 * i + 1] = x[i];
        continue;
      }
      const int64_t ny = half ? std::min(y + 1, h - 1) : std::max<int64_t>(y - 1, 0);
      const uint8_t* n = in + ny * w;
      for (int64_t i = 0; i < w; ++i) sums[i] = 3 * x[i] + n[i];
      for (int64_t i = 0; i < w; ++i) {
        const int c = sums[i], prev = sums[i ? i - 1 : 0], next = sums[i + 1 < w ? i + 1 : w - 1];
        o[2 * i] = uint8_t((3 * c + prev + 8) >> 4);
        o[2 * i + 1] = uint8_t((3 * c + next + 7) >> 4);
      }
    }
  }
}

struct YccTables {
  int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const int64_t c = i - 128;
      cr_r[i] = (fix16(1.40200) * c + (1 << 15)) >> 16;
      cb_b[i] = (fix16(1.77200) * c + (1 << 15)) >> 16;
      cr_g[i] = -fix16(0.71414) * c;
      cb_g[i] = -fix16(0.34414) * c + (1 << 15);
    }
  }
};

inline uint8_t clamp_u8(int64_t v) { return uint8_t(std::min<int64_t>(std::max<int64_t>(v, 0), 255)); }

// ------------------------------------------------------------------ encode

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;  // pending bits, MSB first
  int nbits = 0;
  bool overflow = false;
  inline void put_byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }
  inline void put(uint64_t bits, int len) {
    acc = (acc << len) | (bits & ((uint64_t(1) << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte(uint8_t(acc >> nbits));
    }
  }
  void flush() {  // the last byte padded with 1 bits
    if (nbits) put(0x7F, 8 - nbits);
  }
};

inline int bit_length(int64_t v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// The forward butterfly on d[0..7] (stride apart) into o[0..7] (stride
// apart): the even outputs 0 and 4 shifted left by -even_shift when it is
// negative, else descaled by it; the rotated ones descaled by odd_shift.
inline void fdct_1d(const int64_t* d, int stride, int even_shift, int odd_shift, int64_t* o,
                    int ostride) {
  const int64_t tmp0 = d[0] + d[7 * stride], tmp7 = d[0] - d[7 * stride];
  const int64_t tmp1 = d[stride] + d[6 * stride], tmp6 = d[stride] - d[6 * stride];
  const int64_t tmp2 = d[2 * stride] + d[5 * stride], tmp5 = d[2 * stride] - d[5 * stride];
  const int64_t tmp3 = d[3 * stride] + d[4 * stride], tmp4 = d[3 * stride] - d[4 * stride];
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (even_shift < 0) {
    o[0] = (tmp10 + tmp11) * (int64_t(1) << -even_shift);
    o[4 * ostride] = (tmp10 - tmp11) * (int64_t(1) << -even_shift);
  } else {
    o[0] = descale(tmp10 + tmp11, even_shift);
    o[4 * ostride] = descale(tmp10 - tmp11, even_shift);
  }
  int64_t z1 = (tmp12 + tmp13) * F0_541;
  o[2 * ostride] = descale(z1 + tmp13 * F0_765, odd_shift);
  o[6 * ostride] = descale(z1 - tmp12 * F1_847, odd_shift);
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int64_t z5 = (z3 + z4) * F1_175;
  const int64_t t4 = tmp4 * F0_298, t5 = tmp5 * F2_053, t6 = tmp6 * F3_072, t7 = tmp7 * F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 = z3 * -F1_961 + z5;
  z4 = z4 * -F0_390 + z5;
  o[7 * ostride] = descale(t4 + z1 + z3, odd_shift);
  o[5 * ostride] = descale(t5 + z2 + z4, odd_shift);
  o[3 * ostride] = descale(t6 + z2 + z3, odd_shift);
  o[1 * ostride] = descale(t7 + z1 + z4, odd_shift);
}

// compute_reciprocal's divisors for a natural-order table of 64
struct Divisors {
  int64_t fq[64], c[64];
  int r[64];
  explicit Divisors(const int32_t* q) {
    for (int i = 0; i < 64; ++i) {
      const int64_t divisor = int64_t(q[i]) << 3;
      r[i] = 16 + bit_length(divisor) - 1;
      fq[i] = (int64_t(1) << r[i]) / divisor;
      const int64_t fr = (int64_t(1) << r[i]) % divisor;
      c[i] = divisor / 2;
      if (fr == 0) {
        fq[i] >>= 1;
        r[i] -= 1;
      } else if (fr <= divisor / 2) {
        c[i] += 1;
      } else {
        fq[i] += 1;
      }
    }
  }
};

// samples (8 x 8 with row pitch `pitch`) -> quantized coefficients in
// zigzag order
void fdct_quantize(const uint8_t* px, int64_t pitch, const Divisors& dv, int64_t* zz) {
  int64_t x[64], rows[64], out[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) x[8 * r + c] = int64_t(px[r * pitch + c]) - 128;
  for (int r = 0; r < 8; ++r)
    fdct_1d(x + 8 * r, 1, -kPass1Bits, kConstBits - kPass1Bits, rows + 8 * r, 1);
  for (int c = 0; c < 8; ++c)
    fdct_1d(rows + c, 8, kPass1Bits, kConstBits + kPass1Bits, out + c, 8);
  for (int k = 0; k < 64; ++k) {
    const int i = kZigzag[k];
    const int64_t a = out[i] < 0 ? -out[i] : out[i];
    const int64_t v = ((a + dv.c[i]) * dv.fq[i]) >> dv.r[i];
    zz[k] = out[i] < 0 ? -v : v;
  }
}

struct CodeTable {
  const int32_t* code;
  const int32_t* size;
};

inline bool put_symbol(BitWriter& bw, const CodeTable& t, int sym, int64_t value, int vsize) {
  const int len = t.size[sym];
  if (!len) return false;
  const uint64_t bits = uint64_t(value - (value < 0)) & ((uint64_t(1) << vsize) - 1);
  bw.put((uint64_t(t.code[sym]) << vsize) | bits, len + vsize);
  return true;
}

bool encode_block(BitWriter& bw, const int64_t* zz, int64_t* pred, const CodeTable& dc,
                  const CodeTable& ac) {
  const int64_t diff = zz[0] - *pred;
  *pred = zz[0];
  const int s = bit_length(diff < 0 ? -diff : diff);
  if (!put_symbol(bw, dc, s, diff, s)) return false;
  int run = 0, last = 0;
  for (int k = 1; k < 64; ++k) {
    const int64_t v = zz[k];
    if (!v) {
      ++run;
      continue;
    }
    for (; run >= 16; run -= 16)
      if (!put_symbol(bw, ac, 0xF0, 0, 0)) return false;
    const int size = bit_length(v < 0 ? -v : v);
    if (!put_symbol(bw, ac, (run & 15) << 4 | size, v, size)) return false;
    run = 0;
    last = k;
  }
  if (last < 63 && !put_symbol(bw, ac, 0, 0, 0)) return false;
  return true;
}

}  // namespace

extern "C" {

// One scan: the destuffed restart intervals (starts, lens into `data`), the
// blocks in scan order (flat coefficient offset, component slot), `step`
// blocks per interval, per slot the DC and AC tables' DHT counts (16) and
// symbols (kMaxSymbols, nsym used) at table index 2 slot (DC) and
// 2 slot + 1 (AC).
// Writes each block's DC and non-zero AC coefficients into coefs (natural
// order within the block). Returns 0 or an Err.
int jpeg_decode_scan(const uint8_t* data, const int64_t* starts, const int64_t* lens,
                     int64_t nseg, const int64_t* bases, const int32_t* slots, int64_t nblocks,
                     int64_t step, int nslots, const uint8_t* counts, const uint8_t* symbols,
                     const int32_t* nsyms, int64_t* coefs, int64_t ncoefs) {
  if (nslots < 1 || nslots > 4 || step < 1) return kBadArgument;
  Lookup dc[4], ac[4];
  for (int s = 0; s < nslots; ++s) {
    int err = build_lookup(counts + 32 * s, symbols + 2 * kMaxSymbols * s, nsyms[2 * s], &dc[s]);
    if (!err) err = build_lookup(counts + 32 * s + 16, symbols + (2 * s + 1) * kMaxSymbols,
                                 nsyms[2 * s + 1], &ac[s]);
    if (err) return err;
  }
  for (int64_t i = 0; i < nseg; ++i) {
    const int64_t first = i * step;
    if (first >= nblocks) break;
    const int64_t count = std::min(step, nblocks - first);
    const BitReader br{data + starts[i], lens[i]};
    const int err = decode_interval(br, bases + first, slots + first, count, dc, ac, nslots,
                                    coefs, ncoefs);
    if (err) return err;
  }
  return kOk;
}

// One scan of a progressive file, laid out as jpeg_decode_scan's
// arguments, with one Huffman table per slot (counts 16 and symbols
// kMaxSymbols each: the DC table of a DC-first scan, the AC table of an AC
// scan, unused by a DC refinement) and the scan's spectral selection
// (ss, se) and successive approximation (ah, al), which the caller has
// checked. Returns 0 or an Err.
int jpeg_decode_progressive(const uint8_t* data, const int64_t* starts, const int64_t* lens,
                            int64_t nseg, const int64_t* bases, const int32_t* slots,
                            int64_t nblocks, int64_t step, int nslots, const uint8_t* counts,
                            const uint8_t* symbols, const int32_t* nsyms, int ss, int se, int ah,
                            int al, int64_t* coefs, int64_t ncoefs) {
  if (nslots < 1 || nslots > 4 || step < 1 || ss < 0 || se > 63 || ss > se || al < 0 ||
      al > 13 || (ss > 0 && nslots != 1))
    return kBadArgument;
  Lookup tables[4];
  for (int s = 0; s < nslots; ++s) {
    const int err = build_lookup(counts + 16 * s, symbols + kMaxSymbols * s, nsyms[s], &tables[s]);
    if (err) return err;
  }
  for (int64_t i = 0; i < nseg; ++i) {
    const int64_t first = i * step;
    if (first >= nblocks) break;
    const int64_t count = std::min(step, nblocks - first);
    const BitReader br{data + starts[i], lens[i]};
    const int err = decode_progressive_interval(br, bases + first, slots + first, count, tables,
                                                nslots, ss, se, ah, al, coefs, ncoefs);
    if (err) return err;
  }
  return kOk;
}

// Coefficients -> pixels. Per component (comp[8 c ...]): flat offset of its
// blocks, blocks across (bw) and down (bh), its sample width and height,
// its horizontal and vertical upsampling ratios (1 or 2), and 1 where it
// holds a lossless file's samples ([bh, bw] of them, 0-255, upsampled by
// replication) instead of coefficients; qt: its 64 dequantisation factors
// (natural order). mode 0: one component, gray
// [h, w]; 1: YCbCr -> RGB [h, w, 3]; 2: the three planes as they are; four
// components [h, w, 4] as PIL reads them (libjpeg's CMYK, inverted): 3 the
// planes as CMYK, 4 YCCK (jdcolor.c ycck_cmyk_convert: C, M, Y the
// inverted R, G, B of the YCbCr triple, K as it is).
int jpeg_reconstruct(const int64_t* coefs, int64_t ncoefs, int nc, const int64_t* comp,
                     const int64_t* qt, int64_t h, int64_t w, int mode, uint8_t* out) {
  if (nc != 1 && nc != 3 && nc != 4) return kBadArgument;
  if ((nc == 4) != (mode == 3 || mode == 4)) return kBadArgument;
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int ci = 0; ci < nc; ++ci) {
    const int64_t* cp = comp + 8 * ci;
    const int64_t offset = cp[0], bw = cp[1], bh = cp[2], cw = cp[3], ch = cp[4];
    const int64_t rx = cp[5], ry = cp[6];
    if (cp[7]) {  // a lossless file's samples, upsampled by replication
      if (offset < 0 || offset + bw * bh > ncoefs || cw > bw || ch > bh || cw * rx < w ||
          ch * ry < h || rx < 1 || rx > 2 || ry < 1 || ry > 2)
        return kBadArgument;
      std::vector<uint8_t> cropped(h * w);
      for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x)
          cropped[y * w + x] = uint8_t(coefs[offset + (y / ry) * bw + x / rx]);
      planes[ci].swap(cropped);
      continue;
    }
    if (offset < 0 || offset + bw * bh * 64 > ncoefs || cw > bw * 8 || ch > bh * 8 ||
        cw * rx < w || ch * ry < h)
      return kBadArgument;
    const int64_t pitch = bw * 8;
    std::vector<uint8_t> full(bh * 8 * pitch);
    int64_t blk[64];
    for (int64_t by = 0; by < bh; ++by)
      for (int64_t bx = 0; bx < bw; ++bx) {
        const int64_t* c = coefs + offset + (by * bw + bx) * 64;
        for (int i = 0; i < 64; ++i) blk[i] = c[i] * qt[64 * ci + i];
        idct_islow(blk, &full[by * 8 * pitch + bx * 8], pitch);
      }
    std::vector<uint8_t> plane(cw * ch);
    for (int64_t y = 0; y < ch; ++y) std::memcpy(&plane[y * cw], &full[y * pitch], cw);
    if (rx == 2 && ry == 1) {
      std::vector<uint8_t> up(ch * 2 * cw);
      upsample_h2v1(plane.data(), ch, cw, up.data());
      plane.swap(up);
    } else if (rx == 2 && ry == 2) {
      std::vector<uint8_t> up(4 * ch * cw);
      upsample_h2v2(plane.data(), ch, cw, up.data());
      plane.swap(up);
    } else if (rx != 1 || ry != 1) {
      return kBadArgument;
    }
    // crop to [h, w]; the plane is cw * rx wide
    std::vector<uint8_t> cropped(h * w);
    for (int64_t y = 0; y < h; ++y) std::memcpy(&cropped[y * w], &plane[y * cw * rx], w);
    planes[ci].swap(cropped);
  }
  const int64_t n = h * w;
  if (nc == 1) {
    std::memcpy(out, planes[0].data(), n);
    return kOk;
  }
  const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
  static const YccTables t;
  if (mode == 3 || mode == 4) {
    const uint8_t* p3 = planes[3].data();
    for (int64_t i = 0; i < n; ++i) {
      uint8_t* o = out + 4 * i;
      if (mode == 3) {
        o[0] = uint8_t(255 - p0[i]);
        o[1] = uint8_t(255 - p1[i]);
        o[2] = uint8_t(255 - p2[i]);
      } else {
        const int64_t y = p0[i];
        const int cb = p1[i], cr = p2[i];
        o[0] = clamp_u8(y + t.cr_r[cr]);
        o[1] = clamp_u8(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[2] = clamp_u8(y + t.cb_b[cb]);
      }
      o[3] = uint8_t(255 - p3[i]);
    }
    return kOk;
  }
  if (mode == 2) {
    for (int64_t i = 0; i < n; ++i) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return kOk;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t y = p0[i];
    const int cb = p1[i], cr = p2[i];
    out[3 * i] = clamp_u8(y + t.cr_r[cr]);
    out[3 * i + 1] = clamp_u8(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp_u8(y + t.cb_b[cb]);
  }
  return kOk;
}

// uint8 [h, w, 3] RGB -> the entropy-coded scan of a baseline 4:2:0 JPEG
// with no restart markers: qy, qc the luma and chroma quantisation tables
// (natural order), codes and sizes the Huffman code and length of every
// symbol (256 each) of the DC luma, AC luma, DC chroma and AC chroma tables.
// Writes at most cap bytes to out and their count to *n_out. Returns 0,
// kNoCode, or kBadArgument when cap is too small.
int jpeg_encode_entropy(const uint8_t* rgb, int64_t h, int64_t w, const int32_t* qy,
                        const int32_t* qc, const int32_t* codes, const int32_t* sizes,
                        uint8_t* out, int64_t cap, int64_t* n_out) {
  const int64_t mcuy = (h + 15) / 16, mcux = (w + 15) / 16;
  const int64_t ph = mcuy * 16, pw = mcux * 16;
  // edge replication, then jccolor.c's fixed-point RGB -> YCbCr
  std::vector<uint8_t> y(ph * pw), cb(ph * pw), cr(ph * pw);
  const int64_t half = 1 << 15, offset = int64_t(128) << 16;
  for (int64_t r = 0; r < ph; ++r) {
    const uint8_t* src = rgb + std::min(r, h - 1) * w * 3;
    for (int64_t c = 0; c < pw; ++c) {
      const uint8_t* px = src + std::min(c, w - 1) * 3;
      const int64_t R = px[0], G = px[1], B = px[2];
      const int64_t i = r * pw + c;
      y[i] = uint8_t((fix16(0.29900) * R + fix16(0.58700) * G + fix16(0.11400) * B + half) >> 16);
      cb[i] = uint8_t((-fix16(0.16874) * R - fix16(0.33126) * G + fix16(0.5) * B + offset + half
                       - 1) >> 16);
      cr[i] = uint8_t((fix16(0.5) * R - fix16(0.41869) * G - fix16(0.08131) * B + offset + half
                       - 1) >> 16);
    }
  }
  // jcsample.c h2v2: each 2 x 2 sum plus a bias alternating 1, 2 along the row
  const int64_t ch = ph / 2, cw = pw / 2;
  std::vector<uint8_t> cbs(ch * cw), crs(ch * cw);
  for (int64_t r = 0; r < ch; ++r)
    for (int64_t c = 0; c < cw; ++c) {
      const int64_t a = 2 * r * pw + 2 * c, b = a + pw;
      const int bias = 1 + (c & 1);
      cbs[r * cw + c] = uint8_t((cb[a] + cb[a + 1] + cb[b] + cb[b + 1] + bias) >> 2);
      crs[r * cw + c] = uint8_t((cr[a] + cr[a + 1] + cr[b] + cr[b + 1] + bias) >> 2);
    }
  const Divisors dy(qy), dc(qc);
  const CodeTable dcl{codes, sizes}, acl{codes + 256, sizes + 256};
  const CodeTable dcc{codes + 512, sizes + 512}, acc{codes + 768, sizes + 768};
  BitWriter bw{out, cap};
  int64_t pred[3] = {0, 0, 0};
  int64_t zz[64];
  for (int64_t my = 0; my < mcuy; ++my)
    for (int64_t mx = 0; mx < mcux; ++mx) {
      for (int k = 0; k < 4; ++k) {  // the MCU's four Y blocks in raster order
        const int64_t r = my * 16 + (k >> 1) * 8, c = mx * 16 + (k & 1) * 8;
        fdct_quantize(&y[r * pw + c], pw, dy, zz);
        if (!encode_block(bw, zz, &pred[0], dcl, acl)) return kNoCode;
      }
      fdct_quantize(&cbs[my * 8 * cw + mx * 8], cw, dc, zz);
      if (!encode_block(bw, zz, &pred[1], dcc, acc)) return kNoCode;
      fdct_quantize(&crs[my * 8 * cw + mx * 8], cw, dc, zz);
      if (!encode_block(bw, zz, &pred[2], dcc, acc)) return kNoCode;
      if (bw.overflow) return kBadArgument;
    }
  bw.flush();
  if (bw.overflow) return kBadArgument;
  *n_out = bw.n;
  return kOk;
}

}  // extern "C"

extern "C" {

// One arithmetic-coded scan, laid out as jpeg_decode_scan's arguments, with
// per slot its DC and AC conditioning table numbers (0-3; tables), the DAC
// marker's conditioning per table (dc_l, dc_u, ac_k) and the scan's
// parameters (progressive, ss, se, ah, al), which the caller has checked.
// Returns 0 or an Err (kCorrupt: a magnitude past 15 bits).
int jpeg_decode_arith(const uint8_t* data, const int64_t* starts, const int64_t* lens,
                      int64_t nseg, const int64_t* bases, const int32_t* slots, int64_t nblocks,
                      int64_t step, int nslots, const int32_t* tables, const int32_t* dc_l,
                      const int32_t* dc_u, const int32_t* ac_k, int progressive, int ss, int se,
                      int ah, int al, int64_t* coefs, int64_t ncoefs) {
  if (nslots < 1 || nslots > 4 || step < 1 || ss < 0 || se > 63 || ss > se || al < 0 ||
      al > 13)
    return kBadArgument;
  for (int i = 0; i < 2 * nslots; ++i)
    if (tables[i] < 0 || tables[i] > 3) return kBadArgument;
  for (int t = 0; t < 4; ++t)
    if (dc_l[t] < 0 || dc_l[t] > 15 || dc_u[t] < 0 || dc_u[t] > 15 || ac_k[t] < 0)
      return kBadArgument;
  const ArithScan sc{progressive, ss, se, ah, al, tables, dc_l, dc_u, ac_k};
  for (int64_t i = 0; i < nseg; ++i) {
    const int64_t first = i * step;
    if (first >= nblocks) break;
    ArithDecoder d{data + starts[i], lens[i]};
    const int err = decode_arith_interval(sc, d, bases + first, slots + first,
                                          std::min(step, nblocks - first), nslots, coefs, ncoefs);
    if (err) return err;
  }
  return kOk;
}

// One lossless scan's Huffman-coded differences into diffs at each
// sample's flat offset (bases, in scan order), laid out as
// jpeg_decode_progressive's arguments (one DC table per slot). Returns 0
// or an Err.
int jpeg_decode_lossless(const uint8_t* data, const int64_t* starts, const int64_t* lens,
                         int64_t nseg, const int64_t* bases, const int32_t* slots,
                         int64_t nsamples, int64_t step, int nslots, const uint8_t* counts,
                         const uint8_t* symbols, const int32_t* nsyms, int64_t* diffs,
                         int64_t ndiffs) {
  if (nslots < 1 || nslots > 4 || step < 1) return kBadArgument;
  Lookup tables[4];
  for (int s = 0; s < nslots; ++s) {
    const int err = build_lookup(counts + 16 * s, symbols + kMaxSymbols * s, nsyms[s], &tables[s]);
    if (err) return err;
  }
  for (int64_t i = 0; i < nseg; ++i) {
    const int64_t first = i * step;
    if (first >= nsamples) break;
    const int64_t end = std::min(first + step, nsamples);
    const BitReader br{data + starts[i], lens[i]};
    int64_t p = 0;
    for (int64_t j = first; j < end; ++j) {
      const int ci = slots[j];
      if (ci < 0 || ci >= nslots || bases[j] < 0 || bases[j] >= ndiffs) return kBadArgument;
      const int err = read_difference(br, tables[ci], &p, &diffs[bases[j]]);
      if (err) return err;
    }
  }
  return kOk;
}

// jdlossls.c in place on one component's [rows, pitch] plane of differences:
// the first row of the scan and of each restart interval (every
// restart_rows rows; 0: none) predicted from the left and 1 << (7 - pt),
// the first column from above, the rest by predictor psv (1-7), each sample
// (difference + prediction) mod 2^16; then (sample << pt) mod 256.
int jpeg_undifference(int64_t* plane, int64_t pitch, int64_t width, int64_t height, int psv,
                      int pt, int64_t restart_rows) {
  if (psv < 1 || psv > 7 || pt < 0 || pt > 7 || width > pitch || restart_rows < 0)
    return kBadArgument;
  for (int64_t y = 0; y < height; ++y) {
    int64_t* row = plane + y * pitch;
    if (y == 0 || (restart_rows && y % restart_rows == 0)) {
      int64_t ra = int64_t(1) << (7 - pt);
      for (int64_t x = 0; x < width; ++x) ra = row[x] = (row[x] + ra) & 0xFFFF;
      continue;
    }
    const int64_t* prev = row - pitch;
    int64_t rb = prev[0];
    int64_t ra = row[0] = (row[0] + rb) & 0xFFFF;
    for (int64_t x = 1; x < width; ++x) {
      const int64_t rc = rb;
      rb = prev[x];
      int64_t pred;
      switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
      }
      ra = row[x] = (row[x] + pred) & 0xFFFF;
    }
  }
  for (int64_t y = 0; y < height; ++y)
    for (int64_t x = 0; x < width; ++x) plane[y * pitch + x] = (plane[y * pitch + x] << pt) & 0xFF;
  return kOk;
}

}  // extern "C"
