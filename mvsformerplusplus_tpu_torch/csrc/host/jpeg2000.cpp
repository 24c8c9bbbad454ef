// JPEG 2000 (ISO 15444-1) tile decoding for data/jpeg2000.py, which parses
// the JP2 boxes and the codestream's markers: per tile the tier-2 packet
// headers (tag trees, code-block inclusion, zero bit-planes, coding passes,
// Lblock and segment lengths) in the tile's progression order(s), tier-1
// EBCOT (the MQ decoder, the significance, refinement and cleanup passes,
// with every code-block style bit: selective arithmetic coding bypass,
// context reset, termination on each pass, vertically causal contexts,
// predictable termination and segmentation symbols), dequantisation, the
// inverse 5/3 (integer) and 9/7 (float) wavelets, the inverse RCT / ICT and
// the DC level shift with its clamp. Each step follows OpenJPEG 2.5's C
// code (the library Pillow and OpenCV link), so the samples are OpenJPEG's
// bit for bit: its doubled tier-1 magnitudes with midpoint reconstruction,
// its 9/7 lifting in float in its order (low band times K, high band times
// its historic 2/K) and lrintf.
// Each call runs in the calling thread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int { kOk = 0, kCorrupt = 1, kTruncated = 2, kUnsupported = 3, kBadArgument = 5 };

// -------------------------------------------------------------- MQ decoder

struct MqState {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

// Table C.2 of ISO 15444-1
constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

// OpenJPEG's mqc.c: INITDEC, BYTEIN, DECODE and RENORMD, and the raw
// (bypass) bit reader; both read 0xFF 0xFF (a marker) past the segment
struct Mq {
  const uint8_t* d = nullptr;
  int64_t n = 0, bp = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];
  int byte(int64_t i) const { return i < n ? d[i] : 0xff; }
  void reset_states() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  void bytein() {
    const int next = byte(bp + 1);
    if (byte(bp) == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(next) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(next) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, int64_t len) {
    d = data;
    n = len;
    bp = 0;
    c = uint32_t(len == 0 ? 0xff : data[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int dbit;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        dbit = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        dbit = !mps[cx];
        if (s.sw) mps[cx] ^= 1;
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          dbit = !mps[cx];
          if (s.sw) mps[cx] ^= 1;
          state[cx] = s.nlps;
        } else {
          dbit = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        dbit = mps[cx];
      }
    }
    return dbit;
  }
  // raw segments
  void raw_init(const uint8_t* data, int64_t len) {
    d = data;
    n = len;
    bp = 0;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (byte(bp) > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = uint32_t(byte(bp++));
          ct = 7;
        }
      } else {
        c = uint32_t(byte(bp++));
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// -------------------------------------------------------------- tier 1

constexpr int kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kPterm = 16, kSegSym = 32;

struct Segment {
  int64_t start = 0, len = 0;  // in the code-block's data
  int passes = 0, maxpasses = 0;
};

struct CodeBlock {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  bool included = false;
  std::vector<uint8_t> data;
  std::vector<Segment> segs;
};

// one code-block (OpenJPEG's opj_t1_decode_cblk): sign-magnitude values
// doubled, with the midpoint of the last decoded bit-plane
struct T1 {
  int w, h;
  std::vector<int32_t> v;     // (h + 2) x (w + 2), values
  std::vector<uint8_t> sig;   // significance
  std::vector<uint8_t> neg;   // sign of the significant
  std::vector<uint8_t> pi;    // visited in this bit-plane's significance pass
  std::vector<uint8_t> mu;    // refined before
  std::vector<uint8_t> seen;  // significance the contexts see (VSC masks rows below stripes)
  int orient;
  Mq mq;

  int at(int x, int y) const { return (y + 1) * (w + 2) + x + 1; }

  // the significance of the neighbour (x + dx, y + dy) as sample (x, y) sees
  // it: with VSC the row below a stripe is not seen from its last row
  bool s(int x, int y, int dx, int dy, bool vsc) const {
    if (vsc && dy == 1 && (y & 3) == 3) return false;
    return sig[at(x + dx, y + dy)] != 0;
  }
  int sgn(int x, int y, int dx, int dy, bool vsc) const {  // +1, -1, 0
    if (!s(x, y, dx, dy, vsc)) return 0;
    return neg[at(x + dx, y + dy)] ? -1 : 1;
  }
  bool any_neighbour(int x, int y, bool vsc) const {
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        if ((dx || dy) && s(x, y, dx, dy, vsc)) return true;
    return false;
  }
  int zc_ctx(int x, int y, bool vsc) const {
    int hh = s(x, y, -1, 0, vsc) + s(x, y, 1, 0, vsc);
    int vv = s(x, y, 0, -1, vsc) + s(x, y, 0, 1, vsc);
    const int dd = s(x, y, -1, -1, vsc) + s(x, y, 1, -1, vsc) + s(x, y, -1, 1, vsc) +
                   s(x, y, 1, 1, vsc);
    int n;
    if (orient == 3) {
      const int hv = hh + vv;
      if (!dd) n = !hv ? 0 : hv == 1 ? 1 : 2;
      else if (dd == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
      else if (dd == 2) n = !hv ? 6 : 7;
      else n = 8;
    } else {
      if (orient == 1) std::swap(hh, vv);
      if (!hh) n = !vv ? (!dd ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
      else if (hh == 1) n = !vv ? (!dd ? 5 : 6) : 7;
      else n = 8;
    }
    return kCtxZc + n;
  }
  // sign context and its XOR bit
  void sc_ctx(int x, int y, bool vsc, int* ctx, int* xorbit) const {
    const int e = sgn(x, y, 1, 0, vsc), wv = sgn(x, y, -1, 0, vsc);
    const int nn = sgn(x, y, 0, -1, vsc), ss = sgn(x, y, 0, 1, vsc);
    int hc = std::min((e > 0) + (wv > 0), 1) - std::min((e < 0) + (wv < 0), 1);
    int vc = std::min((nn > 0) + (ss > 0), 1) - std::min((nn < 0) + (ss < 0), 1);
    *xorbit = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
    }
    int n;
    if (!hc) n = vc ? 1 : 0;
    else n = vc == -1 ? 2 : !vc ? 3 : 4;
    *ctx = kCtxSc + n;
  }
  void set_significant(int x, int y, int sign, int32_t oneplushalf) {
    const int i = at(x, y);
    sig[i] = 1;
    neg[i] = uint8_t(sign);
    v[i] = sign ? -oneplushalf : oneplushalf;
  }
  void decode_sign(int x, int y, bool vsc, bool raw, int32_t oneplushalf) {
    int sign;
    if (raw) {
      sign = mq.raw();
    } else {
      int ctx, xb;
      sc_ctx(x, y, vsc, &ctx, &xb);
      sign = mq.decode(ctx) ^ xb;
    }
    set_significant(x, y, sign, oneplushalf);
  }

  void sigpass(int bp, bool vsc, bool raw) {
    const int32_t one = 1 << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          const int i = at(x, y);
          if (sig[i] || pi[i] || !any_neighbour(x, y, vsc)) continue;
          const int bit = raw ? mq.raw() : mq.decode(zc_ctx(x, y, vsc));
          if (bit) decode_sign(x, y, vsc, raw, oneplushalf);
          pi[i] = 1;
        }
  }

  void refpass(int bp, bool vsc, bool raw) {
    const int32_t poshalf = (1 << bp) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          const int i = at(x, y);
          if (!sig[i] || pi[i]) continue;
          int bit;
          if (raw) {
            bit = mq.raw();
          } else {
            const int ctx = mu[i] ? kCtxMag + 2 : any_neighbour(x, y, vsc) ? kCtxMag + 1 : kCtxMag;
            bit = mq.decode(ctx);
          }
          v[i] += (bit ^ (v[i] < 0)) ? poshalf : -poshalf;
          mu[i] = 1;
        }
  }

  void clnpass(int bp, bool vsc, bool segsym) {
    const int32_t one = 1 << bp, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y = k;
        const int y1 = std::min(k + 4, h);
        if (y1 - k == 4) {
          // run mode: four insignificant, unvisited samples with no
          // significant neighbour (OpenJPEG: the column's flags are all zero)
          bool run = true;
          for (int r = k; r < y1 && run; ++r) {
            const int i = at(x, r);
            run = !sig[i] && !pi[i] && !any_neighbour(x, r, vsc);
          }
          if (run) {
            if (!mq.decode(kCtxAgg)) continue;
            int runlen = mq.decode(kCtxUni);
            runlen = (runlen << 1) | mq.decode(kCtxUni);
            y = k + runlen;
            decode_sign(x, y, vsc, false, oneplushalf);
            ++y;
          }
        }
        for (; y < y1; ++y) {
          const int i = at(x, y);
          if (sig[i] || pi[i]) continue;
          if (mq.decode(zc_ctx(x, y, vsc))) decode_sign(x, y, vsc, false, oneplushalf);
        }
      }
    for (auto& p : pi) p = 0;
    if (segsym) {
      for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
    }
  }
};

// decode one code-block into out (cw x ch, row stride), OpenJPEG's doubled
// values; numbps the coded bit-planes
int decode_codeblock(const CodeBlock& cb, int orient, int cblksty, int roishift, int32_t* out,
                     int64_t stride) {
  const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
  T1 t;
  t.w = w;
  t.h = h;
  t.orient = orient;
  const size_t n = size_t(w + 2) * (h + 2);
  t.v.assign(n, 0);
  t.sig.assign(n, 0);
  t.neg.assign(n, 0);
  t.pi.assign(n, 0);
  t.mu.assign(n, 0);
  int bpno = roishift + cb.numbps;
  if (bpno >= 31) return kUnsupported;
  int passtype = 2;
  t.mq.reset_states();
  const bool vsc = cblksty & kVsc;
  for (const Segment& seg : cb.segs) {
    if (seg.start + seg.len > int64_t(cb.data.size())) return kCorrupt;
    const bool raw = bpno <= cb.numbps - 4 && passtype < 2 && (cblksty & kLazy);
    if (raw) t.mq.raw_init(cb.data.data() + seg.start, seg.len);
    else t.mq.init(cb.data.data() + seg.start, seg.len);
    for (int p = 0; p < seg.passes && bpno >= 1; ++p) {
      if (passtype == 0) t.sigpass(bpno, vsc, raw);
      else if (passtype == 1) t.refpass(bpno, vsc, raw);
      else t.clnpass(bpno, vsc, cblksty & kSegSym);
      if ((cblksty & kReset) && !raw) t.mq.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int32_t val = t.v[t.at(x, y)];
      if (roishift) {
        const int32_t mag = std::abs(val);
        if (mag >= (1 << roishift)) val = val < 0 ? -(mag >> roishift) : mag >> roishift;
      }
      out[y * stride + x] = val;
    }
  return kOk;
}

// -------------------------------------------------------------- tier 2

// packet-header bits (opj_bio): MSB first, a stuffed bit after each 0xFF
struct Bio {
  const uint8_t* d;
  int64_t n, pos = 0;
  uint32_t buf = 0;
  int ct = 0;
  bool bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (pos < n) buf |= d[pos++];
    return true;
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = k - 1; i >= 0; --i) v |= uint32_t(bit()) << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  int nleaves = 0;
  void build(int w, int h) {
    nodes.clear();
    nleaves = w * h;
    std::vector<std::pair<int, int>> dims;
    int ww = w, hh = h;
    dims.push_back({ww, hh});
    while (ww * hh > 1) {
      ww = (ww + 1) / 2;
      hh = (hh + 1) / 2;
      dims.push_back({ww, hh});
    }
    std::vector<int> base(dims.size(), 0);
    int total = 0;
    for (size_t l = 0; l < dims.size(); ++l) {
      base[l] = total;
      total += dims[l].first * dims[l].second;
    }
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < dims.size(); ++l)
      for (int y = 0; y < dims[l].second; ++y)
        for (int x = 0; x < dims[l].first; ++x)
          nodes[base[l] + y * dims[l].first + x].parent =
              base[l + 1] + (y / 2) * dims[l + 1].first + x / 2;
  }
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[32], sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low;
      else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit()) nd.value = low;
        else ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold;
  }
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<CodeBlock> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno, x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> precincts;
};

struct Resolution {
  int x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

struct Comp {
  int dx, dy, prec, sgnd;
  int numres, cblkw, cblkh, cblksty, qmfbid, roishift;
  int x0, y0, x1, y1;  // tile-component
  std::vector<Resolution> res;
};

inline int ceildiv(int64_t a, int64_t b) { return int((a + b - 1) / b); }
inline int ceildivpow2(int64_t a, int b) { return int((a + (int64_t(1) << b) - 1) >> b); }
inline int floordivpow2(int64_t a, int b) { return int(a >> b); }

int num_passes(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  int n = int(bio.read(2));
  if (n != 3) return 3 + n;
  n = int(bio.read(5));
  if (n != 31) return 6 + n;
  return 37 + int(bio.read(7));
}

inline int floorlog2(int v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

int init_seg_maxpasses(const CodeBlock& cb, int cblksty, bool first) {
  if (cblksty & kTermAll) return 1;
  if (cblksty & kLazy) {
    if (first) return 10;
    const int prev = cb.segs.back().maxpasses;
    return (prev == 1 || prev == 10) ? 2 : 1;
  }
  return 109;
}

struct Packet {
  int layer, res, comp, prec;
};

// one packet: header bits from *hdr (the tile data, or PPT/PPM data),
// body bytes from *body; both advance
int read_packet(Comp& c, const Packet& pk, const uint8_t* hdr_data, int64_t hdr_n,
                int64_t* hdr_pos, const uint8_t* body_data, int64_t body_n, int64_t* body_pos,
                bool sop, bool eph, bool separate_headers) {
  Resolution& r = c.res[pk.res];
  if (pk.layer == 0) {
    for (Band& b : r.bands) {
      if (pk.prec >= int(b.precincts.size())) continue;
      Precinct& p = b.precincts[pk.prec];
      p.incl.build(p.cw, p.ch);
      p.imsb.build(p.cw, p.ch);
      for (CodeBlock& cb : p.cblks) {
        cb.included = false;
        cb.segs.clear();
        cb.data.clear();
      }
    }
  }
  if (sop && *body_pos + 6 <= body_n && body_data[*body_pos] == 0xff &&
      body_data[*body_pos + 1] == 0x91)
    *body_pos += 6;
  int64_t& hpos = separate_headers ? *hdr_pos : *body_pos;
  const uint8_t* hd = separate_headers ? hdr_data : body_data;
  const int64_t hn = separate_headers ? hdr_n : body_n;
  Bio bio{hd + hpos, hn - hpos};
  struct Pending {
    CodeBlock* cb;
    std::vector<std::pair<int, int64_t>> segs;  // (segment index, new length)
    std::vector<int> passes;
  };
  std::vector<Pending> pending;
  const bool present = bio.bit();
  if (present) {
    for (Band& b : r.bands) {
      if (b.x1 - b.x0 == 0 || b.y1 - b.y0 == 0) continue;
      Precinct& p = b.precincts[pk.prec];
      for (int k = 0; k < int(p.cblks.size()); ++k) {
        CodeBlock& cb = p.cblks[k];
        bool included;
        if (!cb.included) included = p.incl.decode(bio, k, pk.layer + 1);
        else included = bio.bit();
        if (!included) continue;
        if (!cb.included) {
          int i = 0;
          while (!p.imsb.decode(bio, k, i)) {
            ++i;
            if (i > 64) return kCorrupt;
          }
          cb.numbps = b.numbps + 1 - i;
          cb.numlenbits = 3;
          cb.included = true;
        }
        int newpasses = num_passes(bio);
        int inc = 0;
        while (bio.bit()) {
          ++inc;
          if (inc > 64) return kCorrupt;
        }
        cb.numlenbits += inc;
        Pending pd{&cb, {}, {}};
        int segno;
        if (cb.segs.empty()) {
          Segment s;
          s.start = int64_t(cb.data.size());
          s.maxpasses = init_seg_maxpasses(cb, c.cblksty, true);
          cb.segs.push_back(s);
          segno = 0;
        } else {
          segno = int(cb.segs.size()) - 1;
          if (cb.segs[segno].passes == cb.segs[segno].maxpasses) {
            Segment s;
            s.maxpasses = init_seg_maxpasses(cb, c.cblksty, false);
            cb.segs.push_back(s);
            ++segno;
          }
        }
        // the passes already counted in a segment this packet adds to
        int counted = cb.segs[segno].passes;
        while (newpasses > 0) {
          const int take = std::min(cb.segs[segno].maxpasses - counted, newpasses);
          const int bits = cb.numlenbits + floorlog2(take);
          if (bits > 32) return kCorrupt;
          pd.segs.push_back({segno, int64_t(bio.read(bits))});
          pd.passes.push_back(take);
          newpasses -= take;
          if (newpasses > 0) {
            Segment s;
            s.maxpasses = init_seg_maxpasses(cb, c.cblksty, false);
            // maxpasses depends on the previous segment's, as OpenJPEG's
            cb.segs.push_back(s);
            ++segno;
            counted = 0;
          }
        }
        pending.push_back(std::move(pd));
      }
    }
  }
  bio.inalign();
  hpos += bio.pos;
  if (eph) {
    if (hpos + 2 <= hn && hd[hpos] == 0xff && hd[hpos + 1] == 0x92) hpos += 2;
  }
  // the bodies, in the header's order
  for (Pending& pd : pending) {
    CodeBlock& cb = *pd.cb;
    for (size_t j = 0; j < pd.segs.size(); ++j) {
      Segment& s = cb.segs[pd.segs[j].first];
      int64_t len = pd.segs[j].second;
      if (s.passes == 0 && s.len == 0) s.start = int64_t(cb.data.size());
      if (*body_pos + len > body_n) return kTruncated;
      cb.data.insert(cb.data.end(), body_data + *body_pos, body_data + *body_pos + len);
      *body_pos += len;
      s.len += len;
      s.passes += pd.passes[j];
    }
  }
  return kOk;
}

// ------------------------------------------------------------- wavelets

// opj_dwt_decode_1_: one row or column of the 5/3 (integer), sn low and dn
// high samples interleaved in a, cas the parity of its first sample
void idwt53_1d(int32_t* a, int sn, int dn, int cas) {
  auto S = [&](int i) -> int32_t& { return a[2 * i]; };
  auto D = [&](int i) -> int32_t& { return a[1 + 2 * i]; };
  if (!cas) {
    if (dn > 0 || sn > 1) {
      auto Dc = [&](int i) { return D(i < 0 ? 0 : i >= dn ? dn - 1 : i); };
      auto Sc = [&](int i) { return S(i < 0 ? 0 : i >= sn ? sn - 1 : i); };
      for (int i = 0; i < sn; ++i) S(i) -= (Dc(i - 1) + Dc(i) + 2) >> 2;
      for (int i = 0; i < dn; ++i) D(i) += (Sc(i) + Sc(i + 1)) >> 1;
    }
  } else {
    if (!sn && dn == 1) {
      S(0) /= 2;
    } else {
      auto SSc = [&](int i) { return S(i < 0 ? 0 : i >= dn ? dn - 1 : i); };
      auto DDc = [&](int i) { return D(i < 0 ? 0 : i >= sn ? sn - 1 : i); };
      for (int i = 0; i < sn; ++i) D(i) -= (SSc(i) + SSc(i + 1) + 2) >> 2;
      for (int i = 0; i < dn; ++i) S(i) += (DDc(i) + DDc(i - 1)) >> 1;
    }
  }
}

constexpr float kDwtAlpha = -1.586134342f, kDwtBeta = -0.052980118f, kDwtGamma = 0.882911075f,
                kDwtDelta = 0.443506852f, kDwtK = 1.230174105f, kDwtTwoInvK = 1.625732422f;

// opj_v8dwt_decode_step2 on one lane: w[2i - 1] += (l + w[2i]) * c
void lift(float* fl, float* fw, int start, int end, int m, float c) {
  const int imax = std::min(end, m);
  if (start > 0) {
    fw += 2 * start;
    fl = fw - 2;
  }
  for (int i = start; i < imax; ++i) {
    fw[-1] += (fl[0] + fw[0]) * c;
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    fw[-1] += fl[0] * c;
  }
}

// opj_v8dwt_decode on one row or column (interleaved in w)
void idwt97_1d(float* w, int sn, int dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int i = 0; i < sn; ++i) w[a + 2 * i] *= kDwtK;
  for (int i = 0; i < dn; ++i) w[b + 2 * i] *= kDwtTwoInvK;
  lift(w + b, w + a + 1, 0, sn, std::min(sn, dn - a), -kDwtDelta);
  lift(w + a, w + b + 1, 0, dn, std::min(dn, sn - b), -kDwtGamma);
  lift(w + b, w + a + 1, 0, sn, std::min(sn, dn - a), -kDwtBeta);
  lift(w + a, w + b + 1, 0, dn, std::min(dn, sn - b), -kDwtAlpha);
}

template <typename T, typename F>
void idwt_2d(T* data, int64_t stride, const Comp& c, F one_d) {
  const Resolution* tr = c.res.data();
  int rw = tr->x1 - tr->x0, rh = tr->y1 - tr->y0;
  std::vector<T> buf;
  for (int r = 1; r < c.numres; ++r) {
    ++tr;
    const int hsn = rw, vsn = rh;
    rw = tr->x1 - tr->x0;
    rh = tr->y1 - tr->y0;
    const int hdn = rw - hsn, hcas = tr->x0 % 2;
    buf.assign(std::max(rw, rh) + 2, T(0));
    for (int j = 0; j < rh; ++j) {
      T* row = data + j * stride;
      for (int i = 0; i < hsn; ++i) buf[hcas + 2 * i] = row[i];
      for (int i = 0; i < hdn; ++i) buf[1 - hcas + 2 * i] = row[hsn + i];
      one_d(buf.data(), hsn, hdn, hcas);
      for (int i = 0; i < rw; ++i) row[i] = buf[i];
    }
    const int vdn = rh - vsn, vcas = tr->y0 % 2;
    for (int i = 0; i < rw; ++i) {
      T* col = data + i;
      for (int j = 0; j < vsn; ++j) buf[vcas + 2 * j] = col[j * stride];
      for (int j = 0; j < vdn; ++j) buf[1 - vcas + 2 * j] = col[(vsn + j) * stride];
      one_d(buf.data(), vsn, vdn, vcas);
      for (int j = 0; j < rh; ++j) col[j * stride] = buf[j];
    }
  }
}

}  // namespace

extern "C" {

// One tile. params (int32): [0..3] the tile's reference-grid rectangle, [4]
// components, [5] layers, [6] MCT, [7] SOP/EPH bits (Scod 2, 4), [8]
// progressions (P), then P x (layer end, res start, res end, comp start,
// comp end, order 0-4 LRCP RLCP RPCL PCRL CPRL); then per component dx, dy,
// prec, signed, numres, cblkw, cblkh, cblksty, qmfbid, roishift, guard bits,
// then numres x (pdx, pdy) and (3 numres - 2) x (exponent, mantissa).
// data: the tile's tile-part bodies joined; headers: the packet headers
// (PPT or PPM data; n_headers < 0: in the bodies). out: per component its
// tile-component samples (int32, row-major, after the DC level shift).
int j2k_decode_tile(const int32_t* params, int64_t nparams, const uint8_t* data, int64_t n,
                    const uint8_t* headers, int64_t n_headers, int32_t* out, int64_t nout) {
  (void)nparams;
  const int tx0 = params[0], ty0 = params[1], tx1 = params[2], ty1 = params[3];
  const int ncomp = params[4], nlayers = params[5], mct = params[6], csty = params[7];
  const int nprog = params[8];
  const int32_t* progs = params + 9;
  const int32_t* p = progs + 6 * nprog;
  std::vector<Comp> comps(ncomp);
  std::vector<std::vector<int32_t>> steps(ncomp);
  std::vector<int> guard(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Comp& c = comps[ci];
    c.dx = p[0];
    c.dy = p[1];
    c.prec = p[2];
    c.sgnd = p[3];
    c.numres = p[4];
    c.cblkw = p[5];
    c.cblkh = p[6];
    c.cblksty = p[7];
    c.qmfbid = p[8];
    c.roishift = p[9];
    guard[ci] = p[10];
    p += 11;
    if (c.numres < 1 || c.numres > 33 || c.dx < 1 || c.dy < 1) return kBadArgument;
    c.x0 = ceildiv(tx0, c.dx);
    c.y0 = ceildiv(ty0, c.dy);
    c.x1 = ceildiv(tx1, c.dx);
    c.y1 = ceildiv(ty1, c.dy);
    c.res.resize(c.numres);
    for (int r = 0; r < c.numres; ++r) {
      c.res[r].pdx = p[0];
      c.res[r].pdy = p[1];
      p += 2;
    }
    steps[ci].assign(p, p + 2 * (3 * c.numres - 2));
    p += 2 * (3 * c.numres - 2);
  }
  // geometry (opj_tcd_init_tile)
  for (int ci = 0; ci < ncomp; ++ci) {
    Comp& c = comps[ci];
    for (int r = 0; r < c.numres; ++r) {
      Resolution& res = c.res[r];
      const int level = c.numres - 1 - r;
      res.x0 = ceildivpow2(c.x0, level);
      res.y0 = ceildivpow2(c.y0, level);
      res.x1 = ceildivpow2(c.x1, level);
      res.y1 = ceildivpow2(c.y1, level);
      const int pdx = res.pdx, pdy = res.pdy;
      const int prc_x0 = floordivpow2(res.x0, pdx) << pdx;
      const int prc_y0 = floordivpow2(res.y0, pdy) << pdy;
      const int prc_x1 = ceildivpow2(res.x1, pdx) << pdx, prc_y1 = ceildivpow2(res.y1, pdy) << pdy;
      res.pw = res.x0 == res.x1 ? 0 : (prc_x1 - prc_x0) >> pdx;
      res.ph = res.y0 == res.y1 ? 0 : (prc_y1 - prc_y0) >> pdy;
      int cbg_x0, cbg_y0, cbgw, cbgh;
      if (r == 0) {
        cbg_x0 = prc_x0;
        cbg_y0 = prc_y0;
        cbgw = pdx;
        cbgh = pdy;
      } else {
        cbg_x0 = ceildivpow2(prc_x0, 1);
        cbg_y0 = ceildivpow2(prc_y0, 1);
        cbgw = pdx - 1;
        cbgh = pdy - 1;
      }
      const int cblkw = std::min(c.cblkw, cbgw), cblkh = std::min(c.cblkh, cbgh);
      const int nbands = r == 0 ? 1 : 3;
      res.bands.resize(nbands);
      for (int bi = 0; bi < nbands; ++bi) {
        Band& b = res.bands[bi];
        if (r == 0) {
          b.bandno = 0;
          b.x0 = ceildivpow2(c.x0, level);
          b.y0 = ceildivpow2(c.y0, level);
          b.x1 = ceildivpow2(c.x1, level);
          b.y1 = ceildivpow2(c.y1, level);
        } else {
          b.bandno = bi + 1;
          const int64_t xob = b.bandno & 1, yob = b.bandno >> 1;
          b.x0 = ceildivpow2(c.x0 - (xob << level), level + 1);
          b.y0 = ceildivpow2(c.y0 - (yob << level), level + 1);
          b.x1 = ceildivpow2(c.x1 - (xob << level), level + 1);
          b.y1 = ceildivpow2(c.y1 - (yob << level), level + 1);
        }
        const int si = r == 0 ? 0 : 3 * (r - 1) + bi + 1;
        const int expn = steps[ci][2 * si], mant = steps[ci][2 * si + 1];
        const int gain = c.qmfbid == 1 ? (b.bandno == 0 ? 0 : b.bandno == 3 ? 2 : 1) : 0;
        const int numbps = c.prec + gain;
        float stepsize = float((1.0 + mant / 2048.0) * std::pow(2.0, numbps - expn));
        b.stepsize = stepsize;
        b.numbps = expn + guard[ci] - 1;
        b.precincts.resize(size_t(res.pw) * res.ph);
        for (int pi = 0; pi < res.pw * res.ph; ++pi) {
          Precinct& pr = b.precincts[pi];
          const int cx0 = cbg_x0 + (pi % res.pw) * (1 << cbgw);
          const int cy0 = cbg_y0 + (pi / res.pw) * (1 << cbgh);
          const int px0 = std::max(cx0, b.x0), py0 = std::max(cy0, b.y0);
          const int px1 = std::min(cx0 + (1 << cbgw), b.x1);
          const int py1 = std::min(cy0 + (1 << cbgh), b.y1);
          if (px0 >= px1 || py0 >= py1) continue;
          const int bx0 = floordivpow2(px0, cblkw) << cblkw;
          const int by0 = floordivpow2(py0, cblkh) << cblkh;
          const int bx1 = ceildivpow2(px1, cblkw) << cblkw, by1 = ceildivpow2(py1, cblkh) << cblkh;
          pr.cw = (bx1 - bx0) >> cblkw;
          pr.ch = (by1 - by0) >> cblkh;
          pr.cblks.resize(size_t(pr.cw) * pr.ch);
          for (int k = 0; k < pr.cw * pr.ch; ++k) {
            CodeBlock& cb = pr.cblks[k];
            const int x = bx0 + (k % pr.cw) * (1 << cblkw), y = by0 + (k / pr.cw) * (1 << cblkh);
            cb.x0 = std::max(x, px0);
            cb.y0 = std::max(y, py0);
            cb.x1 = std::min(x + (1 << cblkw), px1);
            cb.y1 = std::min(y + (1 << cblkh), py1);
          }
        }
      }
    }
  }
  // packet order (opj_pi_next_*): each progression's packets not yet read
  std::vector<Packet> order;
  {
    int maxres = 0;
    for (const Comp& c : comps) maxres = std::max(maxres, c.numres);
    std::vector<uint8_t> seen(size_t(nlayers) * maxres * ncomp * 1, 0);
    std::vector<std::vector<uint8_t>> seen_prec(size_t(nlayers) * maxres * ncomp);
    for (int l = 0; l < nlayers; ++l)
      for (int r = 0; r < maxres; ++r)
        for (int ci = 0; ci < ncomp; ++ci)
          if (r < comps[ci].numres)
            seen_prec[(size_t(l) * maxres + r) * ncomp + ci].assign(
                size_t(comps[ci].res[r].pw) * comps[ci].res[r].ph, 0);
    auto emit = [&](int l, int r, int ci, int pr) {
      auto& s = seen_prec[(size_t(l) * maxres + r) * ncomp + ci];
      if (s[pr]) return;
      s[pr] = 1;
      order.push_back({l, r, ci, pr});
    };
    for (int g = 0; g < nprog; ++g) {
      const int32_t* pg = progs + 6 * g;
      const int lay1 = std::min(int(pg[0]), nlayers), res0 = pg[1];
      const int res1 = std::min(int(pg[2]), maxres);
      const int comp0 = pg[3], comp1 = std::min(int(pg[4]), ncomp), prog = pg[5];
      if (prog <= 1) {  // LRCP, RLCP: precincts in raster order
        for (int o1 = 0; o1 < (prog == 0 ? lay1 : res1); ++o1)
          for (int o2 = 0; o2 < (prog == 0 ? res1 : lay1); ++o2) {
            const int l = prog == 0 ? o1 : o2, r = prog == 0 ? o2 : o1;
            if (r < res0) continue;
            for (int ci = comp0; ci < comp1; ++ci) {
              if (r >= comps[ci].numres) continue;
              const Resolution& res = comps[ci].res[r];
              for (int pr = 0; pr < res.pw * res.ph; ++pr) emit(l, r, ci, pr);
            }
          }
        continue;
      }
      // position-driven orders: each precinct at the reference-grid position
      // of its top-left corner (the tile's origin for the first row and
      // column), ordered by (r, y, x, c), (y, x, c, r) or (c, y, x, r)
      struct Pos {
        int64_t y, x;
        int r, c, pr;
      };
      std::vector<Pos> pos;
      for (int ci = comp0; ci < comp1; ++ci) {
        const Comp& c = comps[ci];
        for (int r = res0; r < std::min(res1, c.numres); ++r) {
          const Resolution& res = c.res[r];
          const int level = c.numres - 1 - r;
          if (res.pw == 0 || res.ph == 0) continue;
          const int64_t sx = int64_t(c.dx) << level, sy = int64_t(c.dy) << level;
          const int trx0 = ceildiv(tx0, sx), try0 = ceildiv(ty0, sy);
          const int trx1 = ceildiv(tx1, sx), try1 = ceildiv(ty1, sy);
          if (trx0 == trx1 || try0 == try1) continue;
          for (int pj = 0; pj < res.ph; ++pj)
            for (int pi = 0; pi < res.pw; ++pi) {
              const int64_t rx = int64_t((trx0 >> res.pdx) + pi) << res.pdx;
              const int64_t ry = int64_t((try0 >> res.pdy) + pj) << res.pdy;
              pos.push_back({std::max<int64_t>(ry * sy, ty0), std::max<int64_t>(rx * sx, tx0), r,
                             ci, pj * res.pw + pi});
            }
        }
      }
      std::stable_sort(pos.begin(), pos.end(), [&](const Pos& a, const Pos& b) {
        if (prog == 2) {
          if (a.r != b.r) return a.r < b.r;
          if (a.y != b.y) return a.y < b.y;
          if (a.x != b.x) return a.x < b.x;
          return a.c < b.c;
        }
        if (prog == 3) {
          if (a.y != b.y) return a.y < b.y;
          if (a.x != b.x) return a.x < b.x;
          if (a.c != b.c) return a.c < b.c;
          return a.r < b.r;
        }
        if (a.c != b.c) return a.c < b.c;
        if (a.y != b.y) return a.y < b.y;
        if (a.x != b.x) return a.x < b.x;
        return a.r < b.r;
      });
      for (const Pos& q : pos)
        for (int l = 0; l < lay1; ++l) emit(l, q.r, q.c, q.pr);
    }
  }
  // tier 2
  int64_t body = 0, hdr = 0;
  const bool separate = n_headers >= 0;
  for (const Packet& pk : order) {
    const int err = read_packet(comps[pk.comp], pk, headers, separate ? n_headers : 0, &hdr, data,
                                n, &body, csty & 2, csty & 4, separate);
    if (err) return err;
  }
  // tier 1, wavelets, MCT, DC level shift
  std::vector<std::vector<int32_t>> ibuf(ncomp);
  std::vector<std::vector<float>> fbuf(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Comp& c = comps[ci];
    const int w = c.x1 - c.x0, h = c.y1 - c.y0;
    std::vector<int32_t> tmp;
    if (c.qmfbid == 1) ibuf[ci].assign(size_t(w) * h, 0);
    else fbuf[ci].assign(size_t(w) * h, 0.f);
    for (int r = 0; r < c.numres; ++r) {
      Resolution& res = c.res[r];
      for (Band& b : res.bands) {
        int ox = 0, oy = 0;
        if (b.bandno & 1) ox = c.res[r - 1].x1 - c.res[r - 1].x0;
        if (b.bandno & 2) oy = c.res[r - 1].y1 - c.res[r - 1].y0;
        const float half = 0.5f * b.stepsize;
        for (Precinct& pr : b.precincts)
          for (CodeBlock& cb : pr.cblks) {
            const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (cw <= 0 || ch <= 0) continue;
            tmp.assign(size_t(cw) * ch, 0);
            if (cb.included && !cb.segs.empty()) {
              const int err = decode_codeblock(cb, b.bandno, c.cblksty, c.roishift, tmp.data(), cw);
              if (err) return err;
            }
            const int x = cb.x0 - b.x0 + ox, y = cb.y0 - b.y0 + oy;
            for (int j = 0; j < ch; ++j)
              for (int i = 0; i < cw; ++i) {
                const int32_t v = tmp[size_t(j) * cw + i];
                if (c.qmfbid == 1) ibuf[ci][size_t(y + j) * w + x + i] = v / 2;
                else fbuf[ci][size_t(y + j) * w + x + i] = float(v) * half;
              }
          }
      }
    }
    if (c.qmfbid == 1) idwt_2d(ibuf[ci].data(), w, c, idwt53_1d);
    else idwt_2d(fbuf[ci].data(), w, c, idwt97_1d);
  }
  if (mct && ncomp >= 3) {
    for (int ci = 1; ci < 3; ++ci)
      if (comps[ci].qmfbid != comps[0].qmfbid ||
          comps[ci].x1 - comps[ci].x0 != comps[0].x1 - comps[0].x0 ||
          comps[ci].y1 - comps[ci].y0 != comps[0].y1 - comps[0].y0)
        return kUnsupported;
    const size_t np = ibuf[0].size() + fbuf[0].size();
    if (comps[0].qmfbid == 1) {
      for (size_t i = 0; i < np; ++i) {
        const int32_t y = ibuf[0][i], u = ibuf[1][i], v = ibuf[2][i];
        const int32_t g = y - ((u + v) >> 2);
        ibuf[0][i] = v + g;
        ibuf[1][i] = g;
        ibuf[2][i] = u + g;
      }
    } else {
      for (size_t i = 0; i < np; ++i) {
        const float y = fbuf[0][i], u = fbuf[1][i], v = fbuf[2][i];
        fbuf[0][i] = y + (v * 1.402f);
        fbuf[1][i] = y - (u * 0.34413f) - (v * 0.71414f);
        fbuf[2][i] = y + (u * 1.772f);
      }
    }
  }
  int64_t o = 0;
  for (int ci = 0; ci < ncomp; ++ci) {
    const Comp& c = comps[ci];
    const size_t np = size_t(c.x1 - c.x0) * (c.y1 - c.y0);
    if (o + int64_t(np) > nout) return kBadArgument;
    const int64_t lo = c.sgnd ? -(int64_t(1) << (c.prec - 1)) : 0;
    const int64_t hi = c.sgnd ? (int64_t(1) << (c.prec - 1)) - 1 : (int64_t(1) << c.prec) - 1;
    const int64_t shift = c.sgnd ? 0 : int64_t(1) << (c.prec - 1);
    for (size_t i = 0; i < np; ++i) {
      int64_t v;
      if (c.qmfbid == 1) {
        v = int64_t(ibuf[ci][i]) + shift;
      } else {
        const float f = fbuf[ci][i];
        if (f > float(INT32_MAX)) {
          out[o + i] = int32_t(hi);
          continue;
        }
        if (f < float(INT32_MIN)) {
          out[o + i] = int32_t(lo);
          continue;
        }
        v = int64_t(std::lrint(f)) + shift;
      }
      out[o + i] = int32_t(std::min(std::max(v, lo), hi));
    }
    o += int64_t(np);
  }
  return kOk;
}

}  // extern "C"
