"""JPEG in numpy: the decoder that reads eval scans (the JAX package reads
them with PIL) and the baseline encoder that writes the eval CLI's reference
images (the JAX package writes them with cv2.imwrite).

Both follow libjpeg-turbo's integer arithmetic step for step, so `decode`
gives PIL's pixels and `encode` gives the quantized coefficients cv2's
file holds:
- decode: Huffman entropy decoding (one Python loop over the symbols with
  a 16-bit look-ahead table: one lookup gives a symbol, its code length
  and, where they fit in the 16 bits, its value bits; a progressive file's
  scans in jdphuff.c's four kinds: DC first, DC refinement, AC first with
  its end-of-band runs, AC refinement with its correction bits), then,
  vectorised over all blocks, dequantisation, the islow integer IDCT
  (jidctint.c), fancy (triangle) upsampling of 4:2:2 and 4:2:0 chroma
  (jdsample.c) and the fixed-point YCbCr -> RGB tables (jdcolor.c);
- encode: the fixed-point RGB -> YCbCr tables (jccolor.c), edge
  replication and h2v2 downsampling with alternating biases 1, 2
  (jcsample.c), the islow integer forward DCT (jfdctint.c), quantisation
  by libjpeg-turbo's reciprocals (jcdctmgr.c), the IJG quality scaling of
  the standard tables (jcparam.c) and the standard Huffman tables, at
  4:2:0 with no restart markers (cv2.imwrite's defaults: quality 95, no
  optimisation). Huffman coding and bit packing are vectorised.

`decode_native` and `encode_native` (what the data paths call) parse and
write the same markers and raise the same errors in Python, and run the
per-symbol and per-pixel work in the host library (data/native.py,
csrc/host/jpeg.cpp) with the same integer arithmetic: the same pixels and
the same bytes as `decode` and `encode`, which stay as their plain
versions.

`decode` takes 8-bit files of the baseline, extended-sequential,
progressive and lossless Huffman processes (SOF0-SOF3) and the sequential
and progressive arithmetic-coded ones (SOF9, SOF10: jdarith.c's decoder,
one Python call per binary decision, with the DAC marker's conditioning):
grayscale, three components at 4:4:4, 4:2:2 or 4:2:0 (YCbCr, or RGB), or
four (Adobe CMYK or YCCK, returned as PIL reads them: libjpeg's CMYK
inverted), with or without restart intervals, of any size. A lossless
file (jdlhuff.c, jdlossls.c) decodes its Huffman-coded differences, undoes
predictors 1-7 and the point transform, and goes through the same colour
conversion, its chroma upsampled by replication as libjpeg's upsampler
does without DCT scaling. A hierarchical, arithmetic-coded lossless or
12-bit file, or any other sampling, raises ValueError naming what it is,
as PIL refuses them. A progressive file must hold every scan: libjpeg's
block smoothing of a partly refined image does not arise.
"""
from __future__ import annotations

import functools
import struct
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from . import native

# zigzag position -> natural (row-major) index within the 8 x 8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = ZIGZAG.tolist()

_SOF_KIND = {0xC5: "hierarchical (differential)",
             0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
             0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
             0xCE: "arithmetic-coded hierarchical progressive",
             0xCF: "arithmetic-coded hierarchical lossless"}

# islow constants: FIX(x) = round(x * 2^13) (jidctint.c, jfdctint.c)
_CONST_BITS, _PASS1_BITS = 13, 2
F0_298, F0_390, F0_541, F0_765 = 2446, 3196, 4433, 6270
F0_899, F1_175, F1_501, F1_847 = 7373, 9633, 12299, 15137
F1_961, F2_053, F2_562, F3_072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# ------------------------------------------------------------- entropy decode

def _canonical_codes(counts, symbols):
    """DHT counts (codes of each length 1-16) and symbols -> [(length, code,
    symbol), ...] in the canonical order (JPEG Annex C)."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((length, code, symbols[k]))
            code += 1
            k += 1
        code <<= 1
    return out


def _check_codes(counts: bytes, symbols: bytes) -> list:
    """The canonical codes of a DHT table, ValueError if they overflow
    their lengths or the table lists fewer symbols than its counts."""
    if sum(counts) > len(symbols):
        raise ValueError("JPEG: invalid Huffman table (fewer symbols than its counts)")
    codes = _canonical_codes(counts, symbols)
    if any(c >> length for length, c, _ in codes):
        raise ValueError("JPEG: invalid Huffman table (codes overflow their lengths)")
    return codes


@functools.lru_cache(maxsize=64)
def _lookup(counts: bytes, symbols: bytes, ac: bool) -> list:
    """The 16-bit look-ahead table of one Huffman table: per 16-bit prefix
    of the bit stream, AC (run, value, bits, extra) or DC (value, bits,
    extra). Where the code and its value bits fit in 16, `bits` spans both
    and `extra` is 0; otherwise `bits` is the code length and `extra` the
    value bits still to read. AC's EOB has run 128 (ends the block), ZRL
    run 15 and value 0 (skips 16 positions). A prefix no code matches maps to
    None (the decode loop fails to unpack it: corrupt data)."""
    codes = _check_codes(counts, symbols)
    n = 1 << 16
    length = np.zeros(n, np.int64)
    sym = np.zeros(n, np.int64)
    for ln, c, s in codes:
        lo = c << (16 - ln)
        length[lo:lo + (1 << (16 - ln))] = ln
        sym[lo:lo + (1 << (16 - ln))] = s
    size = sym & 15
    prefix = np.arange(n, dtype=np.int64)
    fast = length + size <= 16
    total = np.where(fast, length + size, length)
    t = (prefix >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
    value = np.where(t >> np.maximum(size - 1, 0) > 0, t, t - (1 << size) + 1)
    value = np.where(fast & (size > 0), value, 0)
    extra = np.where(fast, 0, size)
    if ac:
        run = np.where(sym == 0, 128, sym >> 4)
        table = list(zip(run.tolist(), value.tolist(), total.tolist(), extra.tolist()))
    else:
        table = list(zip(value.tolist(), total.tolist(), extra.tolist()))
    for i in np.flatnonzero(length == 0).tolist():
        table[i] = None
    return table


def _windows(segment: np.ndarray) -> list:
    """Destuffed entropy-coded bytes -> per byte i the 24-bit window
    b[i] b[i+1] b[i+2] (two zero bytes past the end, as libjpeg reads zeros
    there; reading further raises IndexError), as a list for fast indexing:
    the 16 bits at bit p are (w[p >> 3] >> (8 - (p & 7))) & 0xFFFF."""
    b = np.concatenate([segment, np.zeros(4, np.uint8)]).astype(np.int64)
    return (b[:-2] << 16 | b[1:-1] << 8 | b[2:]).tolist()


def _decode_segment(w, blocks, tables, out):
    """Huffman-decode one restart interval: `blocks` [(component slot, flat
    offset of the block's 64 coefficients), ...] in scan order, `tables`
    per slot (DC table, AC table). Appends to `out`, per non-zero
    coefficient, (flat index << 16) + value, the flat index the block's
    offset + the zigzag position, the DC value the predicted one
    (predictors reset at the interval's start)."""
    append = out.append
    pred = [0] * len(tables)
    p = 0
    for ci, base in blocks:
        dct, act = tables[ci]
        diff, n, s = dct[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        p += n
        if s:
            t = ((w[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
            p += s
            diff = t if t >> (s - 1) else t - (1 << s) + 1
        pred[ci] += diff
        append((base << 16) + pred[ci])
        k = 1
        while k < 64:
            r, val, n, s = act[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            p += n
            k += r
            if s:
                t = ((w[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                p += s
                val = t if t >> (s - 1) else t - (1 << s) + 1
            if val:
                append(((base + k) << 16) + val)
            k += 1
        if 64 < k < 128:
            raise ValueError("JPEG: AC coefficients run past the end of a block")


class _OutOfRange(Exception):
    """A decoded coefficient outside JCOEF's 16 bits: corrupt data."""


@functools.lru_cache(maxsize=64)
def _code_lookup(counts: bytes, symbols: bytes) -> list:
    """Per 16-bit prefix of the bit stream, (code length, symbol) of the
    code it starts with, or None where no code matches."""
    codes = _check_codes(counts, symbols)
    table: list = [None] * (1 << 16)
    for ln, c, sym in codes:
        lo = c << (16 - ln)
        table[lo:lo + (1 << (16 - ln))] = [(ln, sym)] * (1 << (16 - ln))
    return table


def _extend(t: int, s: int) -> int:
    return t if t >> (s - 1) else t - (1 << s) + 1


def _jcoef(v: int) -> int:
    if not -32768 <= v <= 32767:
        raise _OutOfRange
    return v


def _decode_progressive_segment(w, blocks, tables, ss, se, ah, al, c):
    """One restart interval of a progressive scan (jdphuff.c) into the flat
    coefficient list `c` (natural order per block): `blocks` [(slot, flat
    offset), ...], `tables` per slot the code lookup (DC table for DC
    first, AC table for AC scans). A symbol's size is its low four bits;
    bits are read as `_windows` gives them; an AC coefficient past Se
    raises ValueError. The host library's jpeg_decode_progressive does the
    same steps."""
    p = 0
    pred = [0] * len(tables)
    eobrun = 0
    p1 = 1 << al

    def bits(n):  # the next n (1-16) bits
        return ((w[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - n)

    def refine(i):  # a correction bit for the non-zero coefficient c[i]
        if bits(1) and not c[i] & p1:
            c[i] = _jcoef(c[i] + (p1 if c[i] >= 0 else -p1))

    for ci, base in blocks:
        table = tables[ci]
        if ss == 0 and ah == 0:  # DC first
            ln, sym = table[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            p += ln
            s = sym & 15
            if s:
                pred[ci] += _extend(bits(s), s)
                p += s
            c[base] = _jcoef(pred[ci] * p1)
        elif ss == 0:  # DC refinement
            if bits(1):
                c[base] |= p1
            p += 1
        elif ah == 0:  # AC first
            if eobrun > 0:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                ln, sym = table[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                p += ln
                r, s = sym >> 4, sym & 15
                if s:
                    k += r
                    if k > se:
                        raise ValueError("JPEG: AC coefficients run past the end of a block")
                    v = _extend(bits(s), s)
                    p += s
                    c[base + _ZZ[k]] = _jcoef(v * p1)
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += bits(r)
                        p += r
                    eobrun -= 1
                    break
                k += 1
        else:  # AC refinement
            k = ss
            if eobrun == 0:
                while k <= se:
                    ln, sym = table[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                    p += ln
                    r, s = sym >> 4, sym & 15
                    if s:  # a newly non-zero coefficient, its sign in one bit
                        s = p1 if bits(1) else -p1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += bits(r)
                            p += r
                        break
                    # skip r zero coefficients, refining the non-zero ones passed
                    while k <= se:
                        i = base + _ZZ[k]
                        if c[i]:
                            refine(i)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > se:
                            raise ValueError("JPEG: AC coefficients run past the end of a block")
                        c[base + _ZZ[k]] = s
                    k += 1
            if eobrun > 0:  # the band's rest: refine its non-zero coefficients
                while k <= se:
                    i = base + _ZZ[k]
                    if c[i]:
                        refine(i)
                        p += 1
                    k += 1
                eobrun -= 1


# ------------------------------------------------- arithmetic decoding

# Table D.3 of ITU-T T.81 as libjpeg-turbo's jaricom.c packs it: per state
# Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; state
# 113 is the fixed one-half estimate of sign and DC-refinement bits
ARITAB = (
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
    0x59eb6ff0, 0x5a1d7171)


def _wrap16(v: int) -> int:
    """v as JCOEF (int16) holds it."""
    return ((v + 32768) & 0xFFFF) - 32768


class _ArithDecoder:
    """jdarith.c's arith_decode on one restart interval's destuffed bytes
    (zeros past its end, as libjpeg supplies them after a marker)."""

    def __init__(self, segment):
        self.data = segment.tolist() if hasattr(segment, "tolist") else list(segment)
        self.pos = self.c = self.a = 0
        self.ct = -16

    def decode(self, st, i: int) -> int:
        """One binary decision with the statistics bin st[i] (updated)."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | (self.data[self.pos] if self.pos < len(self.data) else 0)
                self.pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_magnitude(d, stats, st: int, m: int, top: int) -> int:
    """Figures F.23 and F.24: the magnitude category's further bits from
    bin `top` on (m the first category bit, already 1), then the magnitude
    bits, each 14 bins after the last category bin; returns |v| - 1."""
    st = top
    while d.decode(stats, st):
        m <<= 1
        if m == 0x8000:
            raise _OutOfRange
        st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if d.decode(stats, st):
            v |= m
        m >>= 1
    return v


def _arith_dc(d, stats, ctx: int, cond) -> Tuple[int, int]:
    """Figure F.19 (Decode_DC_DIFF): (the DC difference, the component's
    next conditioning context) from context `ctx`; cond (L, U) of its
    table."""
    if d.decode(stats, ctx) == 0:
        return 0, 0
    sign = d.decode(stats, ctx + 1)
    st = ctx + 2 + sign
    if d.decode(stats, st):
        v = _arith_magnitude(d, stats, st, 1, 20)
        m = v.bit_length() and 1 << (v.bit_length() - 1)
    else:
        v = m = 0
    low, high = cond
    ctx = 0 if m < (1 << low) >> 1 else (12 + 4 * sign if m > (1 << high) >> 1 else 4 + 4 * sign)
    return (-(v + 1) if sign else v + 1), ctx


def _arith_ac_value(d, stats, fixed, st: int, k: int, kx: int) -> int:
    """Figures F.21-F.24 for an AC coefficient at band k whose bins start at
    st (k <= kx takes the low magnitude bins): its value."""
    sign = d.decode(fixed, 0)
    st += 2
    if not d.decode(stats, st):
        v = 0
    elif not d.decode(stats, st):
        v = 1
    else:
        v = _arith_magnitude(d, stats, st, 2, 189 if k <= kx else 217)
    return -(v + 1) if sign else v + 1


def _decode_arith_segment(segment, blocks, tables, cond, params, c) -> None:
    """One restart interval of an arithmetic-coded scan (jdarith.c) into
    the flat coefficient list `c`: blocks [(slot, flat offset), ...],
    tables per slot its (DC, AC) conditioning table numbers, cond the DAC
    marker's (L, U) per DC table and Kx per AC table, params (progressive,
    Ss, Se, Ah, Al). Statistics, DC predictions and contexts start afresh.
    A magnitude past 15 bits or coefficients past Se raise ValueError."""
    progressive, ss, se, ah, al = params
    d = _ArithDecoder(segment)
    dc_stats = {t: bytearray(64) for t, _ in tables}
    ac_stats = {t: bytearray(256) for _, t in tables}
    fixed = bytearray([113])
    last = [0] * len(tables)
    ctx = [0] * len(tables)
    dc_cond, ac_k = cond
    p1 = 1 << al
    for slot, base in blocks:
        td, ta = tables[slot]
        if not progressive or (ss == 0 and ah == 0):  # DC (sequential or first)
            diff, ctx[slot] = _arith_dc(d, dc_stats[td], ctx[slot], dc_cond[td])
            last[slot] = (last[slot] + diff) & 0xFFFF
            c[base] = _wrap16(last[slot] << al)
            if progressive:
                continue
            stats, k = ac_stats[ta], 0
            while k < 63:
                st = 3 * k
                if d.decode(stats, st):
                    break
                while True:
                    k += 1
                    if d.decode(stats, st + 1):
                        break
                    st += 3
                    if k >= 63:
                        raise ValueError("JPEG: AC coefficients run past the end of a block")
                c[base + _ZZ[k]] = _wrap16(_arith_ac_value(d, stats, fixed, st, k, ac_k[ta]))
        elif ss == 0:  # DC refinement
            if d.decode(fixed, 0):
                c[base] |= p1
        elif ah == 0:  # AC first
            stats, k = ac_stats[ta], ss
            while k <= se:
                st = 3 * (k - 1)
                if d.decode(stats, st):
                    break
                while d.decode(stats, st + 1) == 0:
                    st += 3
                    k += 1
                    if k > se:
                        raise ValueError("JPEG: AC coefficients run past the end of a block")
                v = _arith_ac_value(d, stats, fixed, st, k, ac_k[ta])
                c[base + _ZZ[k]] = _wrap16(v << al)
                k += 1
        else:  # AC refinement
            stats = ac_stats[ta]
            kex = se
            while kex > 0 and not c[base + _ZZ[kex]]:
                kex -= 1
            k = ss
            while k <= se:
                st = 3 * (k - 1)
                if k > kex and d.decode(stats, st):
                    break
                while True:
                    i = base + _ZZ[k]
                    if c[i]:
                        if d.decode(stats, st + 2):
                            c[i] = _wrap16(c[i] + (-p1 if c[i] < 0 else p1))
                        break
                    if d.decode(stats, st + 1):
                        c[i] = -p1 if d.decode(fixed, 0) else p1
                        break
                    st += 3
                    k += 1
                    if k > se:
                        raise ValueError("JPEG: AC coefficients run past the end of a block")
                k += 1


# ------------------------------------------------------------- lossless

def _decode_lossless_segment(w, samples, tables, out) -> None:
    """One restart interval of a lossless scan (jdlhuff.c): per sample
    [(slot, flat offset), ...] its Huffman-coded difference (category 16
    is 32768 with no value bits) into out[offset]; tables per slot the code
    lookup of its DC table."""
    p = 0
    for ci, pos in samples:
        ln, s = tables[ci][(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
        p += ln
        if s == 16:
            out[pos] = 32768
        elif s:
            if s > 16:
                raise IndexError
            out[pos] = _extend(((w[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s), s)
            p += s
        else:
            out[pos] = 0


def undifference(plane: np.ndarray, width: int, height: int, psv: int, pt: int,
                 restart_rows: int) -> None:
    """jdlossls.c in place on one component's [rows, pitch] plane of
    differences (int64): the first row of the scan and of each restart
    interval (every restart_rows rows, 0 for none) predicted from its left
    neighbour and 1 << (7 - pt), the first column from above, the rest by
    predictor psv (1-7), each sample (difference + prediction) mod 2^16;
    then the point transform, (sample << pt) mod 256."""
    rows = plane[:height, :width].tolist()
    for y, row in enumerate(rows):
        if y == 0 or (restart_rows and y % restart_rows == 0):
            ra = 1 << (7 - pt)
            for x in range(width):
                ra = row[x] = (row[x] + ra) & 0xFFFF
            continue
        prev = rows[y - 1]
        rb = prev[0]
        ra = row[0] = (row[0] + rb) & 0xFFFF
        for x in range(1, width):
            rc, rb = rb, prev[x]
            if psv == 1:
                pred = ra
            elif psv == 2:
                pred = rb
            elif psv == 3:
                pred = rc
            elif psv == 4:
                pred = ra + rb - rc
            elif psv == 5:
                pred = ra + ((rb - rc) >> 1)
            elif psv == 6:
                pred = rb + ((ra - rc) >> 1)
            else:
                pred = (ra + rb) >> 1
            ra = row[x] = (row[x] + pred) & 0xFFFF
    plane[:height, :width] = (np.array(rows, np.int64).reshape(height, width) << pt) & 0xFF


def _split_scan(data: bytes, pos: int):
    """Entropy-coded data from `pos` -> (destuffed segments between restart
    markers, position of the marker that ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    marker = (nxt != 0x00) & (nxt != 0xFF)
    rst = marker & (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[marker & ~rst]
    end = int(ends[0]) if len(ends) else len(arr)
    cuts = ff[rst & (ff < end)]
    starts = np.concatenate([[0], cuts + 2])
    stops = np.concatenate([cuts, [end]])
    segments = []
    for a, b in zip(starts.tolist(), stops.tolist()):
        seg = arr[a:b]
        stuffed = np.flatnonzero((seg[:-1] == 0xFF) & (seg[1:] == 0x00)) + 1
        segments.append(np.delete(seg, stuffed))
    return segments, pos + end


# ------------------------------------------------------------------ IDCT

def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """The islow butterfly (jidctint.c) on int64 arrays: the eight sums
    before their descale, outputs 0-7."""
    z1 = (x2 + x6) * F0_541
    tmp2 = z1 - x6 * F1_847
    tmp3 = z1 + x2 * F0_765
    tmp0 = (x0 + x4) << _CONST_BITS
    tmp1 = (x0 - x4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1_175
    t0, t1, t2, t3 = t0 * F0_298, t1 * F2_053, t2 * F3_072, t3 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients [N, 8, 8] (row = vertical frequency) ->
    uint8 samples [N, 8, 8]: jpeg_idct_islow, columns then rows, with the
    output clamped to 0-255 after the +128 level shift (the SIMD kernels'
    saturation, equal to libjpeg's range table on every valid stream)."""
    c = coef.astype(np.int64)
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS)
                   for v in _idct_1d(*(c[:, i, :] for i in range(8)))], axis=1)
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3)
                    for v in _idct_1d(*(ws[:, :, i] for i in range(8)))], axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# ------------------------------------------------------ upsampling, colour

def _edge(a: np.ndarray, axis: int):
    """(a shifted one back, a shifted one forward) along axis, the edge
    sample repeated."""
    n = a.shape[axis]
    prev = np.take(a, np.r_[0, np.arange(n - 1)], axis=axis)
    nxt = np.take(a, np.r_[np.arange(1, n), n - 1], axis=axis)
    return prev, nxt


def _interleave(even, odd, axis):
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample_h2v1(plane: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample: out[2i] = (3 in[i] + in[i-1] + 1)
    >> 2, out[2i+1] = (3 in[i] + in[i+1] + 2) >> 2, edges repeated; a
    plane 2 or fewer samples wide is replicated (h2v1_upsample)."""
    x = plane.astype(np.int32)
    if x.shape[1] <= 2:
        return np.repeat(plane, 2, axis=1)
    prev, nxt = _edge(x, 1)
    return _interleave((3 * x + prev + 1) >> 2, (3 * x + nxt + 2) >> 2, 1).astype(np.uint8)


def upsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample: column sums 3 in[row] + in[row
    above] (upper output row) or in[row below] (lower), then out[2i] =
    (3 c[i] + c[i-1] + 8) >> 4, out[2i+1] = (3 c[i] + c[i+1] + 7) >> 4,
    edges repeated; a plane 2 or fewer samples wide is replicated
    (h2v2_upsample)."""
    x = plane.astype(np.int32)
    if x.shape[1] <= 2:
        return np.repeat(np.repeat(plane, 2, axis=0), 2, axis=1)
    above, below = _edge(x, 0)
    rows = _interleave(3 * x + above, 3 * x + below, 0)
    prev, nxt = _edge(rows, 1)
    return _interleave((3 * rows + prev + 8) >> 4, (3 * rows + nxt + 7) >> 4, 1).astype(np.uint8)


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


_CENTRED = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix16(1.40200) * _CENTRED + (1 << 15)) >> 16
_CB_B = (_fix16(1.77200) * _CENTRED + (1 << 15)) >> 16
_CR_G = -_fix16(0.71414) * _CENTRED
_CB_G = -_fix16(0.34414) * _CENTRED + (1 << 15)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on uint8 planes -> uint8 [H, W, 3]."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- decoder

def _next_marker(data: bytes, pos: int, name: str):
    """The marker segment at `pos` (fill bytes skipped): (marker, payload
    start, payload, position after it); SOI, EOI and RSTn have no payload."""
    if pos >= len(data) or data[pos] != 0xFF:
        raise ValueError(f"{name}: corrupt or truncated JPEG (no marker at byte {pos})")
    while pos < len(data) and data[pos] == 0xFF:
        pos += 1
    if pos >= len(data):
        raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
    marker = data[pos]
    pos += 1
    if marker in (0x01, 0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
        return marker, pos, b"", pos
    if pos + 2 > len(data):
        raise ValueError(f"{name}: truncated JPEG (marker segment at byte {pos})")
    (n,) = struct.unpack(">H", data[pos:pos + 2])
    return marker, pos + 2, data[pos + 2:pos + n], pos + n


def frame_header(data: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(SOFn marker, component count) of a JPEG's frame header."""
    pos = 2
    while True:
        marker, _, body, pos = _next_marker(data, pos, name)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if len(body) < 6:
                raise ValueError(f"{name}: truncated JPEG frame header")
            return marker, body[5]
        if marker in (0xD9, 0xDA):
            raise ValueError(f"{name}: JPEG without a frame header")


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W] (grayscale), [H, W, 3] (RGB) or [H, W, 4]
    (CMYK), as np.asarray(PIL.Image.open(f)) gives them."""
    native.count(native.plain_calls, "jpeg_decode")
    return _decode(data, name, use_native=False)


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """`decode` with the entropy decoding and the reconstruction in the host
    library: the same pixels and the same errors."""
    return _decode(data, name, use_native=True)


def _decode(data: bytes, name: str, use_native: bool) -> np.ndarray:
    """_decode_markers, a marker segment too short for its fields raising
    ValueError as other corrupt data do."""
    try:
        return _decode_markers(data, name, use_native)
    except (struct.error, IndexError) as e:
        raise ValueError(f"{name}: corrupt JPEG (a marker segment shorter than its fields)") \
            from e


def _decode_markers(data: bytes, name: str, use_native: bool) -> np.ndarray:
    qt: Dict[int, np.ndarray] = {}
    ht: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    frame = None
    restart = 0
    adobe_transform = None
    comps: List[dict] = []
    coefs = None
    process = None
    # the DAC marker's conditioning: (L, U) per DC table, Kx per AC table
    cond = ([(0, 1)] * 4, [5] * 4)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        marker, start, body, pos = _next_marker(data, pos, name)
        if marker == 0xD9:
            break
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    q = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    q = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                nat = np.empty(64, np.int64)
                nat[ZIGZAG] = q
                qt[tq] = nat
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = bytes(body[i + 1:i + 17])
                total = sum(counts)
                ht[(tc, th)] = (counts, bytes(body[i + 17:i + 17 + total]))
                i += 17 + total
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xCC:
            dc, ac = list(cond[0]), list(cond[1])
            for i in range(0, len(body) - 1, 2):
                tc, tb, v = body[i] >> 4, body[i] & 15, body[i + 1]
                if tb > 3 or (tc and not 1 <= v <= 63) or (not tc and (v & 15) > (v >> 4)):
                    raise ValueError(f"{name}: invalid JPEG arithmetic conditioning (DAC)")
                if tc:
                    ac[tb] = v
                else:
                    dc[tb] = (v & 15, v >> 4)
            cond = (dc, ac)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker in _SOF_KIND:
            raise ValueError(f"{name}: {_SOF_KIND[marker]} JPEG (SOF{marker - 0xC0}) is not "
                             "supported; baseline, extended, progressive or lossless Huffman "
                             "(SOF0-SOF3) or arithmetic-coded (SOF9, SOF10) files only")
        elif marker in _PROCESS:
            if frame is not None:
                raise ValueError(f"{name}: JPEG with a second frame header")
            process = _PROCESS[marker]
            unit = 1 if process.lossless else 8  # samples across a data unit
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit JPEG is not supported (8-bit only)")
            if nc not in (1, 3, 4):
                raise ValueError(f"{name}: JPEG with {nc} components is not supported "
                                 "(grayscale, YCbCr, RGB, CMYK or YCCK only)")
            if h == 0 or w == 0:
                raise ValueError(f"{name}: JPEG with a zero dimension ({w} x {h}) or a DNL "
                                 "marker is not supported")
            comps = [dict(id=body[6 + 3 * c], h=body[7 + 3 * c] >> 4, v=body[7 + 3 * c] & 15,
                          tq=body[8 + 3 * c]) for c in range(nc)]
            if any(not 1 <= c["h"] <= 4 or not 1 <= c["v"] <= 4 for c in comps):
                raise ValueError(f"{name}: invalid JPEG sampling factors (1-4 each)")
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            ratios = {(hmax // c["h"], vmax // c["v"]) for c in comps}
            if (any(hmax % c["h"] or vmax % c["v"] for c in comps)
                    or not ratios <= {(1, 1), (2, 1), (2, 2)}
                    or (nc == 3 and (comps[0]["h"], comps[0]["v"]) != (hmax, vmax))):
                samp = ",".join(f"{c['h']}x{c['v']}" for c in comps)
                kind = "CMYK/YCCK JPEG sampling" if nc == 4 else "JPEG chroma sampling"
                raise ValueError(f"{name}: {kind} {samp} is not supported "
                                 "(4:4:4, 4:2:2 or 4:2:0 only)")
            mcux = -(-w // (unit * hmax))
            mcuy = -(-h // (unit * vmax))
            offset = 0
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-w * c["h"] // hmax)
                c["h_px"] = -(-h * c["v"] // vmax)
                c["offset"] = offset
                offset += c["bw"] * c["bh"] * unit * unit
            frame = (h, w, hmax, vmax, mcux, mcuy)
            coefs = np.zeros(offset, np.int64)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            pos = _decode_scan(data, start, body, frame, comps, ht, restart, coefs, name,
                               use_native, process, cond)
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    if use_native:
        return _reconstruct_native(frame, comps, qt, coefs, adobe_transform, name,
                                   process.lossless)
    return _reconstruct(frame, comps, qt, coefs, adobe_transform, name, process.lossless)


class _Process(NamedTuple):
    progressive: bool
    arithmetic: bool
    lossless: bool


# the frame markers decoded: baseline, extended, progressive and lossless
# Huffman, sequential and progressive arithmetic
_PROCESS = {0xC0: _Process(False, False, False), 0xC1: _Process(False, False, False),
            0xC2: _Process(True, False, False), 0xC3: _Process(False, False, True),
            0xC9: _Process(False, True, False), 0xCA: _Process(True, True, False)}


def _scan_tables(ht, scan, ss, ah, progressive, name) -> list:
    """The Huffman tables one scan reads, per slot (DC, AC) as DHT (counts,
    symbols) pairs; a progressive scan reads the DC table (DC first), the
    AC table (AC scans) or none (DC refinement), the others left empty."""
    none = (bytes(16), b"")
    tables = []
    for c, td, ta in scan:
        dc = (0, td) if not progressive or (ss == 0 and ah == 0) else None
        ac = (1, ta) if not progressive or ss > 0 else None
        if (dc and dc not in ht) or (ac and ac not in ht):
            raise ValueError(f"{name}: JPEG scan uses an undefined Huffman table")
        pair = (ht[dc] if dc else none, ht[ac] if ac else none)
        for t in pair:
            _check_codes(*t)
        tables.append(pair)
    return tables


def _decode_scan(data, start, body, frame, comps, ht, restart, coefs, name,
                 use_native, process, cond) -> int:
    """Decode one scan into `coefs` (natural order per block; a lossless
    file's samples, row-major per component); returns the position of the
    marker that ends it."""
    progressive, arithmetic, lossless = process
    h, w, hmax, vmax, mcux, mcuy = frame
    ns = body[0]
    by_id = {c["id"]: c for c in comps}
    scan = []
    for j in range(ns):
        cid, tdta = body[1 + 2 * j], body[2 + 2 * j]
        if cid not in by_id:
            raise ValueError(f"{name}: JPEG scan names an unknown component {cid}")
        scan.append((by_id[cid], tdta >> 4, tdta & 15))
    ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if lossless:
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al > 7:
            raise ValueError(f"{name}: invalid lossless JPEG scan parameters (predictor {ss}, "
                             f"Se={se} Ah={ah} Pt={al})")
    elif not progressive and (ss, se, ahal) != (0, 63, 0):
        raise ValueError(f"{name}: progressive JPEG scan parameters in a sequential file")
    if progressive and ((se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
                        or (ah != 0 and al != ah - 1) or al > 13):
        raise ValueError(f"{name}: invalid progressive JPEG scan parameters (Ss={ss} Se={se} "
                         f"Ah={ah} Al={al}, {ns} components)")
    if lossless:
        if any((0, td) not in ht for _, td, _ in scan):
            raise ValueError(f"{name}: JPEG scan uses an undefined Huffman table")
        tables = [(ht[(0, td)],) for _, td, _ in scan]
        for (t,) in tables:
            _check_codes(*t)
    elif not arithmetic:
        tables = _scan_tables(ht, scan, ss, ah, progressive, name)
    unit = 1 if lossless else 64  # coefficients or samples in a data unit
    if ns == 1:
        c = scan[0][0]
        bw, bh = (c["w"], c["h_px"]) if lossless else (-(-c["w"] // 8), -(-c["h_px"] // 8))
        yy, xx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        bases = (c["offset"] + (yy * c["bw"] + xx) * unit).reshape(-1)
        slots = np.zeros_like(bases)
        per_mcu = 1
        mcus_per_row = bw
    else:
        parts, slot = [], []
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        for k, (c, _, _) in enumerate(scan):
            for v in range(c["v"]):
                for u in range(c["h"]):
                    by, bx = my * c["v"] + v, mx * c["h"] + u
                    parts.append(c["offset"] + (by * c["bw"] + bx) * unit)
                    slot.append(k)
        bases = np.stack(parts, axis=-1).reshape(-1)
        slots = np.tile(np.array(slot), mcuy * mcux)
        per_mcu = len(slot)
        mcus_per_row = mcux
    segments, end = _split_scan(data, start + len(body))
    step = restart * per_mcu if restart else len(bases)
    if len(segments) < -(-len(bases) // step):
        raise ValueError(f"{name}: JPEG scan has fewer restart intervals than its blocks need")
    segments = segments[:-(-len(bases) // step)]
    if lossless:
        if restart % mcus_per_row:
            raise ValueError(f"{name}: lossless JPEG restart interval of {restart} MCUs, not a "
                             f"whole number of {mcus_per_row}-MCU rows")
        _decode_lossless_scan(segments, bases, slots, step, [t[0] for t in tables], coefs, name,
                              use_native)
        for c, _, _ in scan:
            rows = restart // mcus_per_row * (c["v"] if ns > 1 else 1)
            plane = coefs[c["offset"]:c["offset"] + c["bw"] * c["bh"]].reshape(c["bh"], c["bw"])
            if use_native:
                native.jpeg_undifference(plane, c["w"], c["h_px"], ss, al, rows)
            else:
                undifference(plane, c["w"], c["h_px"], ss, al, rows)
        return end
    if arithmetic:
        tables = [(td, ta) for _, td, ta in scan]
        if any(td > 3 or ta > 3 for td, ta in tables):
            raise ValueError(f"{name}: JPEG scan uses an undefined arithmetic conditioning table")
        params = (progressive, ss, se, ah, al)
        if use_native:
            err = native.jpeg_decode_arith(segments, bases, slots, step, tables, cond, params,
                                           coefs)
            if err == native.AC_PAST_END:
                raise ValueError("JPEG: AC coefficients run past the end of a block")
            if err:
                raise ValueError(f"{name}: corrupt arithmetic-coded JPEG data")
            return end
        blocks = list(zip(slots.tolist(), bases.tolist()))
        c = coefs.tolist()
        try:
            for i, seg in enumerate(segments):
                _decode_arith_segment(seg, blocks[i * step:(i + 1) * step], tables, cond, params,
                                      c)
        except _OutOfRange as e:
            raise ValueError(f"{name}: corrupt arithmetic-coded JPEG data") from e
        coefs[:] = c
        return end
    if use_native:
        if progressive:
            err = native.jpeg_decode_progressive(
                segments, bases, slots, step, [pair[0 if ss == 0 else 1] for pair in tables],
                (ss, se, ah, al), coefs)
        else:
            err = native.jpeg_decode_scan(segments, bases, slots, step, tables, coefs)
        if err == native.AC_PAST_END:
            raise ValueError("JPEG: AC coefficients run past the end of a block")
        if err:
            raise ValueError(f"{name}: corrupt or truncated JPEG entropy-coded data")
        return end
    blocks = list(zip(slots.tolist(), bases.tolist()))
    if progressive:
        lookups = [_code_lookup(*pair[0 if ss == 0 else 1]) for pair in tables]
        c = coefs.tolist()
        try:
            for i, seg in enumerate(segments):
                _decode_progressive_segment(_windows(seg), blocks[i * step:(i + 1) * step],
                                            lookups, ss, se, ah, al, c)
        except (TypeError, IndexError, _OutOfRange) as e:
            raise ValueError(f"{name}: corrupt or truncated JPEG entropy-coded data") from e
        coefs[:] = c
        return end
    tables = [(_lookup(*dc, False), _lookup(*ac, True)) for dc, ac in tables]
    packed = []
    try:
        for i, seg in enumerate(segments):
            _decode_segment(_windows(seg), blocks[i * step:(i + 1) * step], tables, packed)
    except (TypeError, IndexError) as e:
        raise ValueError(f"{name}: corrupt or truncated JPEG entropy-coded data") from e
    packed = np.asarray(packed, np.int64)
    idx = (packed + (1 << 15)) >> 16
    coefs[idx - idx % 64 + ZIGZAG[idx % 64]] = packed - (idx << 16)
    return end


def _decode_lossless_scan(segments, bases, slots, step, tables, diffs, name, use_native):
    """The Huffman-coded differences of a lossless scan into `diffs` at each
    sample's flat offset (bases, in scan order), `tables` per slot its DC
    table's (counts, symbols)."""
    if use_native:
        err = native.jpeg_decode_lossless(segments, bases, slots, step, tables, diffs)
        if err:
            raise ValueError(f"{name}: corrupt or truncated JPEG entropy-coded data")
        return
    lookups = [_code_lookup(*t) for t in tables]
    samples = list(zip(slots.tolist(), bases.tolist()))
    out = diffs.tolist()
    try:
        for i, seg in enumerate(segments):
            _decode_lossless_segment(_windows(seg), samples[i * step:(i + 1) * step], lookups,
                                     out)
    except (TypeError, IndexError) as e:
        raise ValueError(f"{name}: corrupt or truncated JPEG entropy-coded data") from e
    diffs[:] = out


def _reconstruct_native(frame, comps, qt, coefs, adobe_transform, name,
                        lossless=False) -> np.ndarray:
    """_reconstruct in the host library."""
    h, w, hmax, vmax, _, _ = frame
    if not lossless:
        for c in comps:
            if c["tq"] not in qt:
                raise ValueError(f"{name}: JPEG component uses an undefined quantization table")
    comp = np.array([[c["offset"], c["bw"], c["bh"], c["w"], c["h_px"], hmax // c["h"],
                      vmax // c["v"], int(lossless)] for c in comps], np.int64)
    qts = np.zeros((len(comps), 64), np.int64) if lossless else np.stack(
        [qt[c["tq"]] for c in comps])
    return native.jpeg_reconstruct(coefs, comp, qts, h, w, _colour_mode(comps, adobe_transform))


def _colour_mode(comps, adobe_transform) -> int:
    """libjpeg's colour space for the components (jdapimin.c
    default_decompress_parms), as native.jpeg_reconstruct's mode: 0 gray,
    1 YCbCr, 2 RGB (an Adobe transform of 0, or components named R, G, B),
    3 CMYK (no Adobe marker, or transform 0), 4 YCCK (any other
    transform)."""
    if len(comps) == 1:
        return 0
    if len(comps) == 4:
        return 3 if adobe_transform in (None, 0) else 4
    ids = tuple(c["id"] for c in comps)
    return 2 if adobe_transform == 0 or ids == (ord("R"), ord("G"), ord("B")) else 1


def _reconstruct(frame, comps, qt, coefs, adobe_transform, name, lossless=False) -> np.ndarray:
    """The components' planes (a lossy file's dequantised IDCT, a lossless
    file's samples), upsampled (fancy; a lossless file's by replication, as
    libjpeg's upsampler without DCT scaling does), cropped and converted as
    _colour_mode says."""
    h, w, hmax, vmax, _, _ = frame
    planes = []
    for c in comps:
        ratio = (hmax // c["h"], vmax // c["v"])
        n = c["bw"] * c["bh"]
        if lossless:
            plane = coefs[c["offset"]:c["offset"] + n].reshape(c["bh"], c["bw"])[
                :c["h_px"], :c["w"]].astype(np.uint8)
            plane = np.repeat(np.repeat(plane, ratio[1], axis=0), ratio[0], axis=1)
            planes.append(plane[:h, :w])
            continue
        if c["tq"] not in qt:
            raise ValueError(f"{name}: JPEG component uses an undefined quantization table")
        blk = coefs[c["offset"]:c["offset"] + n * 64].reshape(n, 64) * qt[c["tq"]]
        px = idct_islow(blk.reshape(n, 8, 8))
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)[:c["h_px"], :c["w"]]
        if ratio == (2, 1):
            plane = upsample_h2v1(plane)
        elif ratio == (2, 2):
            plane = upsample_h2v2(plane)
        planes.append(plane[:h, :w])
    mode = _colour_mode(comps, adobe_transform)
    if mode == 0:
        return planes[0]
    if mode == 2:
        return np.stack(planes, axis=-1)
    if mode == 1:
        return ycc_to_rgb(*planes)
    # PIL reads libjpeg's CMYK inverted ("CMYK;I"); YCCK's C, M, Y are the
    # inverted R, G, B of its YCbCr (jdcolor.c ycck_cmyk_convert)
    cmy = ycc_to_rgb(*planes[:3]) if mode == 4 else 255 - np.stack(planes[:3], axis=-1)
    return np.concatenate([cmy, 255 - planes[3][..., None]], axis=-1).astype(np.uint8)


# ----------------------------------------------------------------- encoder

# the IJG standard quantization tables (natural order) and Huffman tables
# (JPEG Annex K; jcparam.c, jstdhuff.c)
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jpeg_set_quality(quality, force_baseline=TRUE): the IJG scaling of a
    standard table (jpeg_quality_scaling, jpeg_add_quant_table)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert on uint8 [H, W, 3] -> uint8 (Y, Cb, Cr)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + offset + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + offset + half - 1) >> 16
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c h2v2_downsample of an even-sized plane: each 2 x 2 sum
    plus a bias alternating 1, 2, 1, ... along the row, >> 2."""
    x = plane.astype(np.int32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return ((s + bias) >> 2).astype(np.uint8)


def _fdct_1d(d0, d1, d2, d3, d4, d5, d6, d7, even_shift, odd_shift):
    """The islow forward butterfly (jfdctint.c): outputs 0-7, the even
    outputs 0 and 4 shifted by `even_shift` (left when negative), the
    rotated ones descaled by `odd_shift`."""
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if even_shift < 0:
        o0, o4 = (tmp10 + tmp11) << -even_shift, (tmp10 - tmp11) << -even_shift
    else:
        o0, o4 = _descale(tmp10 + tmp11, even_shift), _descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * F0_541
    o2 = _descale(z1 + tmp13 * F0_765, odd_shift)
    o6 = _descale(z1 - tmp12 * F1_847, odd_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1_175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0_298, tmp5 * F2_053, tmp6 * F3_072, tmp7 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    o7 = _descale(tmp4 + z1 + z3, odd_shift)
    o5 = _descale(tmp5 + z2 + z4, odd_shift)
    o3 = _descale(tmp6 + z2 + z3, odd_shift)
    o1 = _descale(tmp7 + z1 + z4, odd_shift)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """uint8 samples [N, 8, 8] -> jpeg_fdct_islow's coefficients (scaled
    up by 8), rows then columns, after the -128 level shift."""
    x = blocks.astype(np.int64) - 128
    rows = np.stack(_fdct_1d(*(x[:, :, i] for i in range(8)), -_PASS1_BITS,
                             _CONST_BITS - _PASS1_BITS), axis=2)
    return np.stack(_fdct_1d(*(rows[:, i, :] for i in range(8)), _PASS1_BITS,
                             _CONST_BITS + _PASS1_BITS), axis=1)


def quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c quantize with compute_reciprocal's divisors (divisor 8 q,
    16-bit DCTELEMs): sign(x) (((|x| + c) fq) >> r), for coefficients
    [N, 8, 8] and a natural-order table of 64."""
    fq, c, r = np.zeros(64, np.int64), np.zeros(64, np.int64), np.zeros(64, np.int64)
    for i, q in enumerate(np.asarray(qtable).reshape(-1).tolist()):
        divisor = q << 3
        r[i] = 16 + divisor.bit_length() - 1
        fq[i], fr = divmod(1 << int(r[i]), divisor)
        c[i] = divisor // 2
        if fr == 0:
            fq[i] >>= 1
            r[i] -= 1
        elif fr <= divisor // 2:
            c[i] += 1
        else:
            fq[i] += 1
    x = coef.reshape(-1, 64)
    v = ((np.abs(x) + c) * fq) >> r
    return np.where(x < 0, -v, v).reshape(coef.shape)


@functools.lru_cache(maxsize=8)
def _code_table(counts: bytes, symbols: bytes):
    """symbol -> (code, length) arrays of 256 entries."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for ln, c, s in _canonical_codes(counts, symbols):
        code[s], size[s] = c, ln
    return code, size


def _magnitude(v: np.ndarray):
    """(size category, its value bits) of each coefficient or DC difference."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return size, (v - (v < 0)) & ((1 << size) - 1)


def _huffman_tokens(zz: np.ndarray, comp: np.ndarray, tables) -> Tuple[np.ndarray, np.ndarray]:
    """Quantized blocks in scan order [N, 64] (zigzag), each block's
    component slot [N] and each slot's (DC, AC) code tables -> the entropy
    coded stream as tokens (bits, length), each a Huffman code followed by
    its value bits, in stream order."""
    n = zz.shape[0]
    dc = zz[:, 0]
    diff = dc.copy()
    for slot in np.unique(comp):
        sel = np.flatnonzero(comp == slot)
        diff[sel] = np.diff(dc[sel], prepend=0)
    keys, syms, vbits, vsize, kind = [], [], [], [], []
    # DC: key block * 256
    size, bits = _magnitude(diff)
    keys.append(np.arange(n) * 256)
    syms.append(size)
    vbits.append(bits)
    vsize.append(size)
    kind.append(comp * 2)
    # AC: the non-zero coefficients, with their zero runs (ZRL per 16)
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    first = np.r_[True, blk[1:] != blk[:-1]]
    prev = np.where(first, 0, np.r_[0, pos[:-1]])
    run = pos - prev - 1
    val = zz[blk, pos]
    size, bits = _magnitude(val)
    keys.append(blk * 256 + 2 * pos)
    syms.append((run & 15) << 4 | size)
    vbits.append(bits)
    vsize.append(size)
    kind.append(comp[blk] * 2 + 1)
    nzrl = run >> 4
    zb = np.repeat(np.arange(len(blk)), nzrl)
    keys.append(blk[zb] * 256 + 2 * pos[zb] - 1)
    syms.append(np.full(len(zb), 0xF0))
    vbits.append(np.zeros(len(zb), np.int64))
    vsize.append(np.zeros(len(zb), np.int64))
    kind.append(comp[blk[zb]] * 2 + 1)
    # EOB where a block's last non-zero coefficient is before position 63
    last = np.zeros(n, np.int64)
    last[blk] = pos
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 256 + 255)
    syms.append(np.zeros(len(eob), np.int64))
    vbits.append(np.zeros(len(eob), np.int64))
    vsize.append(np.zeros(len(eob), np.int64))
    kind.append(comp[eob] * 2 + 1)
    key, sym, vb, vs, kd = (np.concatenate(a) for a in (keys, syms, vbits, vsize, kind))
    order = np.argsort(key, kind="stable")
    sym, vb, vs, kd = sym[order], vb[order], vs[order], kd[order]
    code = np.zeros(len(sym), np.int64)
    clen = np.zeros(len(sym), np.int64)
    for k, (c_tab, l_tab) in enumerate(t for pair in tables for t in pair):
        sel = kd == k
        code[sel], clen[sel] = c_tab[sym[sel]], l_tab[sym[sel]]
    if (clen == 0).any():
        raise ValueError("JPEG encode: a symbol has no Huffman code")
    return (code << vs) | vb, clen + vs


def _pack_bits(tokens: np.ndarray, lengths: np.ndarray) -> bytes:
    """Tokens of up to 32 bits, MSB first, into bytes; the last byte padded
    with 1 bits and every 0xFF byte followed by a stuffed 0x00."""
    end = np.cumsum(lengths)
    start = end - lengths
    nbytes = int(-(-end[-1] // 8)) if len(end) else 0
    byte = start >> 3
    # the token placed in a 40-bit field at its start bit; OR of disjoint
    # bit ranges is their sum, so each byte is a bincount of its parts
    field = tokens << (40 - (start & 7) - lengths)
    out = np.zeros(nbytes + 5, np.float64)
    for j in range(5):
        part = (field >> (32 - 8 * j)) & 0xFF
        out += np.bincount(byte + j, weights=part.astype(np.float64), minlength=nbytes + 5)
    buf = out[:nbytes].astype(np.uint8)
    pad = nbytes * 8 - int(end[-1]) if len(end) else 0
    if pad:
        buf[-1] |= (1 << pad) - 1
    ff = np.flatnonzero(buf == 0xFF)
    return np.insert(buf, ff + 1, 0).tobytes()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[8 by, 8 bx] -> [by, bx, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def encode(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [H, W, 3] RGB -> baseline JFIF bytes at 4:2:0 with the IJG
    tables scaled to `quality` and the standard Huffman tables, the
    coefficients libjpeg-turbo computes (cv2.imwrite's defaults: quality
    95, 4:2:0, no optimisation, no restart markers)."""
    native.count(native.plain_calls, "jpeg_encode")
    rgb = _check_rgb(rgb)
    h, w, _ = rgb.shape
    mcuy, mcux = -(-h // 16), -(-w // 16)
    # edge replication to whole MCUs: the padding libjpeg's expand_right_edge
    # and expand_bottom_edge give every block inside the image
    rgb = np.pad(rgb, ((0, mcuy * 16 - h), (0, mcux * 16 - w), (0, 0)), mode="edge")
    y, cb, cr = rgb_to_ycc(rgb)
    qy, qc = quant_table(STD_LUMA_Q, quality), quant_table(STD_CHROMA_Q, quality)
    yq = quantize(fdct_islow(_blocks(y).reshape(-1, 8, 8)), qy).reshape(mcuy, 2, mcux, 2, 64)
    cq = [quantize(fdct_islow(_blocks(downsample_h2v2(p)).reshape(-1, 8, 8)), qc)
          .reshape(mcuy, mcux, 64) for p in (cb, cr)]
    # scan order: per MCU the four Y blocks in raster order, then Cb, Cr
    zz = np.concatenate([yq.transpose(0, 2, 1, 3, 4).reshape(mcuy, mcux, 4, 64),
                         cq[0][:, :, None], cq[1][:, :, None]], axis=2).reshape(-1, 64)
    zz = zz[:, ZIGZAG]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcuy * mcux)
    luma = (_code_table(*_DC_LUMA), _code_table(*_AC_LUMA))
    chroma = (_code_table(*_DC_CHROMA), _code_table(*_AC_CHROMA))
    tokens, lengths = _huffman_tokens(zz, comp, (luma, chroma, chroma))
    return _jfif(h, w, qy, qc, _pack_bits(tokens, lengths))


def encode_native(rgb: np.ndarray, quality: int = 95) -> bytes:
    """`encode` with the colour conversion, downsampling, DCT, quantisation
    and Huffman coding in the host library: the same bytes."""
    rgb = _check_rgb(rgb)
    qy, qc = quant_table(STD_LUMA_Q, quality), quant_table(STD_CHROMA_Q, quality)
    tables = [_code_table(*t) for t in (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA)]
    scan = native.jpeg_encode_entropy(rgb, qy, qc, np.stack([c for c, _ in tables]),
                                      np.stack([s for _, s in tables]))
    return _jfif(rgb.shape[0], rgb.shape[1], qy, qc, scan)


def _check_rgb(rgb) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"encode takes uint8 [H, W, 3] RGB, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    if h > 65535 or w > 65535:
        raise ValueError(f"JPEG is at most 65535 x 65535, got {w} x {h}")
    return rgb


def _jfif(h: int, w: int, qy: np.ndarray, qc: np.ndarray, scan: bytes) -> bytes:
    """The JFIF file around an entropy-coded 4:2:0 scan: the tables, frame
    and scan headers encode writes."""

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    dqt = b"".join(bytes([t]) + q[ZIGZAG].astype(np.uint8).tobytes()
                   for t, q in enumerate((qy, qc)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([cls << 4 | th]) + counts + symbols for cls, th, (counts, symbols) in (
        (0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return b"".join([b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
                     segment(0xDB, dqt), segment(0xC0, sof), segment(0xC4, dht),
                     segment(0xDA, sos), scan, b"\xff\xd9"])


def write_jpeg(filename, rgb: np.ndarray, quality: int = 95) -> None:
    """uint8 [H, W, 3] RGB -> a baseline JPEG file (`encode`'s bytes, through
    encode_native)."""
    Path(filename).write_bytes(encode_native(rgb, quality))
