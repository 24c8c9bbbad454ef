"""Netpbm images (PBM, PGM, PPM: P1-P6, plain and raw; PAM, P7; the gray
PFM) read as PIL's `Image.open(f).convert("RGB")` and as OpenCV's
`imread` give them, which differ:

- PIL scales every sample to its mode's range: 8-bit gray or RGB,
  round(v / maxval * 255) rounded half to even (Python's round) where
  maxval is not 255; 16-bit gray (maxval > 255) to mode I,
  round(v / maxval * 65535), which convert("RGB") saturates at 255 (raw
  gray at maxval 65535 is read as it is). Raw samples above maxval are
  clamped to the mode's top; plain ones raise. PBM's 1 is black. PAM and
  the colour PFM it refuses; the gray PFM (mode F) converts by truncation,
  clamped to 0-255.
- OpenCV scales only plain samples of 8-bit files, v * 255 / maxval in
  integers, after clamping them to maxval; raw 8-bit samples are taken as
  they are, 16-bit samples (plain or raw) shifted down 8 bits. It reads a
  PAM's GRAYSCALE or RGB tuples (the three in the file's order as its
  BGR, so swapped against PIL's RGB) and the colour PFM (rounded to
  nearest even, saturated); it refuses the gray PFM. PAM's other tuples
  (GRAYSCALE_ALPHA, RGB_ALPHA, BLACKANDWHITE), which OpenCV 5.0 misreads,
  the port refuses.

Every path is numpy over the whole image; a file too short for its
samples raises ValueError.
"""
from __future__ import annotations

import re

import numpy as np

from .native import check_pixels

_WS = b" \t\n\r\x0b\x0c"


def _tokens(data: bytes, pos: int, n: int, name):
    """The next n header tokens from pos (whitespace and '#' comments
    skipped) and the position after the last token's terminating
    whitespace byte."""
    out = []
    while len(out) < n:
        while pos < len(data) and (data[pos] in _WS or data[pos] == 0x23):
            if data[pos] == 0x23:
                end = data.find(b"\n", pos)
                pos = len(data) if end < 0 else end
            pos += 1
        start = pos
        while pos < len(data) and data[pos] not in _WS and data[pos] != 0x23:
            pos += 1
        tok = data[start:pos]
        if not tok.isdigit():
            raise ValueError(f"{name}: malformed Netpbm header")
        out.append(int(tok))
    return out, pos + 1


def _plain_values(text: bytes, count: int, name, bits: bool = False) -> np.ndarray:
    """count whitespace-separated decimal samples (or, for P1, single
    digits, whitespace optional) after removing '#' comments."""
    text = re.sub(rb"#[^\n\r]*", b" ", text)
    if bits:
        digits = np.frombuffer(re.sub(rb"[ \t\n\r\x0b\x0c]", b"", text), np.uint8)
        vals = digits[:count].astype(np.int64) - 48
        if len(vals) < count or ((vals != 0) & (vals != 1)).any():
            raise ValueError(f"{name}: truncated or malformed plain PBM data")
        return vals
    toks = text.split()
    if len(toks) < count:
        raise ValueError(f"{name}: truncated plain Netpbm data ({len(toks)} of {count} samples)")
    try:
        return np.array(toks[:count], np.int64)
    except ValueError as err:
        raise ValueError(f"{name}: malformed plain Netpbm data") from err


def _raw_values(data: bytes, pos: int, count: int, maxval: int, name) -> np.ndarray:
    size = 2 if maxval > 255 else 1
    if len(data) - pos < count * size:
        raise ValueError(f"{name}: truncated Netpbm data")
    return np.frombuffer(data, ">u2" if size == 2 else np.uint8, count, pos).astype(np.int64)


def _scale_pil(v: np.ndarray, maxval: int, top: int) -> np.ndarray:
    """PIL's PpmDecoder: min(top, round(v / maxval * top)), Python's
    round (half to even) on the float64 quotient."""
    return np.minimum(top, np.round(v / maxval * top)).astype(np.int64)


def decode(data: bytes, name, cv2_rules: bool) -> np.ndarray:
    """A Netpbm file -> uint8 [H, W, 3] RGB by PIL's rules or OpenCV's."""
    magic = data[:2]
    if magic == b"P7":
        return _pam(data, name, cv2_rules)
    if magic in (b"PF", b"Pf"):
        return _pfm(data, name, cv2_rules)
    kind = magic[1] - 48
    bitmap = kind in (1, 4)
    (w, h, *mv), pos = _tokens(data, 2, 2 if bitmap else 3, name)
    maxval = 1 if bitmap else mv[0]
    if w == 0 or h == 0 or not 0 < maxval < 65536:
        raise ValueError(f"{name}: Netpbm P{kind} of {w} x {h} with maxval {maxval}")
    check_pixels(w, h, name)
    ch = 3 if kind in (3, 6) else 1
    count = w * h * ch
    if kind == 4:
        stride = (w + 7) // 8
        if len(data) - pos < stride * h:
            raise ValueError(f"{name}: truncated PBM data")
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
        v = np.unpackbits(rows, axis=1)[:, :w].astype(np.int64)
    elif kind in (1, 2, 3):
        v = _plain_values(data[pos - 1:], count, name, bits=kind == 1)
        if not cv2_rules and v.max(initial=0) > maxval:
            raise ValueError(f"{name}: Netpbm sample above maxval {maxval}")
    else:
        v = _raw_values(data, pos, count, maxval, name)
    if bitmap:
        g = np.where(v != 0, 0, 255)
    elif cv2_rules:
        if maxval > 255:
            g = np.minimum(v, maxval) >> 8 if kind in (2, 3) else v >> 8
        elif kind in (2, 3):
            g = np.minimum(v, maxval) * 255 // maxval
        else:
            g = v
    elif kind in (2, 5) and maxval > 255:
        g = np.minimum(v if kind == 5 and maxval == 65535 else _scale_pil(v, maxval, 65535), 255)
    else:
        g = v if maxval == 255 else _scale_pil(v, maxval, 255)
    g = g.astype(np.uint8).reshape(h, w, -1)
    return np.ascontiguousarray(np.repeat(g, 3, axis=2) if g.shape[2] == 1 else g)


def _pam(data: bytes, name, cv2_rules: bool) -> np.ndarray:
    if not cv2_rules:
        raise ValueError(f"{name}: PNM of the PAM kind (P7), which PIL does not read")
    end = data.find(b"ENDHDR\n")
    if end < 0:
        raise ValueError(f"{name}: PAM without ENDHDR")
    fields = {}
    for line in data[3:end].splitlines():
        parts = line.split(None, 1)
        if parts and not parts[0].startswith(b"#"):
            fields[parts[0].decode("latin-1")] = parts[1].strip() if len(parts) > 1 else b""
    try:
        w, h, depth, maxval = (int(fields[k]) for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"))
    except (KeyError, ValueError) as err:
        raise ValueError(f"{name}: PAM header without WIDTH, HEIGHT, DEPTH or MAXVAL") from err
    tupl = fields.get("TUPLTYPE", b"").decode("latin-1")
    if (tupl, depth) not in (("GRAYSCALE", 1), ("RGB", 3)):
        raise ValueError(f"{name}: PNM of the PAM kind, {tupl or 'without TUPLTYPE'} of depth "
                         f"{depth}, which OpenCV misreads and the port does not read (GRAYSCALE "
                         "or RGB)")
    if w <= 0 or h <= 0 or not 0 < maxval < 65536:
        raise ValueError(f"{name}: PAM of {w} x {h} with maxval {maxval}")
    check_pixels(w, h, name)
    v = _raw_values(data, end + 7, w * h * depth, maxval, name).reshape(h, w, depth)
    g = (v >> 8 if maxval > 255 else v).astype(np.uint8)
    return np.ascontiguousarray(g[..., ::-1] if depth == 3 else np.repeat(g, 3, axis=2))


def _pfm(data: bytes, name, cv2_rules: bool) -> np.ndarray:
    colour = data[:2] == b"PF"
    if colour != cv2_rules:
        raise ValueError(f"{name}: {'colour' if colour else 'gray'} PFM, which "
                         f"{'OpenCV' if cv2_rules else 'PIL'} does not read")
    lines = data.split(b"\n", 3)
    try:
        w, h = map(int, lines[1].split())
        scale = float(lines[2])
    except (IndexError, ValueError) as err:
        raise ValueError(f"{name}: malformed PFM header") from err
    check_pixels(w, h, name)
    ch = 3 if colour else 1
    body = lines[3] if len(lines) > 3 else b""
    if len(body) < w * h * ch * 4:
        raise ValueError(f"{name}: truncated PFM data")
    f = np.frombuffer(body, "<f4" if scale < 0 else ">f4", w * h * ch).reshape(h, w, ch)[::-1]
    if colour:
        g = np.clip(np.rint(f), 0, 255)
    else:
        g = np.where(f <= 0, 0, np.where(f >= 255, 255, np.trunc(np.nan_to_num(f))))
    g = g.astype(np.uint8)
    return np.ascontiguousarray(g if colour else np.repeat(g, 3, axis=2))
