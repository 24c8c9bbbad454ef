"""OpenCV's image operations that the data pipeline uses, in numpy: the
area, nearest and linear resizes of `cv2.resize` and the 8-bit RGB <-> HSV
conversions of `cv2.cvtColor` (the machine the port trains on has no
OpenCV). Each follows OpenCV's arithmetic step for step in the same
precision, so it gives OpenCV's values, not just close ones.
"""
from __future__ import annotations

import math

import numpy as np


def _area_table(ssize: int, dsize: int):
    """OpenCV's computeResizeAreaTab for one axis, shrinking by
    scale = ssize / dsize: per destination index, the source indices and
    their float32 weights in OpenCV's order, zero-padded to a rectangle
    ([dsize, k] each)."""
    scale = 1.0 / (dsize / ssize)
    entries = [[] for _ in range(dsize)]
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            entries[dx].append((sx1 - 1, (sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            entries[dx].append((sx, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            entries[dx].append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    k = max(len(e) for e in entries)
    index = np.zeros((dsize, k), np.int64)
    weight = np.zeros((dsize, k), np.float32)
    for dx, e in enumerate(entries):
        for j, (sx, a) in enumerate(e):
            index[dx, j], weight[dx, j] = sx, np.float32(a)
    return index, weight


def _area_fast(img: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """OpenCV's resizeAreaFast_ for an integer shrink (fy, fx): each output
    is the float32 sum of its cell's pixels, row-major, in groups of four
    (sum += a + b + c + d), times 1 / (fy * fx). For a 2x2 shrink of 1 or 4
    channels OpenCV's 4-lane vector loop adds each row's pair first, (a + b)
    + (c + d), on all but the last (row length mod 4) values of a row."""
    h, w = img.shape[0] // fy, img.shape[1] // fx
    cells = [img[i:h * fy:fy, j:w * fx:fx] for i in range(fy) for j in range(fx)]
    vector = None
    if (fy, fx) == (2, 2) and (img.ndim == 2 or img.shape[2] in (1, 4)):
        vector = ((cells[0] + cells[1]) + (cells[2] + cells[3])) * np.float32(0.25)
    total = np.zeros_like(cells[0])
    k = 0
    while k + 4 <= len(cells):
        total = total + (((cells[k] + cells[k + 1]) + cells[k + 2]) + cells[k + 3])
        k += 4
    for c in cells[k:]:
        total = total + c
    out = total * np.float32(1.0 / (fy * fx))
    if vector is not None:
        flat, vflat = out.reshape(h, -1), vector.reshape(h, -1)
        n = flat.shape[1] // 4 * 4
        flat[:, :n] = vflat[:, :n]
    return out


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA) for a
    float32 or uint8 [H, W] or [H, W, C] image shrunk in both axes: every
    output pixel is the fractional-coverage mean of its source cell,
    accumulated as OpenCV does (each source row across its x-cell, then
    those rows down the y-cell, in float32). A uint8 image gives uint8, as
    OpenCV's: an integer shrink sums each cell exactly and rounds half up
    ((sum + n/2) / n), any other shrink rounds the float32 mean to nearest,
    ties to even."""
    u8 = np.asarray(img).dtype == np.uint8
    img = np.asarray(img) if u8 else np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    if (height, width) == (sh, sw):
        return img.copy()
    if height > sh or width > sw:
        raise ValueError(f"resize_area shrinks only: {(sh, sw)} -> {(height, width)}")
    scale_y, scale_x = 1.0 / (height / sh), 1.0 / (width / sw)
    iy, ix = round(scale_y), round(scale_x)
    fast = (abs(scale_y - iy) < 2.220446049250313e-16
            and abs(scale_x - ix) < 2.220446049250313e-16)
    if u8:
        if fast:
            cells = img[:height * iy, :width * ix].reshape(
                (height, iy, width, ix) + img.shape[2:]).astype(np.int32).sum(axis=(1, 3))
            return ((cells + iy * ix // 2) // (iy * ix)).astype(np.uint8)
        out = resize_area(img.astype(np.float32), height, width)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    if fast:
        return _area_fast(img, iy, ix)
    xi, xw = _area_table(sw, width)
    yi, yw = _area_table(sh, height)
    wshape = (-1,) + (1,) * (img.ndim - 2)
    rows = np.zeros((sh, width) + img.shape[2:], np.float32)
    for j in range(xi.shape[1]):
        rows = rows + img[:, xi[:, j]] * xw[:, j].reshape(wshape)
    out = np.zeros((height, width) + img.shape[2:], np.float32)
    wshape = (-1, 1) + (1,) * (img.ndim - 2)
    for j in range(yi.shape[1]):
        out = out + rows[yi[:, j]] * yw[:, j].reshape(wshape)
    return out


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST):
    source index floor(dst * (src / dst)), the ratio taken as OpenCV takes
    it (1 / (dst / src) in double), clamped to the last pixel. Not rounding."""
    img = np.asarray(img)
    sh, sw = img.shape[:2]
    fy, fx = 1.0 / (height / sh), 1.0 / (width / sw)
    ys = np.minimum(np.floor(np.arange(height) * fy).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(width) * fx).astype(np.int64), sw - 1)
    return img[ys][:, xs]


def _linear_taps(ssize: int, dsize: int):
    """OpenCV's INTER_LINEAR taps for one axis: per destination index the
    two source indices and their weights: f = (d + 0.5) *
    (ssize / dsize) - 0.5, its floor and its fraction in double, the
    fraction then rounded to float32; clamped at both borders to the edge
    sample with weight 0."""
    scale = 1.0 / (dsize / ssize)
    f = (np.arange(dsize) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float32)
    low, high = s < 0, s >= ssize - 1
    frac = np.where(low | high, np.float32(0), frac).astype(np.float32)
    s = np.where(low, 0, np.where(high, ssize - 1, s))
    return s, np.minimum(s + 1, ssize - 1), np.float32(1) - frac, frac


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """a + (b - a) t in float32 with one rounding of the product and sum,
    as OpenCV's vector loops compute each linear tap pair (a fused
    multiply-add; here the product and sum exact in float64, then rounded)."""
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR) for a
    float32 [H, W] or [H, W, C] image: a horizontal pass, then a vertical
    one, each tap pair `_lerp`ed with `_linear_taps`' weights. The same
    size gives a copy."""
    img = np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    if (height, width) == (sh, sw):
        return img.copy()
    tail = (1,) * (img.ndim - 2)
    x0, x1, _, ax = _linear_taps(sw, width)
    rows = _lerp(img[:, x0], img[:, x1], ax.reshape((-1,) + tail))
    y0, y1, _, ay = _linear_taps(sh, height)
    return _lerp(rows[y0], rows[y1], ay.reshape((-1, 1) + tail))


_HSV_SHIFT = 12


def _cv_round(x: np.ndarray) -> np.ndarray:
    return np.rint(x).astype(np.int64)  # saturate_cast<int>(double): round half to even


_DIV = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], _cv_round((255 << _HSV_SHIFT) / _DIV)])
_HDIV180 = np.concatenate([[0], _cv_round((180 << _HSV_SHIFT) / (6.0 * _DIV))])


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV) for uint8 [..., 3]: H in [0, 180),
    S and V in [0, 255], OpenCV's fixed-point arithmetic (12-bit tables)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    vr, vg = v == r, v == g
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(vr, g - b, np.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([np.clip(h, 0, 255), s, v], axis=-1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) for uint8 [H, W, 3] (or [W, 3])
    with H in [0, 180): OpenCV's float32 sector formula. OpenCV's x86 build
    contracts 1 - s*h into one fused multiply-add, rounded once to float32
    (here: the product and sum exact in float64, then that one rounding),
    and converts to 8 bits in two ways: its vector loop, which takes each
    row's pixels in blocks of 32, truncates, and the scalar loop for the
    rest of the row rounds half to even. Both are followed here, so every
    (H < 180, S, V) and row position gives OpenCV's value (a crop width
    that is a multiple of 32 is all vector loop)."""
    f32, f64 = np.float32, np.float64
    h = hsv[..., 0].astype(f32) * (f32(6.0) / f32(180.0))
    s = hsv[..., 1].astype(f32) * (f32(1.0) / f32(255.0))
    v = hsv[..., 2].astype(f32) * (f32(1.0) / f32(255.0))
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    one = f32(1.0)

    def one_minus(a, b):  # fma(-a, b, 1) in float32
        return (f64(1.0) - a.astype(f64) * b.astype(f64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * one_minus(s, h), v * one_minus(s, one - h)], axis=-1)
    # OpenCV's table gives (b, g, r); the output is RGB
    b, g, r = (np.take_along_axis(tab, _SECTORS[sector][..., i:i + 1], axis=-1)[..., 0]
               for i in range(3))
    rgb = np.stack([r, g, b], axis=-1) * f32(255.0)
    w = rgb.shape[-2]
    vector = (np.arange(w) < w // 32 * 32)[:, None]
    return np.clip(np.where(vector, np.trunc(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)
