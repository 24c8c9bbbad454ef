"""OpenCV's image operations that the data pipeline uses, in numpy: the
area, nearest and linear resizes of `cv2.resize` and the 8-bit RGB <-> HSV
conversions of `cv2.cvtColor` (the machine the port trains on has no
OpenCV), and two primitives ORB runs (RGB -> gray and the uint8
INTER_LINEAR_EXACT resize) with its Gaussian kernel. Each follows
OpenCV's arithmetic step for step in the same precision, so it gives
OpenCV's values, not just close ones.

These are the plain versions of the host library's resample.cpp and
orb.cpp (data/native.py: resize_area, resize_nearest, resize_linear,
hue_shift, rgb_to_gray, resize_linear_exact), which the data
paths call; each public function here counts its calls in
native.plain_calls.
"""
from __future__ import annotations

import math

import numpy as np

from . import native


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


def _area_linear_taps(ssize: int, dsize: int):
    """OpenCV's INTER_AREA taps on its linear path (taken when either axis
    enlarges), for one axis: per destination index d the source indices s
    and s + 1 and the float32 weight f of the second, s = floor(d * scale)
    and f = (d + 1) - (s + 1) / scale in double, then float32, 0 where it is
    not positive and else its fraction; from the last source sample on, s
    is that sample and f is 0."""
    scale = 1.0 / (dsize / ssize)
    d = np.arange(dsize)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * (dsize / ssize)).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    edge = s >= ssize - 1
    s = np.where(edge, ssize - 1, s)
    f = np.where(edge, np.float32(0), f).astype(np.float32)
    return s, np.minimum(s + 1, ssize - 1), f


def _resize_area_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """INTER_AREA when an axis enlarges: OpenCV's linear resize with
    `_area_linear_taps`' weights. float32 lerps each tap pair as
    resize_linear does. uint8 takes the weights in fixed point (scale 2048,
    rounded half to even), sums each row's tap pair exactly in int32, and
    combines two rows as OpenCV's vector loop does, on every value of the
    row: ((S0 >> 4) b0 >> 16) + ((S1 >> 4) b1 >> 16), then (+ 2) >> 2."""
    sh, sw = img.shape[:2]
    x0, x1, fx = _area_linear_taps(sw, width)
    y0, y1, fy = _area_linear_taps(sh, height)
    tail = (1,) * (img.ndim - 2)
    if img.dtype != np.uint8:
        rows = _lerp(img[:, x0], img[:, x1], fx.reshape((-1,) + tail))
        return _lerp(rows[y0], rows[y1], fy.reshape((-1, 1) + tail))

    def fixed(f):
        return (np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64),
                np.rint(f * np.float32(2048)).astype(np.int64))

    ax0, ax1 = fixed(fx)
    by0, by1 = fixed(fy)
    src = img.astype(np.int64)
    rows = src[:, x0] * ax0.reshape((-1,) + tail) + src[:, x1] * ax1.reshape((-1,) + tail)
    s0 = rows[y0].reshape(height, -1)
    s1 = rows[y1].reshape(height, -1)
    b0, b1 = by0[:, None], by1[:, None]
    out = (((s0 >> 4) * b0 >> 16) + ((s1 >> 4) * b1 >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((height, width) + img.shape[2:])


def _area_factors(sh: int, sw: int, height: int, width: int):
    """OpenCV's choice of the integer area path for a shrink of (sh, sw) to
    (height, width): the integer factors (fy, fx) when both scales are
    within machine epsilon of integers, else (0, 0)."""
    scale_y, scale_x = 1.0 / (height / sh), 1.0 / (width / sw)
    iy, ix = round(scale_y), round(scale_x)
    if (abs(scale_y - iy) < 2.220446049250313e-16
            and abs(scale_x - ix) < 2.220446049250313e-16):
        return iy, ix
    return 0, 0


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA) for a
    float32 or uint8 [H, W] or [H, W, C] image. Shrunk in both axes, every
    output pixel is the fractional-coverage mean of its source cell,
    accumulated as OpenCV does (each source row across its x-cell, then
    those rows down the y-cell, in float32). A uint8 image gives uint8, as
    OpenCV's: an integer shrink sums each cell exactly, then a 2 x 2 one of
    1, 3 or 4 channels rounds half up ((sum + 2) >> 2, OpenCV's vector
    loop) and any other takes float32(sum) * float32(1 / n) to nearest,
    ties to even; a fractional shrink rounds the float32 mean the same way.
    Enlarged in either axis, OpenCV takes its linear path with area weights
    (`_resize_area_linear`)."""
    native.count(native.plain_calls, "resize_area")
    return _resize_area(img, height, width)


def _resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    u8 = np.asarray(img).dtype == np.uint8
    img = np.asarray(img) if u8 else np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    if (height, width) == (sh, sw):
        return img.copy()
    if height > sh or width > sw:
        return _resize_area_linear(img, height, width)
    iy, ix = _area_factors(sh, sw, height, width)
    fast = iy > 0
    if u8:
        if fast:
            cells = img[:height * iy, :width * ix].reshape(
                (height, iy, width, ix) + img.shape[2:]).astype(np.int32).sum(axis=(1, 3))
            if (iy, ix) == (2, 2) and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
                return ((cells + 2) >> 2).astype(np.uint8)
            mean = cells.astype(np.float32) * (np.float32(1) / np.float32(iy * ix))
            return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
        out = _resize_area(img.astype(np.float32), height, width)
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
    native.count(native.plain_calls, "resize_nearest")
    img = np.asarray(img)
    sh, sw = img.shape[:2]
    fy, fx = 1.0 / (height / sh), 1.0 / (width / sw)
    ys = np.minimum(np.floor(np.arange(height) * fy).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(width) * fx).astype(np.int64), sw - 1)
    return img[ys][:, xs]


def _linear_taps(ssize: int, dsize: int):
    """OpenCV's INTER_LINEAR taps for one axis (its IPP path, which cv2 takes
    for float32): per destination index the two source indices and their
    weights: f = (d + 0.5) * (ssize / dsize) - 0.5, its floor and its
    fraction in double, the fraction then rounded to float32; clamped at
    both borders to the edge sample with weight 0. The ratio is one
    division, as IPP takes it: OpenCV's own loops take 1 / (dsize / ssize),
    which differs where f falls within a rounding of an integer."""
    scale = ssize / dsize
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


def _lerp_twice(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """a + (b - a) t in float32 with the product and the sum each rounded."""
    return ((b - a) * t).astype(np.float32) + a


def _edge_runs(sw: int, dw: int, channels: int) -> np.ndarray:
    """The float elements of a resized row ([dw * max(channels, 1)] bool)
    whose vertical tap pair cv2's IPP path rounds twice (`_lerp_twice`)
    instead of once: only in the columns clamped to the first or last
    source sample, which arise when the width grows 8x or more. Each of the
    two clamped regions, n pixels from its first one, is taken as blocks of
    16 pixels and a remainder of n mod 16: the blocks are rounded twice at 4
    channels, the remainder when it is 5 pixels or more, at 4 channels in
    every channel and at 3 channels in channels 0 and 1. Everything else
    (1 channel, a remainder under 5, the interior) is rounded once. Found by
    probing cv2 5.0 (IPP 2026.0) at 1, 3 and 4 channels over width ratios
    8x-100x; no data path resizes 2 channels."""
    c = max(channels, 1)
    f = (np.arange(dw) + 0.5) * (sw / dw) - 0.5
    twice = np.zeros((dw, c), bool)
    right = int((f >= sw - 1).sum())
    for start, n in ((0, int((f < 0).sum())), (dw - right, right)):
        blocks, rest = divmod(n, 16)
        tail = start + 16 * blocks
        if c == 4:
            twice[start:tail] = True
        if rest >= 5 and c in (3, 4):
            twice[tail:start + n, :2 if c == 3 else 4] = True
    return twice.reshape(-1)


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR) for a
    float32 [H, W] or [H, W, C] image: a horizontal pass, then a vertical
    one, each tap pair `_lerp`ed with `_linear_taps`' weights, but the
    vertical pair rounded twice in the clamped edge columns `_edge_runs`
    names, as IPP's border loop rounds it. The same size gives a copy."""
    native.count(native.plain_calls, "resize_linear")
    img = np.asarray(img, np.float32)
    sh, sw = img.shape[:2]
    if (height, width) == (sh, sw):
        return img.copy()
    tail = (1,) * (img.ndim - 2)
    x0, x1, _, ax = _linear_taps(sw, width)
    rows = _lerp(img[:, x0], img[:, x1], ax.reshape((-1,) + tail))
    y0, y1, _, ay = _linear_taps(sh, height)
    a, b, t = rows[y0], rows[y1], ay.reshape((-1, 1) + tail)
    twice = _edge_runs(sw, width, img.shape[2] if img.ndim == 3 else 0).reshape(
        (1, width) + img.shape[2:])
    return np.where(twice, _lerp_twice(a, b, t), _lerp(a, b, t))


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


def hue_shift(img: np.ndarray, shift: int) -> np.ndarray:
    """The colour jitter's hue step (the JAX package's transforms._adjust_hue
    with cv2): float32 [H, W, 3] RGB in [0, 1] times 255 truncated to
    uint8, to 8-bit HSV, the hue turned by `shift` of its 180 steps, back
    to RGB, / 255 as float32."""
    native.count(native.plain_calls, "hue_shift")
    hsv = rgb_to_hsv_u8((np.asarray(img, np.float32) * 255).astype(np.uint8))
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift)) % 180
    return hsv_to_rgb_u8(hsv).astype(np.float32) / 255.0


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) for uint8 [..., 3]: OpenCV's
    15-bit fixed point, (9798 R + 19235 G + 3735 B + 2^14) >> 15."""
    native.count(native.plain_calls, "rgb_to_gray")
    x = np.asarray(img).astype(np.int64)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


def _exact_taps(ssize: int, dsize: int):
    """One axis of OpenCV's INTER_LINEAR_EXACT: per destination index the
    first source index and the 8-bit fixed-point weight of the second,
    position (d + 0.5) / (dsize / ssize) - 0.5 in double, weight 0 where it
    is clamped to an edge sample (round half to even, as cvRound)."""
    scale = 1.0 / (dsize / ssize)
    f = scale * (np.arange(dsize) + 0.5) - 0.5
    i = np.floor(f).astype(np.int64)
    inside = (i >= 0) & (i < ssize - 1) & (ssize > 1)
    m1 = np.where(inside, np.rint((f - i) * 256.0), 0).astype(np.int64)
    ofs = np.where(inside, i, np.where((i >= 0) & (ssize > 1), ssize - 1, 0))
    return ofs, np.minimum(ofs + 1, ssize - 1), m1


def resize_linear_exact(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR_EXACT)
    for uint8 [H, W] or [H, W, C]: the horizontal pass exact in integers
    (weights of 8 bits), the vertical one rounded once, (sum + 2^15) >> 16.
    When both sides halve exactly (and C is not 2) OpenCV takes INTER_AREA's
    exact path, (a + b + c + d + 2) >> 2; the same size is a copy."""
    native.count(native.plain_calls, "resize_linear_exact")
    x = np.asarray(img)
    sh, sw = x.shape[:2]
    if (height, width) == (sh, sw):
        return x.copy()
    xi = x.astype(np.int64)
    if (sh, sw) == (2 * height, 2 * width) and (x.ndim == 2 or x.shape[2] != 2):
        s = xi[0::2, 0::2] + xi[0::2, 1::2] + xi[1::2, 0::2] + xi[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    tail = (1,) * (x.ndim - 2)
    x0, x1, mx = _exact_taps(sw, width)
    mx = mx.reshape((-1,) + tail)
    rows = xi[:, x0] * (256 - mx) + xi[:, x1] * mx
    y0, y1, my = _exact_taps(sh, height)
    my = my.reshape((-1, 1) + tail)
    return ((rows[y0] * (256 - my) + rows[y1] * my + 32768) >> 16).astype(np.uint8)


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(n, sigma, ktype=cv2.CV_32F) for sigma > 0:
    exp(-x^2 / (2 sigma^2)) normalised in double, then float32."""
    x = np.arange(n) - (n - 1) / 2
    e = np.exp(-(x * x) / (2 * sigma * sigma))
    return (e / e.sum()).astype(np.float32)
