"""The port's host library (csrc/host/*.cpp) and its ctypes bindings: the
data pipeline's fused float passes (fastio: the counterpart of
mvsformerplusplus_tpu/data/native.py, under the same names), the JPEG
decoder's entropy decoding (baseline and progressive) and reconstruction,
the JPEG encoder's per-pixel and per-symbol work, the PNG row unfilter, the
TIFF LZW and PackBits and BMP RLE decoders (formats.cpp), OpenCV's share of
the data path (resample.cpp: the area, nearest and linear resizes and the
8-bit hue shift, each equal bit for bit to its numpy version in
data/image.py), and OpenCV's ORB and Hamming kNN matcher with the
primitives they run (orb.cpp: RGB -> gray, INTER_LINEAR_EXACT and the
Gaussian blur, the first two also in data/image.py).

The sources compile with the system C++ compiler ($CXX, else g++) into one
shared library under <repo>/build/host/, named by a hash of the sources and
flags, at the first call that needs it (nothing is built at import). The
flags leave out -march=native and fast-math, and turn off floating-point
contraction, so the float passes round as the JAX package's library and
numpy do. Unlike the JAX module there is no fallback: a missing compiler or
a failed build raises RuntimeError with the compiler's log. ctypes releases
the interpreter lock during each call, so loader threads decode in
parallel.

`calls` counts the calls of each entry point, each where it enters the
library; `plain_calls` counts the calls of the numpy codec (jpeg.decode,
jpeg.encode, io._unfilter) and of data/image.py's resizes, hue shift and
gray conversion, the plain versions the tests hold the library to, and under
"resize_area_enlarge" the area enlargements resize_area leaves to numpy
(only the DINOv2 matcher enlarges). No data path calls a plain version.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]

calls: Dict[str, int] = {k: 0 for k in (
    "crop_normalize", "u8_to_f32", "stage_pyramid", "jpeg_decode_scan", "jpeg_reconstruct",
    "jpeg_encode", "png_unfilter", "jpeg_decode_progressive", "resize_area", "resize_nearest",
    "resize_linear", "hue_shift", "rgb_to_gray", "resize_linear_exact", "blur", "fast9", "orb",
    "hamming_knn2", "bmp_rle", "tiff_lzw", "tiff_packbits")}
plain_calls: Dict[str, int] = {k: 0 for k in (
    "jpeg_decode", "jpeg_encode", "png_unfilter", "resize_area", "resize_nearest", "resize_linear",
    "hue_shift", "resize_area_enlarge", "rgb_to_gray", "resize_linear_exact")}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i, _i64 = ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "crop_normalize_f32": (None, [_f32p, _i, _i, _i, _i, _i, _i, ctypes.c_float, _f32p]),
    "u8_to_f32": (None, [_u8p, _i64, _f32p]),
    "stage_pyramid_f32": (None, [_f32p, _i, _i, _f32p, _f32p, _f32p, _f32p]),
    "batch_crop_normalize_f32": (None, [_f32p, _i, _i, _i, _i32p, _i32p, _i, _i, ctypes.c_float,
                                        _f32p, _i]),
    "jpeg_decode_scan": (_i, [_u8p, _i64p, _i64p, _i64, _i64p, _i32p, _i64, _i64, _i, _u8p, _u8p,
                              _i32p, _i64p, _i64]),
    "jpeg_reconstruct": (_i, [_i64p, _i64, _i, _i64p, _i64p, _i64, _i64, _i, _u8p]),
    "jpeg_encode_entropy": (_i, [_u8p, _i64, _i64, _i32p, _i32p, _i32p, _i32p, _u8p, _i64, _i64p]),
    "png_unfilter": (_i, [_u8p, _i64, _i64, _i, _u8p]),
    "jpeg_decode_progressive": (_i, [_u8p, _i64p, _i64p, _i64, _i64p, _i32p, _i64, _i64, _i, _u8p,
                                     _u8p, _i32p, _i, _i, _i, _i, _i64p, _i64]),
    "resize_area_f32": (_i, [_f32p, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
                             _i64, _f32p]),
    "resize_area_u8": (_i, [_u8p, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
                            _u8p]),
    "resize_nearest": (_i, [_u8p, _i64, _i64, _i64, _i64, _i64, _u8p]),
    "resize_linear_f32": (_i, [_f32p, _i64, _i64, _i64, _i64, _i64, _f32p]),
    "hue_shift_f32": (None, [_f32p, _i64, _i64, _i, _f32p]),
    "orb_pattern": (None, [_i32p]),
    "rgb_to_gray_u8": (None, [_u8p, _i64, _u8p]),
    "resize_linear_exact_u8": (_i, [_u8p, _i64, _i64, _i64, _i64, _i64, _u8p]),
    "blur_sep_u8": (_i, [_u8p, _i64, _i64, _f32p, _i, _u8p]),
    "fast9_u8": (_i64, [_u8p, _i64, _i64, _i, _f32p, _i64]),
    "orb_detect_compute": (_i64, [_u8p, _i64, _i64, _i, ctypes.c_double, _i, _i, _i,
                                  ctypes.c_float, _i32p, _f32p, _f32p, _u8p, _i64]),
    "hamming_knn2": (None, [_u8p, _i64, _u8p, _i64, _i32p, _i32p]),
    "tiff_lzw_decode": (_i64, [_u8p, _i64, _u8p, _i64]),
    "tiff_lzw_encode": (_i64, [_u8p, _i64, _u8p]),
    "packbits_decode": (_i64, [_u8p, _i64, _u8p, _i64]),
    "bmp_rle_decode": (_i, [_u8p, _i64, _i64, _i64, _i, _u8p]),
}


def count(table: Dict[str, int], name: str) -> None:
    with _count_lock:
        table[name] += 1


def _sources():
    return sorted(CSRC.glob("*.cpp"))


def lib_path() -> Path:
    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libhost_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile csrc/host/*.cpp into lib_path() unless it is there. One
    process builds while the others wait on a lock file; the library is
    written to a temporary file and moved into place."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or "g++"
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, _sources())]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the host library needs a C++ compiler; {cxx!r} failed to "
                               f"start: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the host library failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


# ------------------------------------------------------------------- fastio

def crop_normalize(img: np.ndarray, oy: int, ox: int, crop_h: int, crop_w: int,
                   gamma: float = 0.0) -> np.ndarray:
    """float32 [H, W, 3] in [0, 1] -> the [crop_h, crop_w, 3] crop at (oy,
    ox), gamma-corrected (when gamma is set and not 1) and ImageNet-
    normalized: transforms.crop_normalize in one C pass (powf for the
    gamma, as the JAX package's library)."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"crop_normalize takes [H, W, 3], got {img.shape}")
    if oy < 0 or ox < 0 or oy + crop_h > img.shape[0] or ox + crop_w > img.shape[1]:
        raise ValueError(f"crop {(oy, ox, crop_h, crop_w)} outside the image {img.shape[:2]}")
    out = np.empty((crop_h, crop_w, 3), np.float32)
    lib = load()
    count(calls, "crop_normalize")
    lib.crop_normalize_f32(_ptr(img, _f32p), img.shape[0], img.shape[1], oy, ox, crop_h, crop_w,
                           float(gamma), _ptr(out, _f32p))
    return out


def u8_to_f32(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1], each value times float32(1 / 255)."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    lib = load()
    count(calls, "u8_to_f32")
    lib.u8_to_f32(_ptr(img, _u8p), img.size, _ptr(out, _f32p))
    return out


def stage_pyramid_native(arr: np.ndarray) -> dict:
    """The nearest 4-level pyramid of a (h, w) float32 map,
    transforms.stage_pyramid's {'stage1': 1/8, ..., 'stage4': 1/1}."""
    arr = np.ascontiguousarray(arr, np.float32)
    h, w = arr.shape
    outs = [np.empty((h // f, w // f), np.float32) for f in (8, 4, 2, 1)]
    lib = load()
    count(calls, "stage_pyramid")
    lib.stage_pyramid_f32(_ptr(arr, _f32p), h, w, *[_ptr(o, _f32p) for o in outs])
    return {f"stage{i + 1}": o for i, o in enumerate(outs)}


# ------------------------------------------------------------------ codecs

CORRUPT, AC_PAST_END, BAD_TABLE, NO_CODE, BAD_ARGUMENT, BAD_FILTER = 1, 2, 3, 4, 5, 6
MAX_SYMBOLS = 16 * 255  # a DHT table lists at most 16 x 255 symbols


def jpeg_decode_scan(segments, bases: np.ndarray, slots: np.ndarray, step: int, tables,
                     coefs: np.ndarray) -> int:
    """Huffman-decode one scan into coefs (int64, natural order per block):
    `segments` the destuffed restart intervals it needs, `bases` and
    `slots` each block's flat offset and component slot in scan order,
    `step` blocks per interval, `tables` per slot ((DC counts, symbols), (AC
    counts, symbols)). Returns 0 or an error code."""
    data = np.concatenate([np.asarray(s, np.uint8) for s in segments] + [np.zeros(1, np.uint8)])
    lens = np.array([len(s) for s in segments], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    n = len(tables)
    counts = np.zeros((n, 2, 16), np.uint8)
    symbols = np.zeros((n, 2, MAX_SYMBOLS), np.uint8)
    nsyms = np.zeros((n, 2), np.int32)
    for s, pair in enumerate(tables):
        for j, (cnt, sym) in enumerate(pair):
            counts[s, j] = np.frombuffer(cnt, np.uint8)
            symbols[s, j, :len(sym)] = np.frombuffer(sym, np.uint8)
            nsyms[s, j] = len(sym)
    bases = np.ascontiguousarray(bases, np.int64)
    slots = np.ascontiguousarray(slots, np.int32)
    lib = load()
    count(calls, "jpeg_decode_scan")
    return lib.jpeg_decode_scan(_ptr(data, _u8p), _ptr(starts, _i64p), _ptr(lens, _i64p),
                                len(segments), _ptr(bases, _i64p), _ptr(slots, _i32p),
                                len(bases), step, n, _ptr(counts, _u8p), _ptr(symbols, _u8p),
                                _ptr(nsyms, _i32p), _ptr(coefs, _i64p), coefs.size)


def jpeg_decode_progressive(segments, bases: np.ndarray, slots: np.ndarray, step: int, tables,
                            params, coefs: np.ndarray) -> int:
    """Huffman-decode one progressive scan into coefs, laid out as
    jpeg_decode_scan's arguments with one table per slot ((counts,
    symbols): DC first's DC table, an AC scan's AC table, any for a DC
    refinement) and params (Ss, Se, Ah, Al). Returns 0 or an error code."""
    data = np.concatenate([np.asarray(s, np.uint8) for s in segments] + [np.zeros(1, np.uint8)])
    lens = np.array([len(s) for s in segments], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    n = len(tables)
    counts = np.zeros((n, 16), np.uint8)
    symbols = np.zeros((n, MAX_SYMBOLS), np.uint8)
    nsyms = np.zeros(n, np.int32)
    for s, (cnt, sym) in enumerate(tables):
        counts[s] = np.frombuffer(cnt, np.uint8)
        symbols[s, :len(sym)] = np.frombuffer(sym, np.uint8)
        nsyms[s] = len(sym)
    bases = np.ascontiguousarray(bases, np.int64)
    slots = np.ascontiguousarray(slots, np.int32)
    lib = load()
    count(calls, "jpeg_decode_progressive")
    return lib.jpeg_decode_progressive(_ptr(data, _u8p), _ptr(starts, _i64p), _ptr(lens, _i64p),
                                       len(segments), _ptr(bases, _i64p), _ptr(slots, _i32p),
                                       len(bases), step, n, _ptr(counts, _u8p),
                                       _ptr(symbols, _u8p), _ptr(nsyms, _i32p), *map(int, params),
                                       _ptr(coefs, _i64p), coefs.size)


def jpeg_reconstruct(coefs: np.ndarray, comp: np.ndarray, qt: np.ndarray, h: int, w: int,
                     mode: int) -> np.ndarray:
    """Coefficients -> uint8 [h, w] (mode 0, one component), [h, w, 3]
    (mode 1 YCbCr -> RGB, mode 2 the planes as they are) or [h, w, 4] (PIL's
    inverted CMYK from mode 3 CMYK, mode 4 YCCK); comp [C, 8] per component
    (offset, bw, bh, width, height, x ratio, y ratio, 0), qt [C, 64] its
    dequantisation factors in natural order."""
    comp = np.ascontiguousarray(comp, np.int64)
    qt = np.ascontiguousarray(qt, np.int64)
    out = np.empty((h, w) if mode == 0 else (h, w, 4 if mode >= 3 else 3), np.uint8)
    lib = load()
    count(calls, "jpeg_reconstruct")
    err = lib.jpeg_reconstruct(_ptr(coefs, _i64p), coefs.size, len(comp), _ptr(comp, _i64p),
                               _ptr(qt, _i64p), h, w, mode, _ptr(out, _u8p))
    if err:
        raise RuntimeError(f"jpeg_reconstruct: bad arguments (error {err})")
    return out


def jpeg_encode_entropy(rgb: np.ndarray, qy: np.ndarray, qc: np.ndarray, codes: np.ndarray,
                        sizes: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> the entropy-coded scan of a baseline 4:2:0 JPEG
    (jpeg.encode's), or ValueError when a symbol has no Huffman code."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    blocks = -(-h // 16) * -(-w // 16) * 6
    cap = blocks * 528 + 16  # 65 tokens of at most 32 bits per block, each byte stuffed
    out = np.empty(cap, np.uint8)
    n = np.zeros(1, np.int64)
    arrays = [np.ascontiguousarray(a, np.int32) for a in (qy, qc, codes, sizes)]
    lib = load()
    count(calls, "jpeg_encode")
    err = lib.jpeg_encode_entropy(_ptr(rgb, _u8p), h, w, *[_ptr(a, _i32p) for a in arrays],
                                  _ptr(out, _u8p), cap, _ptr(n, _i64p))
    if err == NO_CODE:
        raise ValueError("JPEG encode: a symbol has no Huffman code")
    if err:
        raise RuntimeError(f"jpeg_encode_entropy: bad arguments (error {err})")
    return out[:int(n[0])].tobytes()


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + W*bpp] raw PNG rows (filter type byte first) -> [H, W*bpp]
    uint8; ValueError for a filter type other than 0-4."""
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    lib = load()
    count(calls, "png_unfilter")
    err = lib.png_unfilter(_ptr(rows, _u8p), h, stride, bpp, _ptr(out, _u8p))
    if err:
        raise ValueError(f"PNG: unknown row filter {int(rows[:, 0].max())}")
    return out


def tiff_lzw_decode(data: bytes, size: int, name="TIFF") -> np.ndarray:
    """One TIFF LZW strip or tile -> its first `size` bytes (uint8; a short
    stream leaves zeros, as libtiff's reader leaves them); ValueError for a
    corrupt stream."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(size, np.uint8)
    lib = load()
    count(calls, "tiff_lzw")
    n = lib.tiff_lzw_decode(_ptr(src, _u8p), len(src), _ptr(out, _u8p), size)
    if n < 0:
        raise ValueError(f"{name}: corrupt LZW data")
    return out


def tiff_lzw_encode(data: bytes) -> bytes:
    """Bytes -> one TIFF LZW strip (data/synthetic.py's TIFF writer)."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(2 * len(src) + 8, np.uint8)
    n = load().tiff_lzw_encode(_ptr(src, _u8p), len(src), _ptr(out, _u8p))
    return out[:n].tobytes()


def packbits_decode(data: bytes, size: int) -> np.ndarray:
    """One TIFF PackBits strip or tile -> its first `size` bytes (uint8)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(size, np.uint8)
    lib = load()
    count(calls, "tiff_packbits")
    lib.packbits_decode(_ptr(src, _u8p), len(src), _ptr(out, _u8p), size)
    return out


def bmp_rle_decode(data: bytes, width: int, height: int, bits: int, name="BMP") -> np.ndarray:
    """BMP RLE8 (bits 8) or RLE4 (4) pixel data -> palette indices uint8
    [height, width], rows bottom-up as stored; ValueError when a run leaves
    the image."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, width), np.uint8)
    lib = load()
    count(calls, "bmp_rle")
    if lib.bmp_rle_decode(_ptr(src, _u8p), len(src), width, height, bits, _ptr(out, _u8p)):
        raise ValueError(f"{name}: corrupt RLE{bits} data")
    return out


# ---------------------------------------------------------------- resample

def _window(height: int, width: int, window):
    """(oy, ox, wh, ww) of a (height, width) output, the whole of it when
    window is None; ValueError when it is not inside."""
    oy, ox, wh, ww = (0, 0, height, width) if window is None else map(int, window)
    if oy < 0 or ox < 0 or wh < 0 or ww < 0 or oy + wh > height or ox + ww > width:
        raise ValueError(f"window {(oy, ox, wh, ww)} outside the {height} x {width} output")
    return oy, ox, wh, ww


def _channels_last(img: np.ndarray):
    if img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"takes a non-empty [H, W] or [H, W, C] image, got {img.shape}")
    return img.shape[0], img.shape[1], 1 if img.ndim == 2 else img.shape[2]


def resize_area(img: np.ndarray, height: int, width: int, window=None) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA) for a
    float32 or uint8 [H, W] or [H, W, C] image, bit for bit
    image.resize_area's; `window` (oy, ox, h, w) gives only that part of
    the output, equal to the same slice of the whole (get_sample's crop).
    A shrink runs in the library (the integer fast path and the fractional
    one); the same size is a copy, and an enlarging axis takes
    image.resize_area's linear path in numpy, counted in
    plain_calls["resize_area_enlarge"]."""
    from .image import _area_factors, _resize_area_linear

    u8 = np.asarray(img).dtype == np.uint8
    img = np.ascontiguousarray(img, np.uint8 if u8 else np.float32)
    sh, sw, c = _channels_last(img)
    oy, ox, wh, ww = _window(height, width, window)
    if (height, width) == (sh, sw):
        return img[oy:oy + wh, ox:ox + ww].copy()
    if height > sh or width > sw:
        count(plain_calls, "resize_area_enlarge")
        return _resize_area_linear(img, height, width)[oy:oy + wh, ox:ox + ww]
    fy, fx = _area_factors(sh, sw, height, width)
    out = np.empty((wh, ww) + img.shape[2:], img.dtype)
    lib = load()
    count(calls, "resize_area")
    if u8:
        err = lib.resize_area_u8(_ptr(img, _u8p), sh, sw, c, height, width, fy, fx, oy, ox, wh,
                                 ww, _ptr(out, _u8p))
    else:
        err = lib.resize_area_f32(_ptr(img, _f32p), sh, sw, c, height, width, fy, fx, oy, ox, wh,
                                  ww, _ptr(out, _f32p))
    if err:
        raise RuntimeError(f"resize_area: bad arguments (error {err})")
    return out


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST) for
    an [H, W] or [H, W, C] image of any dtype, image.resize_nearest's
    pixels."""
    img = np.ascontiguousarray(img)
    sh, sw, c = _channels_last(img)
    out = np.empty((height, width) + img.shape[2:], img.dtype)
    lib = load()
    count(calls, "resize_nearest")
    err = lib.resize_nearest(_ptr(img.view(np.uint8), _u8p), sh, sw, c * img.itemsize, height,
                             width, _ptr(out.view(np.uint8), _u8p))
    if err:
        raise RuntimeError(f"resize_nearest: bad arguments (error {err})")
    return out


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR) for a
    float32 [H, W] or [H, W, C] image, bit for bit image.resize_linear's.
    The same size is a copy."""
    img = np.ascontiguousarray(img, np.float32)
    sh, sw, c = _channels_last(img)
    if (height, width) == (sh, sw):
        return img.copy()
    out = np.empty((height, width) + img.shape[2:], np.float32)
    lib = load()
    count(calls, "resize_linear")
    err = lib.resize_linear_f32(_ptr(img, _f32p), sh, sw, c, height, width, _ptr(out, _f32p))
    if err:
        raise RuntimeError(f"resize_linear: bad arguments (error {err})")
    return out


def hue_shift(img: np.ndarray, shift: int) -> np.ndarray:
    """float32 [H, W, 3] RGB in [0, 1] -> its 8-bit hue turned by `shift`
    of OpenCV's 180 steps, as float32 in [0, 1]: image.hue_shift's values
    (cv2's RGB -> HSV -> RGB) in one pass."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"hue_shift takes [H, W, 3], got {img.shape}")
    out = np.empty_like(img)
    lib = load()
    count(calls, "hue_shift")
    lib.hue_shift_f32(_ptr(img, _f32p), img.shape[0], img.shape[1], int(shift), _ptr(out, _f32p))
    return out


# --------------------------------------------------------------------- ORB

def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) for uint8 [H, W, 3]: OpenCV's
    15-bit fixed point, image.rgb_to_gray's values."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"rgb_to_gray takes [H, W, 3], got {img.shape}")
    out = np.empty(img.shape[:2], np.uint8)
    lib = load()
    count(calls, "rgb_to_gray")
    lib.rgb_to_gray_u8(_ptr(img, _u8p), img.shape[0] * img.shape[1], _ptr(out, _u8p))
    return out


def resize_linear_exact(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR_EXACT)
    for uint8 [H, W] or [H, W, C], image.resize_linear_exact's values."""
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, c = _channels_last(img)
    out = np.empty((height, width) + img.shape[2:], np.uint8)
    lib = load()
    count(calls, "resize_linear_exact")
    err = lib.resize_linear_exact_u8(_ptr(img, _u8p), sh, sw, c, height, width, _ptr(out, _u8p))
    if err:
        raise RuntimeError(f"resize_linear_exact: bad arguments (error {err})")
    return out


def blur_sep(img: np.ndarray, taps) -> np.ndarray:
    """cv2.sepFilter2D(img, -1, taps, taps, borderType=cv2.BORDER_REFLECT_101)
    on uint8 [H, W] with odd symmetric float32 `taps`: OpenCV's float path,
    the one ORB's blur of each pyramid level takes (orb.cpp blur_sep)."""
    img = np.ascontiguousarray(img, np.uint8)
    taps = np.ascontiguousarray(taps, np.float32)
    if img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"blur_sep takes a non-empty [H, W] image, got {img.shape}")
    if taps.ndim != 1 or len(taps) % 2 == 0:
        raise ValueError(f"blur_sep takes an odd number of taps, got {taps.shape}")
    out = np.empty_like(img)
    lib = load()
    count(calls, "blur")
    err = lib.blur_sep_u8(_ptr(img, _u8p), img.shape[0], img.shape[1], _ptr(taps, _f32p),
                          len(taps), _ptr(out, _u8p))
    if err:
        raise RuntimeError(f"blur_sep: bad arguments (error {err})")
    return out


def fast9(img: np.ndarray, threshold: int) -> np.ndarray:
    """cv2.FastFeatureDetector_create(threshold, True).detect(img) for uint8
    [H, W]: float32 [N, 3] rows (x, y, score) in cv2's order."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"fast9 takes [H, W], got {img.shape}")
    lib = load()
    count(calls, "fast9")
    cap = 4096
    while True:
        out = np.empty((cap, 3), np.float32)
        n = lib.fast9_u8(_ptr(img, _u8p), img.shape[0], img.shape[1], int(threshold),
                         _ptr(out, _f32p), cap)
        if n >= 0:
            return out[:n]
        cap = -n


def orb_pattern() -> np.ndarray:
    """The host library's rBRIEF table: int32 [256, 4], (x1, y1, x2, y2)."""
    out = np.empty(1024, np.int32)
    load().orb_pattern(_ptr(out, _i32p))
    return out.reshape(256, 4)


def orb_detect_compute(gray: np.ndarray, n_features: int, scale_factor: float, n_levels: int,
                       edge_threshold: int, fast_threshold: int, harris_k: float, blur_taps,
                       pattern=None):
    """OpenCV's ORB detectAndCompute on uint8 [H, W] (data/orb.py holds its
    parameters): (float32 [N, 6] keypoint rows (x, y, size, angle,
    response, octave), uint8 [N, 32] descriptors), in cv2's order."""
    gray = np.ascontiguousarray(gray, np.uint8)
    if gray.ndim != 2 or 0 in gray.shape:
        raise ValueError(f"ORB takes a non-empty [H, W] image, got {gray.shape}")
    taps = np.ascontiguousarray(blur_taps, np.float32)
    if taps.shape != (7,):
        raise ValueError(f"ORB's blur takes 7 taps, got {taps.shape}")
    pat = None if pattern is None else np.ascontiguousarray(pattern, np.int32).reshape(-1)
    if pat is not None and pat.shape != (1024,):
        raise ValueError(f"the rBRIEF table has 1024 values, got {pat.shape}")
    lib = load()
    count(calls, "orb")
    cap = 2 * n_features + 64
    while True:
        kps = np.empty((cap, 6), np.float32)
        desc = np.empty((cap, 32), np.uint8)
        n = lib.orb_detect_compute(_ptr(gray, _u8p), gray.shape[0], gray.shape[1], int(n_features),
                                   float(scale_factor), int(n_levels), int(edge_threshold),
                                   int(fast_threshold), float(harris_k),
                                   None if pat is None else _ptr(pat, _i32p), _ptr(taps, _f32p),
                                   _ptr(kps, _f32p), _ptr(desc, _u8p), cap)
        if n == -(1 << 40):
            raise ValueError(f"ORB: bad arguments for a {gray.shape} image")
        if n >= 0:
            return kps[:n], desc[:n]
        cap = -n


def hamming_knn2(a: np.ndarray, b: np.ndarray):
    """BFMatcher(NORM_HAMMING).knnMatch(a, b, k=2) for uint8 [Na, 32] and
    [Nb, 32]: (int32 [Na, 2] train indices, int32 [Na, 2] distances), the
    nearer first, the lower index first among equals, -1 where b has fewer
    than two rows."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.shape[1:] != (32,) or b.shape[1:] != (32,):
        raise ValueError(f"hamming_knn2 takes [N, 32] descriptors, got {a.shape}, {b.shape}")
    idx = np.empty((len(a), 2), np.int32)
    dist = np.empty((len(a), 2), np.int32)
    lib = load()
    count(calls, "hamming_knn2")
    lib.hamming_knn2(_ptr(a, _u8p), len(a), _ptr(b, _u8p), len(b), _ptr(idx, _i32p),
                     _ptr(dist, _i32p))
    return idx, dist
