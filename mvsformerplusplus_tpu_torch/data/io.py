"""On-disk formats (counterpart of mvsformerplusplus_tpu/data/io.py): PFM
depth maps, MVSNet cam files, pair lists, and PNG and JPEG images.

numpy, zlib and struct only: the machine the port runs on has no PIL and
no OpenCV. `read_png` decodes 8-bit non-interlaced PNG of every colour type
(gray, RGB, palette, gray+alpha, RGBA) with all five row filters and returns
what numpy makes of the image PIL opens; `read_image` reads PNG or baseline
JPEG (data/jpeg.py), chosen by the file's signature, and converts to RGB as
PIL's `convert("RGB")` does. Other files (16-bit or interlaced PNG,
progressive JPEG, other formats) raise ValueError naming the format.
`write_png` writes 8-bit gray, gray+alpha, RGB or RGBA PNG with unfiltered
rows.
"""
from __future__ import annotations

import re
import struct
import threading
import time
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .jpeg import decode as decode_jpeg


def read_pfm(filename) -> Tuple[np.ndarray, float]:
    """PFM (big/little-endian, mono or color) -> (H, W[, 3]) float32, scale."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {filename}")
        dim = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim:
            raise ValueError(f"malformed PFM header: {filename}")
        width, height = map(int, dim.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32), abs(scale)


def save_pfm(filename, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.flipud(np.asarray(image, np.float32))
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale:f}\n".encode())  # little-endian
        image.astype("<f4").tofile(f)


def _floats(text: str, shape) -> np.ndarray:
    return np.array([float(x) for x in text.split()], np.float32).reshape(shape)


def read_cam_file(filename, interval_scale: float = 1.0):
    """MVSNet cam txt -> (intrinsics 3x3, extrinsics 4x4, depth_min,
    depth_interval, extra); extra holds the optional depth_num / depth_max
    fields (depth_max synthesized from the raw interval for 3-field cams)."""
    with open(filename) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extrinsics = _floats(" ".join(lines[1:5]), (4, 4))
    intrinsics = _floats(" ".join(lines[7:10]), (3, 3))
    fields = lines[11].split()
    depth_min = float(fields[0])
    depth_interval = float(fields[1]) * interval_scale
    extra: Dict[str, float] = {}
    if len(fields) >= 3:
        extra["depth_num"] = float(fields[2])
        extra["depth_max"] = (float(fields[3]) if len(fields) >= 4
                              else depth_min + int(float(fields[2])) * float(fields[1]))
    return intrinsics, extrinsics, depth_min, depth_interval, extra


def save_cam_file(filename, intrinsics: np.ndarray, extrinsics: np.ndarray,
                  depth_min: float, depth_interval: float,
                  depth_num: Optional[float] = None,
                  depth_max: Optional[float] = None) -> None:
    with open(filename, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsics, np.float64):
            f.write(" ".join(f"{x}" for x in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsics, np.float64):
            f.write(" ".join(f"{x}" for x in row) + "\n")
        tail = f"\n{depth_min} {depth_interval}"
        if depth_num is not None and depth_max is not None:
            tail += f" {depth_num} {depth_max}"
        f.write(tail + "\n")


def read_pair_file(filename) -> List[Tuple[int, List[int]]]:
    """pair.txt -> [(ref_view, [src views sorted by score]), ...]."""
    pairs = []
    with open(filename) as f:
        num = int(f.readline())
        for _ in range(num):
            ref = int(f.readline().rstrip())
            fields = f.readline().rstrip().split()
            n = int(fields[0])
            pairs.append((ref, [int(fields[1 + 2 * i]) for i in range(n)]))
    return pairs


def save_pair_file(filename, pairs: Sequence[Tuple[int, Sequence[Tuple[int, float]]]]) -> None:
    """pairs: [(ref, [(src, score), ...]), ...]."""
    with open(filename, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, scored in pairs:
            f.write(f"{ref}\n{len(scored)} ")
            f.write(" ".join(f"{s} {score:.4f}" for s, score in scored) + "\n")


def build_camera_stack(intrinsics: np.ndarray, extrinsics: np.ndarray) -> np.ndarray:
    """(3x3, 4x4) -> the [2, 4, 4] stack the models take."""
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = extrinsics
    cam[1, :3, :3] = intrinsics
    cam[1, 3, 3] = 1.0
    return cam


def scale_intrinsics(intrinsics: np.ndarray, scale: float) -> np.ndarray:
    out = intrinsics.copy()
    out[:2] *= scale
    return out


# ------------------------------------------------------------------ PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def _sniff(head: bytes) -> str:
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head[:2] == b"BM":
        return "BMP"
    return "unknown format"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftypes: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: ftypes [H], rows [H, W*bpp] uint8 ->
    [H, W*bpp] uint8. Rows filtered with None/Sub/Up take one vectorized
    step each; any Average or Paeth row makes the whole image go along
    anti-diagonals of pixels (a pixel needs its left, upper and upper-left
    neighbours, all on earlier diagonals)."""
    h, stride = rows.shape
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftypes.max())}")
    if not ftypes.any():
        return rows.copy()
    if ftypes.max() <= 2:
        out = np.empty_like(rows)
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            f, x = ftypes[r], rows[r]
            if f == 1:
                x = x.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
            elif f == 2:
                x = x + prev
            out[r] = prev = x
        return out
    w = stride // bpp
    filt = rows.reshape(h, w, bpp).astype(np.int16)
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)  # one zero row above, one zero column left
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h, k + 1))
        x = k - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        t = ftypes[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def _decode_png(filename, data: Optional[bytes] = None):
    """-> (pixels uint8 [H, W, samples], colour type, palette [N, 3] or None)."""
    data = Path(filename).read_bytes() if data is None else data
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{filename}: {_sniff(data[:8])} file, not PNG")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{filename}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{filename}: PNG colour type {ctype} is not a valid PNG colour type")
    if depth != 8:
        raise ValueError(f"{filename}: {depth}-bit PNG is not supported (8-bit PNG only)")
    if interlace:
        raise ValueError(f"{filename}: interlaced (Adam7) PNG is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{filename}: palette PNG without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError(f"{filename}: truncated PNG image data")
    rows = raw[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    pixels = _unfilter(rows[:, 0], rows[:, 1:], bpp).reshape(h, w, bpp)
    return pixels, ctype, palette


def read_png(filename) -> np.ndarray:
    """8-bit PNG -> uint8 [H, W] (gray; palette indices) or [H, W, C] (gray +
    alpha C=2, RGB 3, RGBA 4), as np.asarray(PIL.Image.open(filename))."""
    pixels, _, _ = _decode_png(filename)
    return pixels[..., 0] if pixels.shape[2] == 1 else pixels


def read_image_u8(filename) -> np.ndarray:
    """PNG or JPEG file -> uint8 [H, W, 3], converted to RGB as PIL's
    convert("RGB") does: gray replicated, alpha dropped, palette looked up."""
    data = Path(filename).read_bytes()
    if _sniff(data[:8]) == "JPEG":
        pixels = decode_jpeg(data, str(filename))
        return np.repeat(pixels[..., None], 3, axis=2) if pixels.ndim == 2 else pixels
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{filename}: {_sniff(data[:8])} file; only PNG and JPEG images can "
                         "be read")
    pixels, ctype, palette = _decode_png(filename, data)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[pixels[..., 0]]
    if ctype in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return pixels[..., :3]


def read_image(filename) -> np.ndarray:
    """PNG or JPEG file -> float32 [H, W, 3] in [0, 1] (read_image_u8 / 255)."""
    return np.asarray(read_image_u8(filename), np.float32) / 255.0


class DecodedImages:
    """The decoded uint8 RGB of the last `size` image files read
    (read_image_u8), keyed by path. A file is decoded once under the lock,
    so two loader threads never decode it twice (decoding is Python and
    holds the interpreter lock: they would gain nothing by overlapping).
    The arrays handed out are read-only. `decodes` and `decode_s` count the
    misses and their seconds, file read included."""

    def __init__(self, size: int):
        self.size = size
        self._images: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.decodes = 0
        self.decode_s = 0.0

    def get(self, path) -> np.ndarray:
        key = str(path)
        with self._lock:
            if key in self._images:
                self._images.move_to_end(key)
                return self._images[key]
            t0 = time.perf_counter()
            pixels = read_image_u8(path)
            pixels.setflags(write=False)
            self.decode_s += time.perf_counter() - t0
            self.decodes += 1
            self._images[key] = pixels
            while len(self._images) > self.size:
                self._images.popitem(last=False)
            return pixels


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(filename, img: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, C] (C 1-4: gray, gray+alpha, RGB, RGBA) ->
    8-bit PNG file, every row unfiltered (encode_png)."""
    data = encode_png(img)
    with open(filename, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C 1-4: gray, gray+alpha, RGB, RGBA) ->
    the bytes of an 8-bit PNG, every row unfiltered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], got {img.shape}")
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return b"".join((_PNG_SIGNATURE,
                     _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)),
                     _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")))
