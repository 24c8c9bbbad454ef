"""On-disk formats (counterpart of mvsformerplusplus_tpu/data/io.py): PFM
depth maps, MVSNet cam files, pair lists, and PNG and JPEG images.

numpy, zlib and struct only: the machine the port runs on has no PIL and
no OpenCV. `read_png` decodes every PNG that PIL reads here: each colour
type (gray, RGB, palette, gray+alpha, RGBA) at each bit depth the format
allows (1, 2, 4, 8 and 16), with all five row filters, interlaced (Adam7)
or not, and returns what numpy makes of the image PIL opens (a tRNS chunk
changes neither). `read_image` reads PNG or JPEG (data/jpeg.py: baseline,
extended and progressive, gray, YCbCr, CMYK and YCCK), chosen by the file's
signature, and converts to RGB as PIL's `convert("RGB")` does. Other files
(BMP, TIFF, 12-bit, lossless, hierarchical or arithmetic-coded JPEG, ...)
raise ValueError naming the format. `write_png` writes 8-bit gray,
gray+alpha, RGB or RGBA PNG with unfiltered rows, or every row
Paeth-filtered (row_filter=4).

Reading unfilters PNG rows and decodes JPEG in the host library
(data/native.py: `native.png_unfilter`, `jpeg.decode_native`); `_unfilter`
and `jpeg.decode` are their numpy plain versions.
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

from . import native
from .jpeg import decode_native as decode_jpeg


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
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# the Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


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
    native.count(native.plain_calls, "png_unfilter")
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


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows [H, stride] -> their samples [H, w, channels]:
    uint8 (depths 1-8, the values as stored) or uint16 (16, big-endian)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        return rows[:, :2 * w * channels].copy().view(">u2").astype(np.uint16).reshape(
            h, w, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :w * channels].reshape(h, w, channels)


def _pass_rows(raw: np.ndarray, pos: int, h: int, w: int, depth: int, channels: int, name,
               plain: bool = False):
    """The h filtered rows of a (sub-)image of width w from raw[pos:],
    unfiltered (by `_unfilter` when plain, else natively) and unpacked:
    (samples [h, w, channels], the position after them)."""
    stride = -(-w * channels * depth // 8)
    n = h * (stride + 1)
    if raw.size < pos + n:
        raise ValueError(f"{name}: truncated PNG image data")
    rows = raw[pos:pos + n].reshape(h, stride + 1)
    bpp = max(1, channels * depth // 8)
    unfiltered = (_unfilter(rows[:, 0], rows[:, 1:], bpp) if plain
                  else native.png_unfilter(rows, bpp))
    return _samples(unfiltered, w, depth, channels), pos + n


def _decode_png(filename, data: Optional[bytes] = None, plain: bool = False):
    """-> (samples [H, W, channels], uint8 or uint16 at depth 16, as stored;
    colour type, bit depth, palette [N, 3] or None)."""
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
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{filename}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{filename}: PNG colour type {ctype} is not a valid PNG colour type")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{filename}: {depth}-bit PNG of colour type {ctype} is not a valid PNG")
    if interlace > 1:
        raise ValueError(f"{filename}: PNG interlace method {interlace} is not a valid PNG (0: "
                         "not interlaced, 1: interlaced, Adam7)")
    if ctype == 3 and palette is None:
        raise ValueError(f"{filename}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        pixels, _ = _pass_rows(raw, 0, h, w, depth, channels, filename, plain)
        return pixels, ctype, depth, palette
    # Adam7: seven sub-images, each filtered on its own, scattered back
    pixels = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in _ADAM7:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph > 0 and pw > 0:
            pixels[y0::dy, x0::dx], pos = _pass_rows(raw, pos, ph, pw, depth, channels, filename,
                                                     plain)
    return pixels, ctype, depth, palette


def _to_8bit(pixels: np.ndarray, depth: int) -> np.ndarray:
    """Samples of a gray, gray+alpha, RGB or RGBA PNG as PIL unpacks them to
    8 bits: the high byte at depth 16, a 1-, 2- or 4-bit gray level scaled
    to 0-255."""
    if depth == 16:
        return (pixels >> 8).astype(np.uint8)
    if depth < 8:
        return pixels * np.uint8(255 // ((1 << depth) - 1))
    return pixels


def read_png(filename, plain: bool = False):
    """PNG -> np.asarray(PIL.Image.open(filename)): [H, W] gray (uint8; bool
    at 1 bit; uint16 at 16 bits, PIL's I;16) or palette indices (uint8), or
    uint8 [H, W, C]: gray + alpha C=2 (at 16 bits PIL's RGBA, C=4), RGB 3,
    RGBA 4, each 16-bit sample its high byte. `plain` unfilters the rows
    with the numpy plain version."""
    pixels, ctype, depth, _ = _decode_png(filename, plain=plain)
    if ctype == 3:
        return pixels[..., 0]
    if ctype == 0:
        if depth == 1:
            return pixels[..., 0] != 0
        return pixels[..., 0] if depth == 16 else _to_8bit(pixels[..., 0], depth)
    pixels = _to_8bit(pixels, depth)
    if ctype == 4 and depth == 16:
        return pixels[..., [0, 0, 0, 1]]
    return pixels


def read_image_u8(filename) -> np.ndarray:
    """PNG or JPEG file -> uint8 [H, W, 3], converted to RGB as PIL's
    convert("RGB") does: gray replicated (16-bit gray saturated at 255),
    alpha dropped, palette looked up, CMYK by PIL's cmyk2rgb."""
    data = Path(filename).read_bytes()
    if _sniff(data[:8]) == "JPEG":
        pixels = decode_jpeg(data, str(filename))
        if pixels.ndim == 2:
            return np.repeat(pixels[..., None], 3, axis=2)
        return cmyk_to_rgb(pixels) if pixels.shape[2] == 4 else pixels
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{filename}: {_sniff(data[:8])} file; only PNG and JPEG images can "
                         "be read")
    pixels, ctype, depth, palette = _decode_png(filename, data)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[pixels[..., 0]]
    if ctype == 0 and depth == 16:
        return np.repeat(np.minimum(pixels, 255).astype(np.uint8), 3, axis=2)
    pixels = _to_8bit(pixels, depth)
    if ctype in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return pixels[..., :3]


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB (Convert.c cmyk2rgb): each of R, G, B is
    nk - nk x / 255 with nk = 255 - K, x = C, M, Y, the quotient rounded as
    PIL's MULDIV255 rounds it."""
    x = cmyk[..., :3].astype(np.int32)
    nk = 255 - cmyk[..., 3:].astype(np.int32)
    t = x * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def read_image(filename) -> np.ndarray:
    """PNG or JPEG file -> float32 [H, W, 3] in [0, 1] (read_image_u8 / 255)."""
    return np.asarray(read_image_u8(filename), np.float32) / 255.0


class DecodedImages:
    """The decoded uint8 RGB of the last `size` image files read
    (read_image_u8), keyed by path. Decoding runs outside the lock (the host
    library releases the interpreter lock, so loader threads decode
    different files at once); a thread asking for a file another thread is
    decoding waits for that file only, so each file is decoded once. The
    arrays handed out are read-only. `decodes` and `decode_s` count the
    misses and their seconds, file read included (summed over threads)."""

    def __init__(self, size: int):
        self.size = size
        self._images: OrderedDict = OrderedDict()
        self._pending: Dict[str, "_Pending"] = {}
        self._lock = threading.Lock()
        self.decodes = 0
        self.decode_s = 0.0

    def get(self, path) -> np.ndarray:
        key = str(path)
        while True:
            with self._lock:
                if key in self._images:
                    self._images.move_to_end(key)
                    return self._images[key]
                pending = self._pending.get(key)
                if pending is None:
                    pending = self._pending[key] = _Pending()
                    break
            pending.done.wait()
            if pending.pixels is not None:
                return pending.pixels
        try:
            t0 = time.perf_counter()
            pixels = read_image_u8(path)
            pixels.setflags(write=False)
            seconds = time.perf_counter() - t0
            with self._lock:
                self.decode_s += seconds
                self.decodes += 1
                self._images[key] = pending.pixels = pixels
                while len(self._images) > self.size:
                    self._images.popitem(last=False)
            return pixels
        finally:
            with self._lock:
                del self._pending[key]
            pending.done.set()


class _Pending:
    """A file one thread is decoding: set when it is done, with its pixels
    (None if decoding failed: a waiting thread then decodes it itself)."""

    def __init__(self):
        self.done = threading.Event()
        self.pixels: Optional[np.ndarray] = None


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(filename, img: np.ndarray, row_filter: int = 0) -> None:
    """uint8 [H, W] or [H, W, C] (C 1-4: gray, gray+alpha, RGB, RGBA) ->
    8-bit PNG file (encode_png)."""
    data = encode_png(img, row_filter)
    with open(filename, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray, row_filter: int = 0) -> bytes:
    """uint8 [H, W] or [H, W, C] (C 1-4: gray, gray+alpha, RGB, RGBA) ->
    the bytes of an 8-bit PNG, every row unfiltered (row_filter 0) or
    Paeth-filtered (4), as an encoder such as PIL's filters most rows of a
    photograph."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], got {img.shape}")
    if row_filter not in (0, 4):
        raise ValueError(f"write_png filters rows with 0 (None) or 4 (Paeth), got {row_filter}")
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c)
    if row_filter == 4:
        x = np.zeros((h + 1, w * c + c), np.int16)  # one zero row above, one zero pixel left
        x[1:, c:] = rows
        rows = (x[1:, c:] - _paeth(x[1:, :-c], x[:-1, c:], x[:-1, :-c])).astype(np.uint8)
    rows = np.concatenate([np.full((h, 1), row_filter, np.uint8), rows], axis=1)
    return b"".join((_PNG_SIGNATURE,
                     _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)),
                     _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")))
