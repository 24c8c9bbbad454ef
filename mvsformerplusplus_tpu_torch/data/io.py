"""On-disk formats (counterpart of mvsformerplusplus_tpu/data/io.py): PFM
depth maps, MVSNet cam files, pair lists, and PNG and JPEG images.

numpy, zlib and struct only: the machine the port runs on has no PIL and
no OpenCV. `read_png` decodes every PNG that PIL reads here: each colour
type (gray, RGB, palette, gray+alpha, RGBA) at each bit depth the format
allows (1, 2, 4, 8 and 16), with all five row filters, interlaced (Adam7)
or not, and returns what numpy makes of the image PIL opens (a tRNS chunk
changes neither). `read_image` reads PNG, JPEG (data/jpeg.py: baseline,
extended and progressive, gray, YCbCr, CMYK and YCCK), BMP (palette, 24-
and 32-bit, RLE) or baseline TIFF (8- and 16-bit, strips or tiles,
uncompressed, LZW, Deflate or PackBits), chosen by the file's signature,
and converts to RGB as PIL's `convert("RGB")` does; `imread_rgb` reads the
same files as OpenCV's `imread` (EXIF orientation applied, its own 16-bit,
CMYK and alpha rules). Other files (WebP, JPEG 2000, OpenEXR, PNM, 12-bit,
lossless, hierarchical or arithmetic-coded JPEG, ...) raise ValueError
naming the format. `write_png` writes 8-bit gray,
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
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    """The image format a file's first 16 bytes name."""
    if head[:8] == _PNG_SIGNATURE:
        return "PNG"
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head[:4] in (b"II+\x00", b"MM\x00+"):
        return "BigTIFF"
    if head[:2] == b"BM":
        return "BMP"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or head[:4] == b"\xff\x4f\xff\x51":
        return "JPEG 2000"
    if head[:4] == b"\x76\x2f\x31\x01":
        return "OpenEXR"
    if head[:10] in (b"#?RADIANCE", b"#?RGBE\n") or head[:6] == b"#?RGBE":
        return "Radiance HDR"
    if head[:2] in (b"PF", b"Pf"):
        return "PFM"
    if head[:1] == b"P" and head[1:2] in b"1234567":
        return "PNM"
    if head[:4] in (b"GIF8",):
        return "GIF"
    if head[:4] == b"\x59\xa6\x6a\x95":
        return "Sun raster"
    if head[4:12] in (b"ftypavif", b"ftypheic", b"ftypheix", b"ftypmif1"):
        return "AVIF/HEIF"
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


class _Png(NamedTuple):
    pixels: np.ndarray  # [H, W, channels], uint8 or uint16 at depth 16, as stored
    ctype: int
    depth: int
    palette: Optional[np.ndarray]  # [N, 3] or None
    exif: Optional[bytes]  # the eXIf chunk


def _decode_png(filename, data: Optional[bytes] = None, plain: bool = False) -> _Png:
    data = Path(filename).read_bytes() if data is None else data
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{filename}: {_sniff(data[:16])} file, not PNG")
    pos, idat, header, palette, exif = 8, [], None, None, None
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
        elif kind == b"eXIf" and exif is None:
            exif = body
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
        return _Png(pixels, ctype, depth, palette, exif)
    # Adam7: seven sub-images, each filtered on its own, scattered back
    pixels = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in _ADAM7:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph > 0 and pw > 0:
            pixels[y0::dy, x0::dx], pos = _pass_rows(raw, pos, ph, pw, depth, channels, filename,
                                                     plain)
    return _Png(pixels, ctype, depth, palette, exif)


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
    pixels, ctype, depth, _, _ = _decode_png(filename, plain=plain)
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
    """PNG, JPEG, BMP or TIFF file -> uint8 [H, W, 3], converted to RGB as
    PIL's convert("RGB") does: gray replicated (16-bit gray saturated at
    255), alpha dropped, palette looked up, CMYK by PIL's cmyk2rgb, 16-bit
    RGB its high bytes. No orientation tag is applied; a TIFF whose
    orientation is not 1 raises (PIL applies it with some compressions)."""
    return _read_rgb(filename, cv2_rules=False)


def imread_rgb(filename) -> np.ndarray:
    """cv2.cvtColor(cv2.imread(filename), cv2.COLOR_BGR2RGB) for PNG, JPEG,
    BMP and TIFF: uint8 [H, W, 3] as OpenCV's IMREAD_COLOR gives it, which
    differs from read_image_u8 (PIL) in that
    - the EXIF orientation (JPEG APP1, PNG eXIf; TIFF's tag, where cv2 reads
      only 1-4) turns or flips the image;
    - 16-bit samples are shifted down 8 bits (PNG, gray TIFF) or divided by
      257 and rounded (RGB TIFF), not saturated;
    - CMYK JPEG takes OpenCV's K - (255 - C) K / 256;
    - 8-bit TIFF goes through libtiff's RGBA reader: unassociated alpha is
      multiplied in, (v a + 127) / 255.
    Gray is replicated, alpha otherwise dropped, a palette looked up; other
    formats raise ValueError naming the format."""
    return _read_rgb(filename, cv2_rules=True)


def _read_rgb(filename, cv2_rules: bool) -> np.ndarray:
    """read_image_u8 (PIL's rules) or imread_rgb (cv2's)."""
    data = Path(filename).read_bytes()
    kind = _sniff(data[:16])
    if kind == "JPEG":
        pixels = decode_jpeg(data, str(filename))
        if pixels.ndim == 2:
            pixels = np.repeat(pixels[..., None], 3, axis=2)
        elif pixels.shape[2] == 4:
            pixels = (_cmyk_to_rgb_cv2 if cv2_rules else cmyk_to_rgb)(pixels)
        return _orient(pixels, _exif_orientation(_jpeg_exif(data))) if cv2_rules else pixels
    if kind == "BMP":
        return _decode_bmp(data, filename)
    if kind == "TIFF":
        tiff = _decode_tiff(data, filename)
        if tiff.orientation > (4 if cv2_rules else 1):
            raise ValueError(f"{filename}: TIFF orientation {tiff.orientation}, which "
                             + ("OpenCV does not read" if cv2_rules
                                else "PIL applies or not by the file's compression"))
        return _orient(_tiff_rgb(tiff, cv2_rules), tiff.orientation)
    if kind != "PNG":
        raise ValueError(f"{filename}: {kind} file; only PNG, JPEG, BMP and TIFF images can "
                         "be read")
    pixels, ctype, depth, palette, exif = _decode_png(filename, data)
    if ctype == 3:
        rgb = _lookup(pixels[..., 0], palette)
    elif ctype == 0 and depth == 16 and not cv2_rules:
        rgb = np.repeat(np.minimum(pixels, 255).astype(np.uint8), 3, axis=2)
    else:
        pixels = _to_8bit(pixels, depth)
        rgb = np.repeat(pixels[..., :1], 3, axis=2) if ctype in (0, 4) else pixels[..., :3]
    return _orient(rgb, _exif_orientation(exif)) if cv2_rules else rgb


def _lookup(index: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Palette indices -> RGB, indices past the palette black."""
    table = np.zeros((256, 3), np.uint8)
    table[:min(len(palette), 256)] = palette[:256]
    return table[index]


def _cmyk_to_rgb_cv2(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's CMYK -> RGB (icvCvt_CMYK2BGR_8u_C4C3R) on libjpeg's CMYK,
    here from PIL's inverted CMYK the decoder returns: with k = 255 - K and
    x = C, M, Y, each of R, G, B is k - (x k >> 8)."""
    x = cmyk[..., :3].astype(np.int32)
    k = 255 - cmyk[..., 3:].astype(np.int32)
    return (k - ((x * k) >> 8)).astype(np.uint8)


# ------------------------------------------------------------ orientation

def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """img as an EXIF orientation (1-8) tag says it is to be shown."""
    ops = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
           7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: a.transpose(1, 0, 2)[::-1]}
    return np.ascontiguousarray(ops.get(orientation, ops[1])(img))


def _jpeg_exif(data: bytes) -> Optional[bytes]:
    """The TIFF structure of a JPEG's first Exif APP1 segment, or None."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            break
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xE1 and data[pos + 4:pos + 10] == b"Exif\x00\x00":
            return data[pos + 10:pos + 2 + n]
        pos += 2 + n
    return None


def _exif_orientation(exif: Optional[bytes]) -> int:
    """The Orientation (0x0112) of an EXIF block's IFD0, 1 if it has none
    or it is out of range."""
    if exif and exif[:6] == b"Exif\x00\x00":
        exif = exif[6:]
    if not exif or exif[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if exif[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(e + "I", exif[4:8])
        (n,) = struct.unpack(e + "H", exif[ifd:ifd + 2])
        for i in range(n):
            tag, typ, count = struct.unpack(e + "HHI", exif[ifd + 2 + 12 * i:ifd + 10 + 12 * i])
            if tag == 0x0112 and typ == 3 and count >= 1:
                (v,) = struct.unpack(e + "H", exif[ifd + 10 + 12 * i:ifd + 12 + 12 * i])
                return v if 1 <= v <= 8 else 1
    except struct.error:
        return 1
    return 1


# ------------------------------------------------------------------ BMP

_BMP_RGB, _BMP_RLE8, _BMP_RLE4, _BMP_BITFIELDS, _BMP_ALPHABITFIELDS = 0, 1, 2, 3, 6


def _decode_bmp(data: bytes, name) -> np.ndarray:
    """BMP -> uint8 [H, W, 3] RGB, what PIL's convert("RGB") and cv2's
    IMREAD_COLOR both give: 1-, 4- and 8-bit palette (uncompressed, RLE4,
    RLE8), 24-bit, and 32-bit (BI_RGB, or bit fields that are the plain
    byte masks; the fourth byte dropped), bottom-up or top-down rows."""
    if len(data) < 26:
        raise ValueError(f"{name}: truncated BMP header")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        comp, n_colors, entry = _BMP_RGB, 0, 3
    elif hsize in (40, 52, 56, 108, 124):
        w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
        (n_colors,) = struct.unpack("<I", data[46:50])
        entry = 4
    else:
        raise ValueError(f"{name}: BMP header of {hsize} bytes is not one the port reads")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: BMP of {w} x {h} pixels")
    pal_start = 14 + hsize
    if comp in (_BMP_BITFIELDS, _BMP_ALPHABITFIELDS):
        if hsize == 40:
            masks = struct.unpack("<III", data[54:66])
            pal_start += 12 if comp == _BMP_BITFIELDS else 16
        else:
            masks = struct.unpack("<III", data[54:66])
        if bits != 32 or masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"{name}: {bits}-bit BMP with bit fields {masks} is not one the "
                             "port reads")
        comp = _BMP_RGB
    if (comp, bits) not in ((_BMP_RGB, 1), (_BMP_RGB, 4), (_BMP_RGB, 8), (_BMP_RGB, 24),
                            (_BMP_RGB, 32), (_BMP_RLE8, 8), (_BMP_RLE4, 4)):
        kind = {_BMP_RLE8: "RLE8", _BMP_RLE4: "RLE4", 4: "JPEG", 5: "PNG"}.get(comp, comp)
        raise ValueError(f"{name}: {bits}-bit BMP (compression {kind}) is not one the port "
                         "reads")
    pixels = data[offset:]
    if bits <= 8:
        n = n_colors or (1 << bits)
        pal = np.frombuffer(data[pal_start:pal_start + entry * n], np.uint8)
        pal = pal[:len(pal) // entry * entry].reshape(-1, entry)[:, 2::-1]
        if comp != _BMP_RGB:
            if top_down:
                raise ValueError(f"{name}: top-down RLE BMP is not a valid BMP")
            index = native.bmp_rle_decode(pixels, w, h, bits, str(name))
        else:
            stride = (w * bits + 31) // 32 * 4
            rows = _bmp_rows(pixels, stride, h, name)
            index = _samples(rows, w, bits, 1)[..., 0]
        rgb = _lookup(index, pal)
    else:
        c = bits // 8
        stride = (w * bits + 31) // 32 * 4
        rgb = _bmp_rows(pixels, stride, h, name)[:, :w * c].reshape(h, w, c)[..., 2::-1]
    return np.ascontiguousarray(rgb if top_down else rgb[::-1])


def _bmp_rows(pixels: bytes, stride: int, h: int, name) -> np.ndarray:
    if len(pixels) < stride * h:
        raise ValueError(f"{name}: truncated BMP pixel data")
    return np.frombuffer(pixels, np.uint8, stride * h).reshape(h, stride)


# ----------------------------------------------------------------- TIFF

class _Tiff(NamedTuple):
    samples: np.ndarray  # [H, W, spp], uint8 or uint16
    photometric: int
    extra: Tuple[int, ...]
    colormap: Optional[np.ndarray]  # [N, 3] uint16
    orientation: int


_TIFF_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "c", 8: "h", 9: "i",
               10: "ii", 11: "f", 12: "d", 16: "Q"}
_TIFF_COMPRESSION = {1: "uncompressed", 2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 5: "LZW",
                     6: "old JPEG", 7: "JPEG", 8: "Deflate", 32946: "Deflate",
                     32773: "PackBits", 34712: "JPEG 2000", 50000: "Zstandard",
                     34925: "LZMA", 50001: "WebP"}


def _tiff_tags(data: bytes, name) -> Tuple[str, Dict[int, tuple]]:
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", data[4:8])
    if ifd + 2 > len(data):
        raise ValueError(f"{name}: truncated TIFF")
    (n,) = struct.unpack(e + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack(e + "HHI", data[at:at + 8])
        if typ not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[typ] * count
        size = struct.calcsize(e + fmt)
        where = at + 8 if size <= 4 else struct.unpack(e + "I", data[at + 8:at + 12])[0]
        tags[tag] = struct.unpack(e + fmt, data[where:where + size])
    return e, tags


def _decode_tiff(data: bytes, name) -> _Tiff:
    """The first image of a baseline TIFF: 8- or 16-bit unsigned samples,
    chunky, gray (either photometric), RGB or palette with any extra
    samples, in strips or tiles, uncompressed, LZW, Deflate or PackBits,
    with or without the horizontal predictor (2)."""
    e, tags = _tiff_tags(data, name)
    one = lambda tag, default=None: tags[tag][0] if tag in tags else default  # noqa: E731
    w, h = one(256), one(257)
    bps = tags.get(258, (1,))
    spp = one(277, 1)
    comp = one(259, 1)
    photometric = one(262)
    predictor = one(317, 1)
    if w is None or h is None or photometric is None:
        raise ValueError(f"{name}: TIFF without width, height or photometric tag")
    if comp not in (1, 5, 8, 32946, 32773):
        raise ValueError(f"{name}: TIFF with {_TIFF_COMPRESSION.get(comp, comp)} compression "
                         "is not one the port reads")
    if len(set(bps)) != 1 or bps[0] not in (8, 16):
        raise ValueError(f"{name}: {'/'.join(map(str, bps))}-bit TIFF is not one the port reads "
                         "(8 or 16 bits)")
    if one(339, 1) != 1:
        raise ValueError(f"{name}: TIFF with sample format {one(339)} is not one the port "
                         "reads (unsigned integers)")
    if one(284, 1) != 1:
        raise ValueError(f"{name}: planar TIFF is not one the port reads (chunky pixels)")
    if photometric not in (0, 1, 2, 3) or (photometric in (0, 3) and bps[0] != 8):
        kind = {4: "transparency mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab"}.get(photometric,
                                                                              photometric)
        raise ValueError(f"{name}: {bps[0]}-bit TIFF of photometric {kind} is not one the "
                         "port reads")
    if predictor not in (1, 2):
        raise ValueError(f"{name}: TIFF predictor {predictor} is not one the port reads")
    dtype = np.dtype(np.uint8) if bps[0] == 8 else np.dtype(e + "u2")
    tiled = 322 in tags
    offsets, counts = tags.get(324 if tiled else 273), tags.get(325 if tiled else 279)
    if offsets is None or counts is None:
        raise ValueError(f"{name}: TIFF without {'tile' if tiled else 'strip'} offsets or "
                         "byte counts")
    if tiled:
        cw, ch = one(322), one(323)
        grid = [(y, x) for y in range(0, h, ch) for x in range(0, w, cw)]
    else:
        cw, ch = w, one(278, h)
        grid = [(y, 0) for y in range(0, h, ch)]
    if len(offsets) < len(grid) or len(counts) < len(grid):
        raise ValueError(f"{name}: TIFF with {len(offsets)} strips or tiles for {len(grid)}")
    out = np.zeros((h, w, spp), dtype.newbyteorder("="))
    size = cw * ch * spp * dtype.itemsize
    for (y, x), off, n in zip(grid, offsets, counts):
        chunk = data[off:off + n]
        if comp == 1:
            raw = np.zeros(size, np.uint8)
            raw[:min(size, len(chunk))] = np.frombuffer(chunk, np.uint8)[:size]
        elif comp == 5:
            raw = native.tiff_lzw_decode(chunk, size, str(name))
        elif comp == 32773:
            raw = native.packbits_decode(chunk, size)
        else:
            try:
                body = zlib.decompress(chunk)
            except zlib.error as err:
                raise ValueError(f"{name}: corrupt Deflate data ({err})") from err
            raw = np.zeros(size, np.uint8)
            raw[:min(size, len(body))] = np.frombuffer(body, np.uint8)[:size]
        block = raw.view(dtype).reshape(ch, cw, spp).astype(dtype.newbyteorder("="))
        if predictor == 2:
            block = np.cumsum(block, axis=1, dtype=block.dtype)
        rows, cols = min(ch, h - y), min(cw, w - x)
        out[y:y + rows, x:x + cols] = block[:rows, :cols]
    cmap = None
    if photometric == 3:
        if 320 not in tags:
            raise ValueError(f"{name}: palette TIFF without a colour map")
        cmap = np.array(tags[320], np.uint16).reshape(3, -1).T
    base = 3 if photometric == 2 else 1
    extra = tuple(tags.get(338, (0,) * (spp - base)))
    return _Tiff(out, photometric, extra, cmap, one(274, 1))


def _tiff_rgb(t: _Tiff, cv2_rules: bool) -> np.ndarray:
    """A decoded TIFF as RGB uint8: PIL's convert("RGB") (cv2_rules False)
    or cv2's IMREAD_COLOR (True; 8-bit through libtiff's RGBA reader)."""
    x, pm = t.samples, t.photometric
    sixteen = x.dtype == np.uint16
    if pm == 3:
        return _lookup(x[..., 0], (t.colormap >> 8).astype(np.uint8))
    if pm in (0, 1):
        g = x[..., 0]
        if sixteen:
            g = (g >> 8) if cv2_rules else np.minimum(g, 255)
            g = g.astype(np.uint8)
        if pm == 0:
            g = 255 - g
        rgb = np.repeat(g[..., None], 3, axis=2)
        alpha = x[..., 1] if x.shape[2] > 1 and not sixteen else None
    else:
        if sixteen:
            v = x[..., :3].astype(np.int64)
            rgb = ((v * 255 + 32767) // 65535 if cv2_rules else v >> 8).astype(np.uint8)
            alpha = None
        else:
            rgb = x[..., :3]
            alpha = x[..., 3] if x.shape[2] > 3 else None
    if cv2_rules and alpha is not None and t.extra[:1] == (2,):
        a = alpha.astype(np.int32)[..., None]
        rgb = ((rgb.astype(np.int32) * a + 127) // 255).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB (Convert.c cmyk2rgb): each of R, G, B is
    nk - nk x / 255 with nk = 255 - K, x = C, M, Y, the quotient rounded as
    PIL's MULDIV255 rounds it."""
    x = cmyk[..., :3].astype(np.int32)
    nk = 255 - cmyk[..., 3:].astype(np.int32)
    t = x * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def read_image(filename) -> np.ndarray:
    """PNG, JPEG, BMP or TIFF file -> float32 [H, W, 3] in [0, 1]
    (read_image_u8 / 255)."""
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


def encode_bmp(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> a 24-bit bottom-up BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_bmp takes uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54) + dib + rows.tobytes())


def encode_tiff(img: np.ndarray, rows_per_strip: int = 64, predictor: int = 2) -> bytes:
    """uint8 [H, W] or [H, W, 3] -> a little-endian LZW TIFF in strips of
    rows_per_strip rows, with the horizontal predictor (2) or none (1):
    the layout cv2.imwrite writes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_tiff takes uint8 [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    x = img.reshape(h, w, c)
    if predictor == 2:
        x = np.diff(x.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    strips = [native.tiff_lzw_encode(x[y:y + rows_per_strip].tobytes())
              for y in range(0, h, rows_per_strip)]
    n = len(strips)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * c), (259, 3, [5]),
            (262, 3, [2 if c == 3 else 1]), (273, 4, None), (277, 3, [c]),
            (278, 4, [rows_per_strip]), (279, 4, [len(s) for s in strips]), (284, 3, [1]),
            (317, 3, [predictor])]
    ifd_size = 2 + 12 * len(tags) + 4
    blob_at = 8 + ifd_size
    blobs = bytearray()
    fields = {}
    for tag, typ, vals in tags:
        if tag == 273:
            continue
        fmt = "<" + ("H" if typ == 3 else "I") * len(vals)
        raw = struct.pack(fmt, *vals)
        if len(raw) <= 4:
            fields[tag] = (typ, len(vals), raw.ljust(4, b"\x00"))
        else:
            fields[tag] = (typ, len(vals), struct.pack("<I", blob_at + len(blobs)))
            blobs += raw
    offsets_at = blob_at + len(blobs)
    data_at = offsets_at + 4 * n
    offsets = np.cumsum([data_at] + [len(s) for s in strips[:-1]]).tolist()
    if n == 1:
        fields[273] = (4, 1, struct.pack("<I", offsets[0]))
    else:
        fields[273] = (4, n, struct.pack("<I", offsets_at))
    out = bytearray(b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", len(tags)))
    for tag in sorted(fields):
        typ, count, raw = fields[tag]
        out += struct.pack("<HHI", tag, typ, count) + raw
    out += struct.pack("<I", 0) + blobs + struct.pack(f"<{n}I", *offsets) + b"".join(strips)
    return bytes(out)


def with_exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """A JPEG's bytes with an Exif APP1 segment (IFD0: Orientation) after
    its SOI marker."""
    tiff = (b"MM\x00*" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0))
    body = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]
