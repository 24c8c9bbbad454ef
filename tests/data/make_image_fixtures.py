"""Writes the image fixtures beside this file, which chip_smoke.py's
host_codec phase reads on a machine without PIL: each file as PIL writes
or reads it, with PIL's decoded pixels (np.asarray(Image.open(f))) beside
it as <name>.npy, and for the large progressive JPEG the SHA-256 of those
pixels in image_fixtures.json. Committed outputs were written with PIL
12.1.0 (its libjpeg-turbo) and numpy 2.0:

    python tests/data/make_image_fixtures.py

- progressive_420_q90.jpg: 61 x 90 RGB, PIL save(quality=90,
  progressive=True), 4:2:0;
- cmyk_q90.jpg: 40 x 56 CMYK, PIL save(quality=90) (an Adobe APP14
  marker, transform 0); ycck_q90.jpg: the same bytes with the transform
  set to 2, so libjpeg reads YCCK;
- gray16.png: 21 x 34 16-bit gray, PIL save() of an I;16 image;
- rgb16_adam7.png: 13 x 11 16-bit RGB, Adam7-interlaced, assembled here
  with struct and zlib (every row Paeth-filtered), then read by PIL;
- gray4_adam7.png: 9 x 30 4-bit gray, Adam7, assembled the same way;
- photo_1152x1536_progressive_q75.jpg: chip_smoke.photo(0, 1152, 1536),
  PIL save(quality=75, progressive=True), 4:2:0.
"""
import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def texture(seed, h, w, c=3):
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, c), np.ones((8, 8, 1)))[:h, :w]
    return (base * 200 + rng.rand(h, w, c) * 55).astype(np.uint8)


def chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def paeth_rows(samples, depth):
    """[h, w, c] samples -> every row packed and Paeth-filtered."""
    h, _, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = (samples.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    bpp = max(1, c * depth // 8)
    x = np.zeros((h + 1, rows.shape[1] + bpp), np.int64)
    x[1:, bpp:] = rows
    a, b, cc = x[1:, :-bpp], x[:-1, bpp:], x[:-1, :-bpp]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    filt = ((x[1:, bpp:] - pred) % 256).astype(np.uint8)
    return np.concatenate([np.full((h, 1), 4, np.uint8), filt], axis=1).tobytes()


def adam7_png(samples, depth, ctype):
    h, w, _ = samples.shape
    raw = b"".join(paeth_rows(samples[y0::dy, x0::dx], depth)
                   for y0, x0, dy, dx in ADAM7 if samples[y0::dy, x0::dx].size)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def save(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, **kw)
    return buf.getvalue()


def main():
    sys.path.insert(0, str(HERE.parents[1]))
    from chip_smoke import photo

    rng = np.random.RandomState(0)
    files = {
        "progressive_420_q90.jpg": save(Image.fromarray(texture(1, 61, 90)), format="JPEG",
                                        quality=90, progressive=True),
        "cmyk_q90.jpg": save(Image.fromarray(texture(2, 40, 56, 4), "CMYK"), format="JPEG",
                             quality=90),
        "gray16.png": save(Image.fromarray((rng.rand(21, 34) * 65535).astype(np.uint16)),
                           format="PNG"),
        "rgb16_adam7.png": adam7_png(rng.randint(0, 65536, (13, 11, 3)), 16, 2),
        "gray4_adam7.png": adam7_png(rng.randint(0, 16, (9, 30, 1)), 4, 0),
    }
    cmyk = bytearray(files["cmyk_q90.jpg"])
    cmyk[cmyk.index(b"Adobe") + 11] = 2
    files["ycck_q90.jpg"] = bytes(cmyk)
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        np.save(HERE / (name + ".npy"), np.asarray(Image.open(HERE / name)))
    big = "photo_1152x1536_progressive_q75.jpg"
    (HERE / big).write_bytes(save(Image.fromarray(photo(0, 1152, 1536)), format="JPEG",
                                  quality=75, progressive=True))
    pixels = np.ascontiguousarray(np.asarray(Image.open(HERE / big)))
    (HERE / "image_fixtures.json").write_text(json.dumps(
        {big: {"shape": list(pixels.shape), "sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
               "quality": 75}}, indent=1) + "\n")


if __name__ == "__main__":
    main()
