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

The arithmetic-coded and lossless JPEG files PIL reads but cannot write
come from make_jpeg_f4.c beside this file, compiled here with the system C
compiler against PIL's bundled libjpeg-turbo (pillow.libs/libjpeg-*.so)
and the system jpeglib.h, all 61 x 45 RGB (texture(5)) unless noted:
- arith_420_q85.jpg: sequential arithmetic, 4:2:0; arith_444_dac_r3.jpg:
  4:4:4, DAC conditioning L=2 U=5 Kx=10, a restart every 3 MCUs;
  arith_progressive_q85.jpg: arithmetic with jpeg_simple_progression;
- lossless_p1.jpg: predictor 1, RGB; lossless_p7_pt2_r61.jpg: predictor 7,
  point transform 2, a restart every MCU row; lossless_gray_p4.jpg: gray,
  predictor 4.

The other formats, as PIL writes them, each with PIL's convert("RGB")
pixels beside it as <name>.npy (what read_image_u8 returns), the same
texture(6) at 45 x 61 unless noted: p6_1000.ppm (raw, maxval 1000),
p2_100.pgm (plain gray, maxval 100; written here), p4.pbm (a bitmap);
interlaced_trans.gif (PIL's default interlacing at this size, colour 3
transparent); lossy_q75.webp, lossless.webp, lossy_alpha.webp (an alpha
plane with a transparent block), anim.webp (two frames);
irreversible_tiles.jp2 (9/7, 32 x 32 tiles, layers 40/10),
reversible_rlcp.j2k (a raw codestream, RLCP, 32 x 32 precincts, layers
30/5) and gray16.jp2 (I;16, 21 x 34). At the eval scans' size, chip_smoke.
photo(0, 1152, 1536) as photo_1152x1536_q75.webp (PIL, quality 75) and
photo_1152x1536_irreversible.jp2 (PIL, 9/7, one layer at rate 20), the
SHA-256 of PIL's RGB pixels in large_format_fixtures.json.
"""
import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
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


def f4_jpegs() -> dict:
    """The arithmetic-coded and lossless JPEG files, written by
    make_jpeg_f4.c linked against PIL's own libjpeg-turbo."""
    import PIL

    libs = glob.glob(str(Path(PIL.__file__).parents[1] / "pillow.libs" / "libjpeg-*.so*"))
    rgb = texture(5, 45, 61)
    cases = {"arith_420_q85.jpg": (3, ["arith"]),
             "arith_444_dac_r3.jpg": (3, ["arith", "1", str(0x0A52), "3", "85"]),
             "arith_progressive_q85.jpg": (3, ["arith_prog"]),
             "lossless_p1.jpg": (3, ["lossless", "1", "0"]),
             "lossless_p7_pt2_r61.jpg": (3, ["lossless", "7", "2", "61"]),
             "lossless_gray_p4.jpg": (1, ["lossless", "4", "0"])}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "make_jpeg_f4")
        subprocess.run([os.environ.get("CC", "cc"), "-O1", "-o", exe, str(HERE / "make_jpeg_f4.c"),
                        libs[0], f"-Wl,-rpath,{Path(libs[0]).parent}"], check=True)
        for name, (c, args) in cases.items():
            pixels = rgb if c == 3 else np.ascontiguousarray(rgb[..., 0])
            path = os.path.join(tmp, name)
            subprocess.run([exe, path, "61", "45", str(c), *args], input=pixels.tobytes(),
                           check=True)
            out[name] = Path(path).read_bytes()
    return out


def other_formats() -> dict:
    """name -> bytes of the PNM, GIF, WebP and JPEG 2000 fixtures."""
    img = texture(6, 45, 61)
    rng = np.random.RandomState(6)
    gray16 = (rng.rand(21, 34) * 65535).astype(np.uint16)
    alpha = np.full((45, 61), 255, np.uint8)
    alpha[5:20, 10:40] = 0
    v16 = (img[..., 0].astype(np.int64) * 1000 // 255).astype(">u2")
    plain = " ".join(str(v) for v in (img[..., 1].astype(np.int64) * 100 // 255).ravel())
    files = {
        "p6_1000.ppm": b"P6\n61 45\n1000\n" + np.repeat(v16[..., None], 3, 2).tobytes(),
        "p2_100.pgm": b"P2\n# plain\n61 45\n100\n" + plain.encode() + b"\n",
        "p4.pbm": save(Image.fromarray(img[..., 2] > 128), format="PPM"),
        "interlaced_trans.gif": save(Image.fromarray(img).convert("P"), format="GIF",
                                     transparency=3),
        "lossy_q75.webp": save(Image.fromarray(img), format="WEBP", quality=75),
        "lossless.webp": save(Image.fromarray(img), format="WEBP", lossless=True),
        "lossy_alpha.webp": save(Image.fromarray(np.dstack([img, alpha])), format="WEBP",
                                 quality=80),
        "anim.webp": save(Image.fromarray(img), format="WEBP", save_all=True, quality=70,
                          append_images=[Image.fromarray(img[::-1].copy())]),
        "irreversible_tiles.jp2": save(Image.fromarray(img), format="JPEG2000", irreversible=True,
                                       tile_size=(32, 32), quality_layers=[40, 10]),
        "reversible_rlcp.j2k": save(Image.fromarray(img), format="JPEG2000", no_jp2=True,
                                    progression="RLCP", precinct_size=(32, 32),
                                    quality_layers=[30, 5]),
        "gray16.jp2": save(Image.fromarray(gray16), format="JPEG2000"),
    }
    return files


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
    files.update(f4_jpegs())
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        np.save(HERE / (name + ".npy"), np.asarray(Image.open(HERE / name)))
    for name, data in other_formats().items():
        (HERE / name).write_bytes(data)
        np.save(HERE / (name + ".npy"), np.asarray(Image.open(HERE / name).convert("RGB")))
    big = "photo_1152x1536_progressive_q75.jpg"
    (HERE / big).write_bytes(save(Image.fromarray(photo(0, 1152, 1536)), format="JPEG",
                                  quality=75, progressive=True))
    pixels = np.ascontiguousarray(np.asarray(Image.open(HERE / big)))
    (HERE / "image_fixtures.json").write_text(json.dumps(
        {big: {"shape": list(pixels.shape), "sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
               "quality": 75}}, indent=1) + "\n")
    large = {"photo_1152x1536_q75.webp": dict(format="WEBP", quality=75),
             "photo_1152x1536_irreversible.jp2": dict(format="JPEG2000", irreversible=True,
                                                      quality_layers=[20])}
    meta = {}
    for name, kw in large.items():
        (HERE / name).write_bytes(save(Image.fromarray(photo(0, 1152, 1536)), **kw))
        rgb = np.ascontiguousarray(np.asarray(Image.open(HERE / name).convert("RGB")))
        meta[name] = {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    (HERE / "large_format_fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")


if __name__ == "__main__":
    main()
