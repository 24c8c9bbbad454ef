"""The port's BMP and TIFF readers and its cv2.imread (data/io.py:
read_image_u8, imread_rgb) against PIL and OpenCV. Tolerance: none.

- read_image_u8 equals PIL's convert("RGB") and imread_rgb equals
  cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB) on BMP (1-, 4- and 8-bit
  palette, 24- and 32-bit, bottom-up and top-down, the OS/2 header, RLE8
  and RLE4 where PIL and cv2 agree; RLE4 with odd absolute runs, which PIL
  reads otherwise, against cv2 alone) and on baseline TIFF (8-bit gray, RGB
  and RGBA and 16-bit gray and RGB; uncompressed, LZW, Deflate and
  PackBits; predictor 2; strips and tiles, assembled here with struct and
  zlib);
- imread_rgb equals cv2 on PNG (1-16 bits, gray + alpha, RGBA, palette
  with tRNS, an eXIf orientation), gray and CMYK JPEG and JPEG with EXIF
  orientations 1-8, and TIFF orientations 1-4 (cv2 reads no other);
- what neither reads, or the port does not, raises ValueError naming the
  format.
"""
import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from mvsformerplusplus_tpu_torch.data import native
from mvsformerplusplus_tpu_torch.data.io import imread_rgb, read_image_u8


def _rng(seed):
    return np.random.RandomState(seed)


def _texture(seed, h, w, c=3):
    rng = _rng(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, c), np.ones((8, 8, 1)))[:h, :w]
    return (base * 200 + rng.rand(h, w, c) * 55).astype(np.uint8)


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _check_both(path):
    np.testing.assert_array_equal(read_image_u8(path), np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(imread_rgb(path), _cv2_rgb(path))


# ------------------------------------------------------------------ BMP

def _bmp(w, h, bits, pixels, palette=None, comp=0, top_down=False, core=False) -> bytes:
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if core else b"\x00") for r, g, b in palette)
    if core:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, comp,
                          len(pixels), 2835, 2835, 0 if palette is None else len(palette), 0)
    off = 14 + len(dib) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + dib + pal + pixels


def _bmp_rows(data, bits):
    """[h, w] indices or [h, w, 3] RGB, rows in file order -> padded rows."""
    out = []
    for row in data:
        if bits == 24:
            b = row[:, ::-1].astype(np.uint8).tobytes()
        elif bits == 8:
            b = row.astype(np.uint8).tobytes()
        elif bits == 4:
            v = np.concatenate([row, [0] * (len(row) % 2)]).astype(np.uint8)
            b = ((v[0::2] << 4) | v[1::2]).astype(np.uint8).tobytes()
        else:
            b = np.packbits(row.astype(np.uint8)).tobytes()
        out.append(b + b"\x00" * (-len(b) % 4))
    return b"".join(out)


def _rle8(index):
    """Encoded runs where values repeat, absolute runs elsewhere."""
    out = bytearray()
    for row in index.tolist():
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, row[i]])
                i = j
                continue
            j = i
            while j < len(row) and j - i < 255 and (j + 1 >= len(row) or row[j + 1] != row[j]):
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i]) + bytes(row[i:j]) + b"\x00" * ((j - i) % 2)
            else:
                j = i + 1
                out += bytes([1, row[i]])
            i = j
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(index, absolute):
    """Absolute runs of `absolute` pixels on odd rows, encoded pairs
    elsewhere and for the rest of a row."""
    out = bytearray()
    for r, row in enumerate(index.tolist()):
        i = 0
        while i < len(row):
            n = min(len(row) - i, absolute)
            if r % 2 and n >= 3:
                seg = row[i:i + n] + [0] * (n % 2)
                b = bytes((seg[k] << 4) | seg[k + 1] for k in range(0, len(seg), 2))
                out += bytes([0, n]) + b + b"\x00" * (len(b) % 2)
                i += n
            else:
                n = min(2, len(row) - i)
                out += bytes([n, (row[i] << 4) | (row[i + 1] if n == 2 else 0)])
                i += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _bmp_cases():
    rng = _rng(3)
    h, w = 11, 19
    pal16 = [tuple(rng.randint(0, 256, 3)) for _ in range(16)]
    pal256 = [tuple(rng.randint(0, 256, 3)) for _ in range(256)]
    idx4 = rng.randint(0, 16, (h, w))
    idx8 = rng.randint(0, 256, (h, w))
    idx8[:, 3:9] = 7
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    two = [(10, 20, 30), (200, 100, 50)]
    return {
        "p1": _bmp(w, h, 1, _bmp_rows(idx4 % 2, 1), two),
        "p4": _bmp(w, h, 4, _bmp_rows(idx4, 4), pal16),
        "p4_short_palette": _bmp(w, h, 4, _bmp_rows(idx4 % 5, 4), pal16[:5]),
        "p8": _bmp(w, h, 8, _bmp_rows(idx8, 8), pal256),
        "rgb24": _bmp(w, h, 24, _bmp_rows(rgb, 24)),
        "top_down24": _bmp(w, h, 24, _bmp_rows(rgb, 24), top_down=True),
        "top_down8": _bmp(w, h, 8, _bmp_rows(idx8, 8), pal256, top_down=True),
        "os2_24": _bmp(w, h, 24, _bmp_rows(rgb, 24), core=True),
        "os2_8": _bmp(w, h, 8, _bmp_rows(idx8, 8), pal256, core=True),
        "rle8": _bmp(w, h, 8, _rle8(idx8), pal256, comp=1),
        "rle4": _bmp(w, h, 4, _rle4(idx4, 6), pal16, comp=2),
    }


@pytest.mark.parametrize("name", sorted(_bmp_cases()))
def test_bmp_assembled_equals_pil_and_cv2(tmp_path, name):
    path = tmp_path / f"{name}.bmp"
    path.write_bytes(_bmp_cases()[name])
    _check_both(path)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_written_by_pil_equals_pil_and_cv2(tmp_path, mode):
    img = Image.fromarray(_texture(4, 23, 37))
    img = img.quantize(40) if mode == "P" else img.convert(mode)
    img.save(tmp_path / "x.bmp")
    _check_both(tmp_path / "x.bmp")


def test_bmp_rle4_odd_absolute_runs_equal_cv2(tmp_path):
    """An absolute run of an odd number of pixels at a row's end: PIL reads
    its last pixel otherwise, cv2 and the port as the format says."""
    rng = _rng(5)
    idx = rng.randint(0, 16, (11, 19))
    pal = [tuple(rng.randint(0, 256, 3)) for _ in range(16)]
    (tmp_path / "x.bmp").write_bytes(_bmp(19, 11, 4, _rle4(idx, 7), pal, comp=2))
    before = native.calls["bmp_rle"]
    np.testing.assert_array_equal(imread_rgb(tmp_path / "x.bmp"), _cv2_rgb(tmp_path / "x.bmp"))
    assert native.calls["bmp_rle"] == before + 1


# ----------------------------------------------------------------- TIFF

def _tiff_arrays():
    rng = _rng(6)
    return {"L": rng.randint(0, 256, (21, 30)).astype(np.uint8),
            "RGB": rng.randint(0, 256, (21, 30, 3)).astype(np.uint8),
            "RGBA": rng.randint(0, 256, (21, 30, 4)).astype(np.uint8),
            "I;16": rng.randint(0, 65536, (21, 30)).astype(np.uint16)}


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_tiff_written_by_pil_equals_pil_and_cv2(tmp_path, mode, compression):
    Image.fromarray(_tiff_arrays()[mode]).save(tmp_path / "x.tif", compression=compression)
    _check_both(tmp_path / "x.tif")


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "gray16", "rgba8"])
def test_tiff_written_by_cv2_lzw_predictor_equals_pil_and_cv2(tmp_path, kind):
    """cv2.imwrite's TIFF: LZW with the horizontal predictor (tag 317 = 2)."""
    rng = _rng(7)
    img = {"rgb8": rng.randint(0, 256, (17, 29, 3)).astype(np.uint8),
           "rgb16": rng.randint(0, 65536, (17, 29, 3)).astype(np.uint16),
           "gray16": rng.randint(0, 65536, (17, 29)).astype(np.uint16),
           "rgba8": rng.randint(0, 256, (17, 29, 4)).astype(np.uint8)}[kind]
    assert cv2.imwrite(str(tmp_path / "x.tif"), img)
    assert Image.open(tmp_path / "x.tif").tag_v2.get(317) == 2
    _check_both(tmp_path / "x.tif")


def _tiled_tiff(img, tile, compression, predictor=1, big_endian=False):
    """An 8-bit chunky TIFF of img in tiles (uncompressed or Deflate)."""
    e = ">" if big_endian else "<"
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w, c)
    tiles = []
    for y0 in range(0, h, tile[0]):
        for x0 in range(0, w, tile[1]):
            t = np.zeros((tile[0], tile[1], c), np.uint8)
            part = x[y0:y0 + tile[0], x0:x0 + tile[1]]
            t[:part.shape[0], :part.shape[1]] = part
            if predictor == 2:
                t = np.diff(t.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
            raw = t.tobytes()
            tiles.append(zlib.compress(raw) if compression == 8 else raw)
    entries = {256: (3, [w]), 257: (3, [h]), 258: (3, [8] * c), 259: (3, [compression]),
               262: (3, [1 if c == 1 else 2]), 277: (3, [c]), 284: (3, [1]), 317: (3, [predictor]),
               322: (3, [tile[1]]), 323: (3, [tile[0]])}
    head = 8
    n_tags = len(entries) + 2
    data_at = head + 2 + 12 * n_tags + 4
    blobs = b""
    values = {}
    for tag, (typ, vals) in entries.items():
        if len(vals) > 2:
            values[tag] = (typ, len(vals), data_at + len(blobs))
            blobs += struct.pack(e + "H" * len(vals), *vals)
        else:
            values[tag] = (typ, len(vals), vals)
    offsets, at = [], data_at + len(blobs) + 8 * len(tiles)
    for t in tiles:
        offsets.append(at)
        at += len(t)
    values[324] = (4, len(tiles), data_at + len(blobs))
    blobs += struct.pack(e + "I" * len(tiles), *offsets)
    values[325] = (4, len(tiles), data_at + len(blobs))
    blobs += struct.pack(e + "I" * len(tiles), *map(len, tiles))
    out = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "I", head)
    out += struct.pack(e + "H", n_tags)
    for tag in sorted(values):
        typ, count, v = values[tag]
        if isinstance(v, list):
            field = struct.pack(e + "H" * len(v), *v).ljust(4, b"\x00")
        else:
            field = struct.pack(e + "I", v)
        out += struct.pack(e + "HHI", tag, typ, count) + field
    return out + struct.pack(e + "I", 0) + blobs + b"".join(tiles)


@pytest.mark.parametrize("compression,predictor", [(1, 1), (8, 1), (8, 2)])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
def test_tiff_tiles_equal_pil_and_cv2(tmp_path, compression, predictor, channels, big_endian):
    img = _texture(8, 37, 45)
    img = img[..., 0] if channels == 1 else img
    (tmp_path / "x.tif").write_bytes(_tiled_tiff(img, (16, 32), compression, predictor,
                                                 big_endian))
    _check_both(tmp_path / "x.tif")
    np.testing.assert_array_equal(read_image_u8(tmp_path / "x.tif"),
                                  img if channels == 3 else np.repeat(img[..., None], 3, 2))


def test_tiff_white_is_zero_equals_pil_and_cv2(tmp_path):
    """Photometric 0 (white is zero): both libraries invert the gray."""
    img = _texture(18, 37, 45)[..., 0]
    data = bytearray(_tiled_tiff(img, (16, 32), 1))
    (n,) = struct.unpack("<H", data[8:10])
    at = next(10 + 12 * i for i in range(n)
              if struct.unpack("<H", data[10 + 12 * i:12 + 12 * i])[0] == 262)
    data[at + 8:at + 10] = struct.pack("<H", 0)
    (tmp_path / "x.tif").write_bytes(bytes(data))
    _check_both(tmp_path / "x.tif")
    np.testing.assert_array_equal(imread_rgb(tmp_path / "x.tif")[..., 0], 255 - img)


def test_tiff_reads_natively_and_counts(tmp_path):
    Image.fromarray(_tiff_arrays()["RGB"]).save(tmp_path / "l.tif", compression="tiff_lzw")
    Image.fromarray(_tiff_arrays()["RGB"]).save(tmp_path / "p.tif", compression="packbits")
    before = dict(native.calls)
    read_image_u8(tmp_path / "l.tif")
    read_image_u8(tmp_path / "p.tif")
    assert native.calls["tiff_lzw"] == before["tiff_lzw"] + 1
    assert native.calls["tiff_packbits"] == before["tiff_packbits"] + 1


# ---------------------------------------------------- cv2's imread rules

def _exif(orientation) -> bytes:
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_equals_cv2(tmp_path, orientation):
    Image.fromarray(_texture(9, 40, 64)).save(tmp_path / "x.jpg", quality=90,
                                              exif=_exif(orientation))
    got = imread_rgb(tmp_path / "x.jpg")
    np.testing.assert_array_equal(got, _cv2_rgb(tmp_path / "x.jpg"))
    assert got.shape == ((64, 40, 3) if orientation > 4 else (40, 64, 3))
    np.testing.assert_array_equal(read_image_u8(tmp_path / "x.jpg"),
                                  np.asarray(Image.open(tmp_path / "x.jpg").convert("RGB")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_equals_cv2(tmp_path, orientation):
    Image.fromarray(_texture(10, 21, 34)).save(tmp_path / "x.png", exif=_exif(orientation))
    np.testing.assert_array_equal(imread_rgb(tmp_path / "x.png"), _cv2_rgb(tmp_path / "x.png"))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_as_cv2_reads_it(tmp_path, orientation):
    """cv2 flips a TIFF for orientations 2-4 and fails to read 5-8; the port
    reads the first and raises for the rest; read_image_u8 (PIL) takes 1."""
    Image.fromarray(_texture(11, 21, 34)).save(tmp_path / "x.tif", exif=_exif(orientation))
    want = _cv2_rgb(tmp_path / "x.tif")
    if orientation <= 4:
        np.testing.assert_array_equal(imread_rgb(tmp_path / "x.tif"), want)
    else:
        assert want is None
        with pytest.raises(ValueError, match=f"TIFF orientation {orientation}"):
            imread_rgb(tmp_path / "x.tif")
    if orientation > 1:
        with pytest.raises(ValueError, match="orientation"):
            read_image_u8(tmp_path / "x.tif")


def _png_cases():
    rng = _rng(12)
    g16 = (rng.rand(9, 14) * 65535).astype(np.uint16)
    pal = Image.fromarray(_texture(13, 9, 14)).quantize(16)
    cases = {
        "gray16": lambda p: Image.fromarray(g16).save(p),
        "rgb16": lambda p: cv2.imwrite(str(p), rng.randint(0, 65536, (9, 14, 3)).astype(
            np.uint16)),
        "rgba16": lambda p: cv2.imwrite(str(p), rng.randint(0, 65536, (9, 14, 4)).astype(
            np.uint16)),
        "gray_alpha": lambda p: Image.fromarray(rng.randint(0, 256, (9, 14, 2)).astype(np.uint8),
                                                "LA").save(p),
        "rgba": lambda p: Image.fromarray(rng.randint(0, 256, (9, 14, 4)).astype(
            np.uint8)).save(p),
        "palette_trns": lambda p: pal.save(p, transparency=3),
        "bits1": lambda p: Image.fromarray(rng.rand(9, 14) > 0.5).save(p),
        "gray8": lambda p: Image.fromarray(rng.randint(0, 256, (9, 14)).astype(np.uint8)).save(p),
    }
    return cases


@pytest.mark.parametrize("kind", ["gray16", "rgb16", "rgba16", "gray_alpha", "rgba",
                                  "palette_trns", "bits1", "gray8"])
def test_png_equals_cv2(tmp_path, kind):
    _png_cases()[kind](tmp_path / "x.png")
    np.testing.assert_array_equal(imread_rgb(tmp_path / "x.png"), _cv2_rgb(tmp_path / "x.png"))


@pytest.mark.parametrize("depth", [2, 4])
def test_png_low_bit_gray_equals_cv2(tmp_path, depth):
    """2- and 4-bit gray, assembled with struct and zlib (PIL writes none)."""
    rng = _rng(14 + depth)
    v = rng.randint(0, 1 << depth, (7, 13))
    bits = (v[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    rows = np.packbits(bits.reshape(7, -1).astype(np.uint8), axis=1)
    raw = np.concatenate([np.zeros((7, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 13, 7, depth, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    (tmp_path / "x.png").write_bytes(png)
    np.testing.assert_array_equal(imread_rgb(tmp_path / "x.png"), _cv2_rgb(tmp_path / "x.png"))


@pytest.mark.parametrize("name", ["cmyk_q90.jpg", "ycck_q90.jpg", "progressive_420_q90.jpg"])
def test_jpeg_fixtures_equal_cv2(name):
    from pathlib import Path
    path = Path(__file__).resolve().parent / "data" / name
    np.testing.assert_array_equal(imread_rgb(path), _cv2_rgb(path))


def test_gray_jpeg_equals_cv2(tmp_path):
    Image.fromarray(_texture(15, 19, 27)[..., 0]).save(tmp_path / "x.jpg")
    np.testing.assert_array_equal(imread_rgb(tmp_path / "x.jpg"), _cv2_rgb(tmp_path / "x.jpg"))


# -------------------------------------------------------------- refused

def _webp_inter_frame(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", quality=80)
    data = bytearray(buf.getvalue())
    data[data.index(b"VP8 ") + 8] |= 1  # the frame tag's inter-frame bit
    return bytes(data)


def _refused_files(tmp_path):
    """WebP, JPEG 2000, PNM and GIF are read since
    (tests/test_torch_image_formats_more.py): their entries are variants
    PIL and cv2 refuse (or cv2 misreads), which the port refuses naming
    the format."""
    img = _texture(16, 16, 16)
    pil = lambda fmt, **kw: (lambda p: Image.fromarray(img).save(p, fmt, **kw))  # noqa: E731
    return {
        "WebP": ("x.webp", lambda p: p.write_bytes(_webp_inter_frame(img))),
        "JPEG 2000": ("x.jp2", lambda p: Image.fromarray(_texture(16, 37, 53)).save(
            p, "JPEG2000", precinct_size=(16, 16))),  # 6 resolutions reach exponent 0
        "PNM": ("x.pam", lambda p: p.write_bytes(
            b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 4\nMAXVAL 255\nTUPLTYPE RGB_ALPHA\nENDHDR\n"
            + bytes(8))),
        "GIF": ("x.gif", lambda p: p.write_bytes(
            b"GIF89a" + struct.pack("<HHBBB", 16, 16, 0x80, 0, 0) + bytes(6) + b"\x3b")),
        "Radiance HDR": ("x.hdr", lambda p: cv2.imwrite(str(p), img.astype(np.float32) / 255)),
        "OpenEXR": ("x.exr", lambda p: p.write_bytes(b"\x76\x2f\x31\x01" + bytes(64))),
        "16-bit BMP": ("x.bmp", lambda p: p.write_bytes(_bmp(4, 4, 16, bytes(32)))),
        "CMYK": ("x.tif", lambda p: Image.fromarray(img).convert("CMYK").save(p)),
        "JPEG compression": ("y.tif", pil("TIFF", compression="jpeg")),
        "32-bit TIFF": ("z.tif", lambda p: Image.fromarray(
            img[..., 0].astype(np.float32)).save(p)),
    }


@pytest.mark.parametrize("fmt", ["WebP", "JPEG 2000", "PNM", "GIF", "Radiance HDR", "OpenEXR",
                                 "16-bit BMP", "CMYK", "JPEG compression", "32-bit TIFF"])
def test_what_the_port_does_not_read_raises_naming_it(tmp_path, fmt):
    name, write = _refused_files(tmp_path)[fmt]
    write(tmp_path / name)
    for read in (imread_rgb, read_image_u8):
        with pytest.raises(ValueError, match=fmt):
            read(tmp_path / name)


@pytest.mark.parametrize("kind", ["bmp", "tiff_rgb", "tiff_gray", "tiff_no_predictor"])
def test_the_ports_writers_read_back_by_pil_and_cv2(tmp_path, kind):
    """io.encode_bmp and io.encode_tiff (the LZW encoder of the host
    library), the scene writers' formats: PIL, cv2 and the port read back
    the pixels written."""
    from mvsformerplusplus_tpu_torch.data.io import encode_bmp, encode_tiff

    img = _texture(17, 70, 45)
    data = {"bmp": lambda: encode_bmp(img), "tiff_rgb": lambda: encode_tiff(img, 16),
            "tiff_gray": lambda: encode_tiff(img[..., 1], 32),
            "tiff_no_predictor": lambda: encode_tiff(img, 200, predictor=1)}[kind]()
    path = tmp_path / ("x.bmp" if kind == "bmp" else "x.tif")
    path.write_bytes(data)
    want = np.repeat(img[..., 1:2], 3, 2) if kind == "tiff_gray" else img
    _check_both(path)
    np.testing.assert_array_equal(read_image_u8(path), want)
