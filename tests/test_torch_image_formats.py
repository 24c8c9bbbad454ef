"""The JPEG and PNG files PIL reads in the JAX package and the port used to
refuse, each read by the port (data/io.py, data/jpeg.py, the host
library) against the JAX package's PIL reads: `read_image` against the
JAX `read_image` (PIL's convert("RGB")), `read_png` against
np.asarray(PIL.Image.open(f)) (the JAX DTU mask read), and the decoded
JPEG against np.asarray(PIL.Image.open(f)). Tolerance: none.

- progressive JPEG (SOF2), as PIL and cv2 write it: gray, 4:4:4, 4:2:2,
  4:2:0, optimised tables, restart intervals, sizes no multiple of the
  MCU; the native decoder against the numpy one, also on truncated files
  and random byte flips of the scans (the same pixels or the same error);
- 4-component JPEG: Adobe CMYK (transform 0) as PIL writes it, and the
  same file marked YCCK (transform 2), which libjpeg converts;
- PNG at bit depths 1, 2 and 4 (gray and palette) and 16 (gray, gray +
  alpha, RGB, RGBA), with and without tRNS, and Adam7-interlaced files at
  every depth, assembled here with struct and zlib;
- what PIL refuses or the port does not read (lossless and
  arithmetic-coded JPEG, WebP, PNM, GIF) raises ValueError naming it (BMP
  and TIFF are read since, tests/test_torch_imread.py);
- the committed fixtures of chip_smoke.py's host_codec phase
  (tests/data/) decode natively and by numpy to the PIL pixels stored
  beside them.
"""
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from mvsformerplusplus_tpu.data.io import read_image as jax_read_image
from mvsformerplusplus_tpu_torch.data import jpeg, native
from mvsformerplusplus_tpu_torch.data.io import read_image, read_image_u8, read_png


def _texture(seed, h, w, c=3):
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, c), np.ones((8, 8, 1)))[:h, :w]
    return (base * 200 + rng.rand(h, w, c) * 55).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _check_jpeg(data: bytes, tmp_path):
    """native = numpy = PIL's pixels, read_image = the JAX read_image."""
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(jpeg.decode_native(data), want)
    np.testing.assert_array_equal(jpeg.decode(data), want)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_image(path), jax_read_image(path))


# ------------------------------------------------------- progressive JPEG

@pytest.mark.parametrize("size", [(97, 131), (16, 16), (5, 3), (33, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["gray", "444", "422", "420"])
def test_progressive_matches_pil(tmp_path, sampling, quality, size):
    img = _texture(quality + size[0], *size)
    kw = dict(quality=quality, progressive=True)
    if sampling == "gray":
        data = _pil_jpeg(img[..., 1], **kw)
    else:
        data = _pil_jpeg(img, subsampling={"444": 0, "422": 1, "420": 2}[sampling], **kw)
    assert b"\xff\xc2" in data
    before = native.calls["jpeg_decode_progressive"]
    _check_jpeg(data, tmp_path)
    assert native.calls["jpeg_decode_progressive"] > before


@pytest.mark.parametrize("interval", [0, 1, 5])
def test_progressive_optimised_and_restarts_match_pil(tmp_path, interval):
    img = _texture(interval, 61, 90)
    _check_jpeg(_pil_jpeg(img, quality=85, progressive=True, optimize=True), tmp_path)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    data = enc.tobytes()
    assert ok and b"\xff\xc2" in data and (b"\xff\xdd" in data) == (interval > 0)
    _check_jpeg(data, tmp_path)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


def _same_outcome(data: bytes, tmp_path):
    """read_image_u8 (native) and the numpy decoder: the same pixels or the
    same ValueError text."""
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    want = _outcome(jpeg.decode, data, str(path))
    got = _outcome(read_image_u8, path)
    if isinstance(want, str):
        assert got == want
    else:
        want = np.repeat(want[..., None], 3, axis=2) if want.ndim == 2 else want
        np.testing.assert_array_equal(got, want)
    return want


def test_progressive_truncated_and_bad_parameters_raise_as_numpy(tmp_path):
    data = _pil_jpeg(_texture(1, 40, 48), quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) > 4
    for cut in (sos[1] + 30, sos[3] + 20, len(data) - 40):
        assert "corrupt or truncated" in _same_outcome(data[:cut], tmp_path)
    bad = bytearray(data)
    n = int.from_bytes(bad[sos[-1] + 2:sos[-1] + 4], "big")
    bad[sos[-1] + 2 + n - 3] = 0  # the last scan's Ss: 0 with Se > 0
    assert "invalid progressive JPEG scan parameters" in _same_outcome(bytes(bad), tmp_path)


@pytest.mark.parametrize("seed", range(4))
def test_progressive_byte_flips_behave_as_numpy(tmp_path, seed):
    """Random bytes of the scans replaced: the native decoder gives the
    numpy decoder's pixels or raises its error, in every scan kind."""
    rng = np.random.RandomState(seed)
    img = _texture(seed, 24, 40)
    data = _pil_jpeg(img, quality=75, progressive=True, subsampling=2 if seed % 2 else 0)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    outcomes = set()
    for _ in range(30):
        bad = bytearray(data)
        start = sos[rng.randint(len(sos))] + 14
        for i in rng.randint(start, len(data) - 2, rng.randint(1, 3)):
            bad[i] = rng.choice([0x00, 0x7F, 0xFE, rng.randint(0, 0xFF)])
        out = _same_outcome(bytes(bad), tmp_path)
        outcomes.add(out if isinstance(out, str) else "pixels")
    assert "pixels" in outcomes and len(outcomes) > 1


# --------------------------------------------------------- CMYK and YCCK

def _as_ycck(data: bytes) -> bytes:
    """The file with its Adobe APP14 transform set to 2 (YCCK)."""
    bad = bytearray(data)
    bad[data.index(b"Adobe") + 11] = 2
    return bytes(bad)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(40, 56), (17, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_and_ycck_match_pil(tmp_path, size, progressive):
    cmyk = _texture(size[0], *size, c=4)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=90, progressive=progressive)
    data = buf.getvalue()
    assert data[data.index(b"Adobe") + 11] == 0
    for d in (data, _as_ycck(data)):
        assert Image.open(io.BytesIO(d)).mode == "CMYK"
        _check_jpeg(d, tmp_path)
    assert not np.array_equal(jpeg.decode(data), jpeg.decode(_as_ycck(data)))


# -------------------------------------------------------------------- PNG

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _pack_rows(samples: np.ndarray, depth: int, filt: int, seed: int) -> bytes:
    """[h, w, c] samples -> the filtered rows of one (sub-)image, every row
    with filter type filt (4: Paeth), or each row a random type (filt -1)."""
    h, w, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = ((samples.reshape(h, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    bpp = max(1, c * depth // 8)
    types = (np.random.RandomState(seed).randint(0, 5, h) if filt < 0 else np.full(h, filt))
    x = np.zeros((h + 1, rows.shape[1] + bpp), np.int64)
    x[1:, bpp:] = rows
    a, b, cc = x[1:, :-bpp], x[:-1, bpp:], x[:-1, :-bpp]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(a), a, b, (a + b) // 2, paeth]
    out = b""
    for r in range(h):
        t = int(types[r])
        out += bytes([t]) + ((x[r + 1, bpp:] - preds[t][r]) % 256).astype(np.uint8).tobytes()
    return out


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _png(samples: np.ndarray, depth: int, ctype: int, interlace=False, extra=b"", filt=-1):
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(_pack_rows(samples[y0::dy, x0::dx], depth, filt, k)
                       for k, (y0, x0, dy, dx) in enumerate(ADAM7)
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _pack_rows(samples, depth, filt, 9)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _check_png(data: bytes, tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(data)
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(path), jax_read_image(path))


CASES = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4), (3, 8), (0, 8), (0, 16), (4, 8),
         (4, 16), (2, 8), (2, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("size", [(13, 11), (1, 1), (9, 30)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ctype,depth", CASES, ids=lambda v: str(v))
def test_png_depths_and_adam7_match_pil(tmp_path, ctype, depth, size, interlace):
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(depth * 7 + ctype + size[1])
    top = (1 << depth) if ctype != 3 else min(1 << depth, 20)
    samples = rng.randint(0, top, (*size, c)).astype(np.int64)
    samples.flat[:4] = [0, top - 1, 255 % top, 256 % top][:samples.size]
    extra = b""
    if ctype == 3:
        extra = _chunk(b"PLTE", rng.randint(0, 256, 60).astype(np.uint8).tobytes())
    _check_png(_png(samples, depth, ctype, interlace, extra), tmp_path)


@pytest.mark.parametrize("ctype,depth", [(0, 2), (0, 8), (0, 16), (2, 8), (2, 16), (3, 4)],
                         ids=lambda v: str(v))
def test_png_trns_changes_nothing_pil_returns(tmp_path, ctype, depth):
    c = {0: 1, 2: 3, 3: 1}[ctype]
    rng = np.random.RandomState(depth + ctype)
    top = 1 << depth if ctype != 3 else 16
    samples = rng.randint(0, top, (6, 7, c)).astype(np.int64)
    if ctype == 3:
        extra = (_chunk(b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes())
                 + _chunk(b"tRNS", bytes([0, 128, 255])))
    else:
        extra = _chunk(b"tRNS", b"".join(struct.pack(">H", int(v)) for v in samples[0, 0]))
    assert Image.open(io.BytesIO(_png(samples, depth, ctype, extra=extra))).info["transparency"] \
        is not None
    _check_png(_png(samples, depth, ctype, extra=extra), tmp_path)


def test_png_written_by_pil_at_16_bits_and_interlaced(tmp_path):
    img = (np.random.RandomState(0).rand(21, 34) * 65535).astype(np.uint16)
    Image.fromarray(img).save(tmp_path / "g.png")
    _check_png((tmp_path / "g.png").read_bytes(), tmp_path)
    rgb = _texture(2, 21, 34)
    for mode in ("RGB", "L", "P", "1"):
        pil = Image.fromarray(rgb).convert(mode)
        buf = io.BytesIO()
        pil.save(buf, "PNG", interlace=1) if mode != "P" else pil.save(buf, "PNG")
        _check_png(buf.getvalue(), tmp_path)


# ---------------------------------------------------------- still refused

def test_what_the_port_does_not_read_names_its_format(tmp_path):
    img = _texture(0, 16, 16)
    base = _pil_jpeg(img, quality=90)
    for sof, kind in ((0xC3, "lossless"), (0xC9, "arithmetic-coded"),
                      (0xC5, "hierarchical")):
        i = base.index(b"\xff\xc0")
        (tmp_path / "x.jpg").write_bytes(base[:i + 1] + bytes([sof]) + base[i + 2:])
        with pytest.raises(ValueError, match=kind):
            read_image(tmp_path / "x.jpg")
    i = base.index(b"\xff\xc0")
    (tmp_path / "x.jpg").write_bytes(base[:i + 4] + b"\x0c" + base[i + 5:])
    with pytest.raises(ValueError, match="12-bit JPEG"):
        read_image(tmp_path / "x.jpg")
    for fmt, ext in (("WebP", "webp"), ("PNM", "ppm"), ("GIF", "gif")):
        Image.fromarray(img).save(tmp_path / f"x.{ext}")
        with pytest.raises(ValueError, match=fmt):
            read_image(tmp_path / f"x.{ext}")


# ---------------------------------------------------------------- fixtures

FIXTURES = Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("name", ["progressive_420_q90.jpg", "cmyk_q90.jpg", "ycck_q90.jpg",
                                  "gray16.png", "rgb16_adam7.png", "gray4_adam7.png"])
def test_fixtures_decode_to_the_stored_pil_pixels(name):
    path = FIXTURES / name
    want = np.load(FIXTURES / (name + ".npy"))
    np.testing.assert_array_equal(want, np.asarray(Image.open(path)))
    if name.endswith(".jpg"):
        got = [jpeg.decode_native(path.read_bytes()), jpeg.decode(path.read_bytes())]
    else:
        got = [read_png(path), read_png(path, plain=True)]
    for g in got:
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(read_image(path), jax_read_image(path))


def test_large_progressive_fixture_matches_its_pil_hash():
    (name, meta), = json.loads((FIXTURES / "image_fixtures.json").read_text()).items()
    data = (FIXTURES / name).read_bytes()
    pixels = np.ascontiguousarray(jpeg.decode_native(data))
    assert list(pixels.shape) == meta["shape"]
    assert hashlib.sha256(pixels.tobytes()).hexdigest() == meta["sha256"]
    assert hashlib.sha256(np.asarray(Image.open(io.BytesIO(data))).tobytes()).hexdigest() == \
        meta["sha256"]
