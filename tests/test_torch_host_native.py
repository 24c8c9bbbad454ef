"""The port's host library (data/native.py, csrc/host/*.cpp), built here
with g++, against its plain versions and the JAX package's libraries, on
the CPU. Tolerance: none (bit for bit) unless a case says otherwise.

- fastio: every entry point equals the JAX package's data/native.py (its
  committed native/libfastio.so) bit for bit, and the port's numpy: bit
  for bit with the gamma off; with it on numpy's float32 power is not
  glibc's powf (about 16% of the values a float32 ulp apart), so within
  1e-6 there.
- JPEG decode: native = numpy = PIL pixels for gray, 4:4:4, 4:2:2 and
  4:2:0 at qualities 50/95/100 and sizes no multiple of the MCU, with
  restart intervals (DRI), and as SOF1.
- JPEG encode: native bytes = numpy `encode`'s bytes; cv2 decodes them to
  what it decodes cv2.imwrite's file to.
- PNG: a file per row filter 0-4 and PIL-written photos: native = numpy
  `_unfilter` = PIL.
- Errors: a truncated scan, a bad Huffman code and random byte flips in
  the scan raise the numpy decoder's ValueError text through
  read_image_u8 (or give its pixels); a progressive file gives its pixels
  (PIL's).
- Four threads decoding different files at once give the same pixels.
- A build with CXX pointed at a missing compiler raises; nothing falls
  back.
- DecodedImages decodes outside its lock, each file once.
- The ported input-pipeline bench prints the JAX tool's keys.
"""
import ctypes
import io
import json
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from PIL import Image

from mvsformerplusplus_tpu.data import native as jax_native
from mvsformerplusplus_tpu_torch.data import io as port_io
from mvsformerplusplus_tpu_torch.data import jpeg, native, transforms
from mvsformerplusplus_tpu_torch.data.io import DecodedImages, read_image_u8


def _texture(seed, h, w, c=3):
    """Blocky colour with fine noise: every coefficient band occupied."""
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, c), np.ones((8, 8, 1)))[:h, :w]
    return (base * 200 + rng.rand(h, w, c) * 55).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


# ------------------------------------------------------------------ fastio

@pytest.mark.parametrize("gamma", [0.0, 1.0, 1.05, 0.93])
@pytest.mark.parametrize("crop", [(0, 0, 96, 128), (5, 7, 64, 96), (31, 2, 1, 3)])
def test_crop_normalize_matches_jax_and_numpy(crop, gamma):
    img = np.random.RandomState(int(gamma * 100) + crop[0]).rand(96, 128, 3).astype(np.float32)
    got = native.crop_normalize(img, *crop, gamma=gamma)
    np.testing.assert_array_equal(got, jax_native.crop_normalize(img, *crop, gamma=gamma))
    plain = transforms.crop_normalize(img, *crop, gamma=gamma)
    if gamma in (0.0, 1.0):
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gamma", [0.0, 1.07])
def test_batch_crop_normalize_matches_jax_library(gamma):
    """The fourth C entry point (no Python caller: the JAX module binds it
    neither), threaded, against the JAX library's and crop_normalize."""
    rng = np.random.RandomState(3)
    imgs = rng.rand(5, 40, 56, 3).astype(np.float32)
    oys, oxs = rng.randint(0, 9, 5).astype(np.int32), rng.randint(0, 17, 5).astype(np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    got, want = np.empty((2, 5, 32, 40, 3), np.float32)
    for lib, out in ((native.load(), got), (jax_native._load(), want)):
        lib.batch_crop_normalize_f32(
            imgs.ctypes.data_as(f32p), 5, 40, 56, oys.ctypes.data_as(i32p),
            oxs.ctypes.data_as(i32p), 32, 40, ctypes.c_float(gamma), out.ctypes.data_as(f32p), 3)
    np.testing.assert_array_equal(got, want)
    for i in range(5):
        np.testing.assert_array_equal(got[i], native.crop_normalize(imgs[i], oys[i], oxs[i], 32, 40,
                                                                    gamma))


@pytest.mark.parametrize("shape", [(33, 44, 3), (256,), (7, 5)])
def test_u8_to_f32_matches_jax(shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    got = native.u8_to_f32(img)
    np.testing.assert_array_equal(got, jax_native.u8_to_f32(img))
    np.testing.assert_array_equal(got, img.astype(np.float32) * np.float32(1 / 255))


@pytest.mark.parametrize("shape", [(64, 96), (512, 640), (48, 40)])
def test_stage_pyramid_matches_jax_and_numpy(shape):
    arr = np.random.RandomState(2).rand(*shape).astype(np.float32)
    got = native.stage_pyramid_native(arr)
    want, plain = jax_native.stage_pyramid_native(arr), transforms.stage_pyramid(arr)
    assert set(got) == set(want) == set(plain)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], plain[k])


def test_crop_outside_the_image_raises():
    with pytest.raises(ValueError, match="outside the image"):
        native.crop_normalize(np.zeros((8, 8, 3), np.float32), 4, 0, 8, 8)


# ------------------------------------------------------------- JPEG decode

def _as_sof1(data: bytes) -> bytes:
    """The same file marked extended sequential (SOF1), which decodes alike."""
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + b"\xc1" + data[i + 2:]


@pytest.mark.parametrize("size", [(97, 131), (16, 16), (5, 3), (33, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", ["gray", "444", "422", "420"])
def test_decode_matches_numpy_and_pil(sampling, quality, size):
    img = _texture(quality + size[0], *size)
    if sampling == "gray":
        data = _pil_jpeg(img[..., 1], quality=quality)
    else:
        data = _pil_jpeg(img, quality=quality, subsampling={"444": 0, "422": 1, "420": 2}[sampling])
    want = _pil(data)
    for d in (data, _as_sof1(data)):
        np.testing.assert_array_equal(jpeg.decode_native(d), want)
        np.testing.assert_array_equal(jpeg.decode(d), want)


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("size", [(97, 131), (48, 96)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_restart_intervals_match_numpy_and_pil(size, interval):
    img = _texture(interval, *size)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    data = enc.tobytes()
    assert ok and b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(jpeg.decode_native(data), _pil(data))
    np.testing.assert_array_equal(jpeg.decode_native(data), jpeg.decode(data))


def test_read_image_u8_decodes_natively(tmp_path):
    img = _texture(5, 40, 56)
    (tmp_path / "c.jpg").write_bytes(_pil_jpeg(img, quality=90))
    before = dict(native.calls), dict(native.plain_calls)
    want = np.asarray(Image.open(tmp_path / "c.jpg").convert("RGB"))
    np.testing.assert_array_equal(read_image_u8(tmp_path / "c.jpg"), want)
    assert native.calls["jpeg_decode_scan"] == before[0]["jpeg_decode_scan"] + 1
    assert native.calls["jpeg_reconstruct"] == before[0]["jpeg_reconstruct"] + 1
    assert native.plain_calls == before[1]


# ------------------------------------------------------------- JPEG encode

@pytest.mark.parametrize("size", [(97, 131), (16, 16), (5, 3), (1, 1), (33, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [1, 50, 95, 100])
def test_encode_bytes_equal_numpy(quality, size):
    img = _texture(quality * 7 + size[1], *size)
    got = jpeg.encode_native(img, quality)
    assert got == jpeg.encode(img, quality)
    ok, ref = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR),
                                  cv2.imdecode(ref, cv2.IMREAD_COLOR))


def test_write_jpeg_writes_the_native_bytes(tmp_path):
    img = _texture(9, 40, 72)
    before = native.calls["jpeg_encode"], native.plain_calls["jpeg_encode"]
    jpeg.write_jpeg(tmp_path / "x.jpg", img, quality=97)
    assert (tmp_path / "x.jpg").read_bytes() == jpeg.encode(img, 97)
    assert native.calls["jpeg_encode"] == before[0] + 1


# --------------------------------------------------------------------- PNG

def _filtered_png(arr, f):
    """A PNG of uint8 [H, W, C] with every row filtered by type f, written
    from the PNG specification's definitions."""
    h, w, c = arr.shape
    x = np.zeros((h + 1, (w + 1) * c), np.int64)
    x[1:, c:] = arr.reshape(h, w * c)
    a, b, cc = x[1:, :-c], x[:-1, c:], x[:-1, :-c]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    pred = [0, a, b, (a + b) // 2, paeth][f]
    rows = np.concatenate([np.full((h, 1), f), (x[1:, c:] - pred) % 256], axis=1)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, ctype, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + port_io._chunk(b"IHDR", ihdr)
            + port_io._chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes()))
            + port_io._chunk(b"IEND", b""))


def _rows(data: bytes):
    """The raw rows of a single-IDAT-stream PNG: [H, 1 + W bpp], bpp."""
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            hdr = data[pos + 8:pos + 8 + n]
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[hdr[9]]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw[:h * (w * bpp + 1)].reshape(h, -1), bpp


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4])
def test_png_filter_matches_numpy_and_pil(tmp_path, row_filter, channels):
    arr = _texture(row_filter * 5 + channels, 21, 17, channels)
    data = _filtered_png(arr, row_filter)
    rows, bpp = _rows(data)
    assert set(rows[:, 0].tolist()) == {row_filter}
    got = native.png_unfilter(rows, bpp)
    np.testing.assert_array_equal(got, port_io._unfilter(rows[:, 0], rows[:, 1:], bpp))
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got.reshape(arr.shape), want.reshape(arr.shape))
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(port_io.read_png(tmp_path / "f.png"), want)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_png_pil_photos_match_numpy_and_pil(tmp_path, mode):
    y, x = np.mgrid[:60, :80]
    rng = np.random.RandomState(len(mode))
    img = np.stack([np.sin(x / 7) * 90 + 120, np.cos(y / 9) * 80 + 100, (x + y) * 1.5,
                    x * 3.0], -1) + rng.randn(60, 80, 4) * 6
    img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img).convert(mode) if mode != "P" else Image.fromarray(
        img[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=100)
    pil.save(tmp_path / "p.png")
    rows, bpp = _rows((tmp_path / "p.png").read_bytes())
    got = native.png_unfilter(rows, bpp)
    np.testing.assert_array_equal(got, port_io._unfilter(rows[:, 0], rows[:, 1:], bpp))
    want = np.asarray(Image.open(tmp_path / "p.png"))
    np.testing.assert_array_equal(port_io.read_png(tmp_path / "p.png"), want)
    np.testing.assert_array_equal(read_image_u8(tmp_path / "p.png"),
                                  np.asarray(Image.open(tmp_path / "p.png").convert("RGB")))


def test_write_png_paeth_reads_back(tmp_path):
    arr = _texture(4, 31, 45)
    port_io.write_png(tmp_path / "p.png", arr, row_filter=4)
    rows, _ = _rows((tmp_path / "p.png").read_bytes())
    assert set(rows[:, 0].tolist()) == {4}
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")), arr)
    np.testing.assert_array_equal(read_image_u8(tmp_path / "p.png"), arr)


def test_unknown_png_filter_raises_as_numpy(tmp_path):
    data = bytearray(_filtered_png(_texture(2, 6, 5), 2))
    rows, bpp = _rows(bytes(data))
    rows = rows.copy()
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="PNG: unknown row filter 5"):
        port_io._unfilter(rows[:, 0], rows[:, 1:], bpp)
    ihdr = data[:33]
    (tmp_path / "f.png").write_bytes(bytes(ihdr) + port_io._chunk(
        b"IDAT", zlib.compress(rows.tobytes())) + port_io._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="PNG: unknown row filter 5"):
        read_image_u8(tmp_path / "f.png")


# ------------------------------------------------------------------ errors

def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


def _same_outcome(data: bytes, tmp_path):
    """read_image_u8 (native) and the numpy decoder on one file: the same
    pixels or the same ValueError text."""
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


def test_progressive_truncated_and_bad_code_raise_as_numpy(tmp_path):
    img = _texture(0, 40, 48)
    progressive = _pil_jpeg(img, progressive=True)
    np.testing.assert_array_equal(_same_outcome(progressive, tmp_path), _pil(progressive))
    data = _pil_jpeg(img, quality=90)
    sos = data.index(b"\xff\xda")
    assert "corrupt or truncated" in _same_outcome(data[:sos + 40], tmp_path)
    bad = bytearray(data)
    bad[sos + 14:sos + 20] = b"\xff\x00" * 3  # all-ones bits: no Huffman code
    assert "corrupt or truncated" in _same_outcome(bytes(bad), tmp_path)


@pytest.mark.parametrize("seed", range(4))
def test_scan_byte_flips_behave_as_numpy(tmp_path, seed):
    """Random bytes of the entropy-coded data replaced: each file decodes
    to the numpy decoder's pixels or raises its error (an invalid code, a
    read past the end, AC coefficients past a block's end)."""
    rng = np.random.RandomState(seed)
    img = _texture(seed, 24, 40)
    data = _pil_jpeg(img, quality=75, subsampling=2 if seed % 2 else 0)
    sos = data.index(b"\xff\xda") + 14
    for _ in range(25):
        bad = bytearray(data)
        for i in rng.randint(sos, len(data) - 2, rng.randint(1, 4)):
            bad[i] = rng.choice([0x00, 0x7F, 0xFE, rng.randint(0, 0xFF)])
        _same_outcome(bytes(bad), tmp_path)


# ----------------------------------------------------------------- threads

def test_four_threads_decode_as_one(tmp_path):
    paths = []
    for i in range(8):
        p = tmp_path / (f"{i}.jpg" if i % 2 else f"{i}.png")
        img = _texture(i, 120 + 8 * i, 160)
        if i % 2:
            p.write_bytes(_pil_jpeg(img, quality=90, subsampling=2))
        else:
            port_io.write_png(p, img, row_filter=4)
        paths.append(p)
    want = [read_image_u8(p) for p in paths]
    with ThreadPoolExecutor(4) as pool:
        for _ in range(3):
            for got, w in zip(pool.map(read_image_u8, paths), want):
                np.testing.assert_array_equal(got, w)


def test_missing_compiler_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    img = _texture(1, 16, 16)
    (tmp_path / "x.jpg").write_bytes(_pil_jpeg(img))
    port_io.write_png(tmp_path / "x.png", img)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    before = dict(native.plain_calls)
    for name in ("x.jpg", "x.png"):
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            read_image_u8(tmp_path / name)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.crop_normalize(np.zeros((4, 4, 3), np.float32), 0, 0, 4, 4)
    assert native.plain_calls == before


# ---------------------------------------------------------- DecodedImages

def test_decoded_images_decode_outside_the_lock(monkeypatch):
    """Two threads asking for two paths decode at once (each waits at a
    barrier the other must reach); two asking for one path decode it once."""
    barrier = threading.Barrier(2, timeout=10)
    calls = []

    def fake_read(path):
        calls.append(str(path))
        if str(path).startswith("pair"):
            barrier.wait()  # raises BrokenBarrierError if the decodes were serialised
        else:
            threading.Event().wait(0.2)
        return np.full((2, 2, 3), len(calls), np.uint8)

    monkeypatch.setattr(port_io, "read_image_u8", fake_read)
    cache = DecodedImages(8)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(cache.get, ["pair_a", "pair_b"]))
    assert sorted(calls) == ["pair_a", "pair_b"] and cache.decodes == 2
    with ThreadPoolExecutor(2) as pool:
        got = list(pool.map(cache.get, ["same", "same"]))
    assert calls.count("same") == 1 and cache.decodes == 3
    assert got[0] is got[1] and not got[0].flags.writeable
    assert cache.get("same") is got[0] and cache.decodes == 3


# -------------------------------------------------------------------- bench

def test_bench_input_pipeline_prints_the_jax_tools_keys(capsys, monkeypatch):
    import sys

    from mvsformerplusplus_tpu_torch.tools import bench_input_pipeline as port_bench
    from tools import bench_input_pipeline as jax_bench

    argv = ["--h", "600", "--w", "800", "--scans", "1", "--steps", "2", "--step-ms", "50",
            "--num-workers", "2"]
    before = native.calls["png_unfilter"], native.plain_calls["png_unfilter"]
    got = port_bench.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert native.calls["png_unfilter"] > before[0] and native.plain_calls["png_unfilter"] == \
        before[1]
    monkeypatch.setattr(sys, "argv", ["bench_input_pipeline.py"] + argv)
    jax_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["protocol"] == want["protocol"] and got["consumer_step_ms"] == 50
