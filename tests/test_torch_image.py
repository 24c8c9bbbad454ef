"""The port's numpy stand-ins for PIL and OpenCV (data/io.py's PNG codec,
data/image.py's resizes and HSV conversions) against PIL and cv2 here: the
PNG pixels bit-equal to PIL's on PNGs that PIL writes (every colour type
and every row filter; the other bit depths and interlacing in
test_torch_image_formats.py), the nearest resize and the HSV conversions
bit-equal to cv2, the area resize within 1e-6 of cv2 at the shrink factors
pre_resize gives (0.45-1.0). The area resize enlarging (either axis):
uint8 bit-equal to cv2, float32 within 1e-6; and the DINOv2 matcher on an
image smaller than its working size, which both tools enlarge, against the
JAX tool."""
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from mvsformerplusplus_tpu_torch.data.image import (hsv_to_rgb_u8, resize_area, resize_nearest,
                                                    rgb_to_hsv_u8)
from mvsformerplusplus_tpu_torch.data.io import read_image, read_png, write_png


def _texture(rng, h, w, c):
    """Blocky 8-bit content with noisy rows, so PIL's adaptive filtering
    picks the Sub, Up and Paeth filters."""
    base = rng.rand(h // 6 + 1, w // 6 + 1, c)
    smooth = np.kron(base, np.ones((6, 6, 1)))[:h, :w]
    noise = rng.rand(h, w, c) * (rng.rand(h, 1, 1) < 0.3)
    return (np.clip(smooth + 0.2 * noise, 0, 1) * 255).astype(np.uint8)


def _row_filters(path):
    """The filter byte of every row of a PNG (single-IDAT-stream decode)."""
    data = path.read_bytes()
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            ihdr = data[pos + 8:pos + 8 + n]
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h = int.from_bytes(ihdr[:4], "big"), int.from_bytes(ihdr[4:8], "big")
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ihdr[9]]
    raw = zlib.decompress(b"".join(idat))
    return {raw[r * (w * bpp + 1)] for r in range(h)}


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4), ("P", 3)])
def test_png_matches_pil(tmp_path, mode, channels):
    rng = np.random.RandomState(len(mode))
    arr = _texture(rng, 45, 67, channels)
    img = Image.fromarray(arr[..., 0] if channels == 1 else arr)
    if mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE, colors=200)
    filters = set()
    for i, opts in enumerate(({}, {"optimize": True}, {"compress_level": 1})):
        path = tmp_path / f"{mode}{i}.png"
        img.save(path, **opts)
        filters |= _row_filters(path)
        pil = Image.open(path)
        want = np.asarray(pil)
        got = read_png(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_image(path),
                                      np.asarray(pil.convert("RGB"), np.float32) / 255.0)
    if mode != "P":
        assert filters >= {1, 2, 4}, filters  # Sub, Up and Paeth rows were decoded


def _encode_filtered(arr, filters):
    """A PNG of uint8 [H, W, C] whose row r is filtered with filters[r % 5],
    written pixel by pixel from the PNG specification's definitions."""
    h, w, c = arr.shape
    x = arr.astype(np.int64)
    raw = bytearray()
    for r in range(h):
        f = filters[r % len(filters)]
        raw.append(f)
        for i in range(w * c):
            px, ch = divmod(i, c)
            a = x[r, px - 1, ch] if px else 0
            b = x[r - 1, px, ch] if r else 0
            cc = x[r - 1, px - 1, ch] if r and px else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            pred = [0, a, b, (a + b) // 2, paeth][f]
            raw.append((x[r, px, ch] - pred) % 256)

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, ctype, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_every_row_filter(tmp_path, channels):
    """Rows filtered None, Sub, Up, Average and Paeth in turn (PIL's encoder
    never picks Average) decode to the image, and PIL agrees."""
    arr = _texture(np.random.RandomState(channels + 10), 21, 17, channels)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_filtered(arr, [0, 1, 2, 3, 4]))
    assert _row_filters(path) == {0, 1, 2, 3, 4}
    want = arr[..., 0] if channels == 1 else arr
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(read_png(path), want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_write_png_reads_back_in_pil(tmp_path, channels):
    arr = _texture(np.random.RandomState(channels), 23, 31, channels)
    arr = arr[..., 0] if channels == 1 else arr
    write_png(tmp_path / "x.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")), arr)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), arr)


def test_unsupported_files_name_their_format(tmp_path):
    """Progressive, 16-bit and interlaced files are read (tests/
    test_torch_image_formats.py); what stays refused names itself: an
    arithmetic-coded progressive JPEG, a 16-bit palette PNG and an unknown
    interlace method, none of them a file PIL reads."""
    arr = _texture(np.random.RandomState(0), 16, 16, 3)
    Image.fromarray(arr).save(tmp_path / "x.jpg", quality=90, progressive=True)
    data = (tmp_path / "x.jpg").read_bytes()
    i = data.index(b"\xff\xc2")
    (tmp_path / "x.jpg").write_bytes(data[:i + 1] + b"\xca" + data[i + 2:])  # SOF10
    with pytest.raises(ValueError, match="progressive JPEG"):
        read_image(tmp_path / "x.jpg")

    def patched(data, offset, value):
        data = bytearray(data)
        data[offset] = value
        data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
        return bytes(data)

    write_png(tmp_path / "x.png", arr[..., 0])
    png = (tmp_path / "x.png").read_bytes()
    (tmp_path / "x16.png").write_bytes(patched(patched(png, 24, 16), 25, 3))  # 16-bit palette
    with pytest.raises(ValueError, match="16-bit"):
        read_image(tmp_path / "x16.png")
    (tmp_path / "xi.png").write_bytes(patched(png, 28, 2))  # IHDR interlace method 2
    with pytest.raises(ValueError, match="interlaced"):
        read_image(tmp_path / "xi.png")


def test_resizes_match_cv2():
    rng = np.random.RandomState(0)
    worst = 0.0
    for trial in range(40):
        h, w = rng.randint(40, 220), rng.randint(40, 300)
        scale = 0.5 if trial < 2 else rng.uniform(0.45, 1.0)
        if trial < 2:
            h, w = 2 * (h // 2), 2 * (w // 2)
        nh, nw = int(h * scale), int(w * scale)
        for c in (3, 1):
            img = (rng.rand(h, w, c) * 255).astype(np.uint8).astype(np.float32) / 255
            img = img[..., 0] if c == 1 else img
            got = resize_area(img, nh, nw)
            want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
            assert got.shape == want.shape and got.dtype == np.float32
            worst = max(worst, float(np.abs(got - want).max()))
            np.testing.assert_array_equal(
                resize_nearest(img, nh, nw), cv2.resize(img, (nw, nh),
                                                        interpolation=cv2.INTER_NEAREST))
    assert worst <= 1e-6, worst


def test_hsv_conversions_match_cv2():
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (1 << 20, 1, 3)).astype(np.uint8)
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 5)] * 3, indexing="ij"), -1)
    rgb = np.concatenate([rgb, grid.reshape(-1, 1, 3).astype(np.uint8)])
    np.testing.assert_array_equal(rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rgb_to_hsv_u8(rgb)
    hsv[..., 0] = rng.randint(0, 180, hsv.shape[:2])
    # one-pixel rows (OpenCV's scalar loop) and 1000-pixel rows (its vector
    # loop, then a scalar tail of 8 pixels)
    for img in (hsv, hsv[:len(hsv) // 1000 * 1000].reshape(-1, 1000, 3)):
        np.testing.assert_array_equal(hsv_to_rgb_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))
        np.testing.assert_array_equal(rgb_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("src,dst", [((20, 30), (41, 67)), ((37, 23), (74, 46)), ((5, 7), (160, 9)),
                                     ((64, 48), (90, 30)), ((48, 64), (20, 200)),
                                     ((100, 140), (154, 210)), ((1, 3), (2, 3))],
                         ids=["up", "up2x", "up_tall", "mixed_y_up", "mixed_x_up", "matcher",
                              "one_axis"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_area_enlarging_matches_cv2(src, dst, channels):
    """OpenCV's INTER_AREA on its linear path with area weights whenever an
    axis enlarges: uint8 bit for bit, float32 in [0, 1] within 1e-6."""
    rng = np.random.RandomState(src[0] * 7 + channels)
    img = rng.randint(0, 256, src + (channels,)).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    got = resize_area(img, *dst)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))
    f = img.astype(np.float32) / 255
    got = resize_area(f, *dst)
    want = cv2.resize(f, dst[::-1], interpolation=cv2.INTER_AREA)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_matcher_enlarges_small_images_as_the_jax_tool():
    """A 98 x 140 pair, under the 154 x 210 working size: both tools enlarge
    it (INTER_AREA) and find the same matches (the same A-side patches,
    points within 1e-3 px) with the same DINOv2-B weights (params=)."""
    import jax
    import jax.numpy as jnp
    import torch

    from mvsformerplusplus_tpu.models.dino import DinoVisionTransformer as JaxViT
    from mvsformerplusplus_tpu_torch.tools import dino_match
    from tools.dino_match import make_dino_matcher as jax_make_dino_matcher

    h, w = 154, 210
    params = jax.jit(JaxViT().init)(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)))["params"]
    cells = np.random.RandomState(3).randint(0, 255, (7, 10, 3), np.uint8)
    a = np.kron(cells, np.ones((14, 14, 1), np.uint8))  # 98 x 140
    b = np.roll(a, 14, axis=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = dino_match.make_dino_matcher(long_side=w, params=params, device="cpu")(a, b)
    finally:
        torch.set_num_threads(threads)
    want = jax_make_dino_matcher(long_side=w, params=params)(a, b)
    assert len(want[0]) >= 20 and len(got[0]) == len(want[0])
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, x, atol=1e-3, rtol=0)
