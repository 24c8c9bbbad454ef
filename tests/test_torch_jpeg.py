"""The port's numpy JPEG codec (mvsformerplusplus_tpu_torch/data/jpeg.py)
against the libraries the JAX package uses: the decoder against PIL (the
JAX package's read_image), bit for bit, on baseline files PIL and cv2
write (qualities 50-97, grayscale, 4:4:4, 4:2:2, 4:2:0, sizes that are no
multiple of the MCU, restart intervals); the encoder against cv2.imwrite
(test.py's writer of the reference images): PIL's decode of the port's file
equals PIL's decode of cv2's, bit for bit. Tolerance: none (exact)."""
import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mvsformerplusplus_tpu_torch.data import jpeg
from mvsformerplusplus_tpu_torch.data.io import read_image, read_image_u8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZES = [(97, 131), (16, 16), (5, 3)]
QUALITIES = [50, 75, 90, 95, 97]
SAMPLING = {"444": 0, "422": 1, "420": 2}


def _texture(seed, h, w):
    """Blocky colour with fine noise: every coefficient band occupied."""
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, 3), np.ones((8, 8, 1)))[:h, :w]
    return (base * 200 + rng.rand(h, w, 3) * 55).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("sampling", ["gray", "444", "422", "420"])
def test_decode_matches_pil(sampling, quality, size):
    img = _texture(quality + size[0], *size)
    if sampling == "gray":
        data = _pil_jpeg(img[..., 1], quality=quality)
    else:
        data = _pil_jpeg(img, quality=quality, subsampling=SAMPLING[sampling])
    np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data))


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("size", [(97, 131), (48, 96)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_restart_intervals_match_pil(size, interval):
    """cv2 with IMWRITE_JPEG_RST_INTERVAL: a DRI segment and RSTn markers
    every `interval` MCUs (the DC predictors reset at each)."""
    img = _texture(interval, *size)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    data = enc.tobytes()
    assert ok and b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(jpeg.decode(data), _pil_decode(data))


def test_read_image_takes_jpeg_as_pil_converts_it(tmp_path):
    """read_image dispatches on the signature; a grayscale JPEG comes out
    replicated to RGB, as PIL's convert("RGB") gives it."""
    img = _texture(3, 40, 56)
    (tmp_path / "c.jpg").write_bytes(_pil_jpeg(img, quality=90))
    (tmp_path / "g.jpg").write_bytes(_pil_jpeg(img[..., 0], quality=90))
    for name in ("c.jpg", "g.jpg"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        np.testing.assert_array_equal(read_image_u8(tmp_path / name), want)
        np.testing.assert_array_equal(read_image(tmp_path / name),
                                      np.asarray(want, np.float32) / 255.0)


def _pil_refuses(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data)).load()
    except Exception:
        return True
    return False


@pytest.mark.parametrize("kind,kw", [("progressive", dict(progressive=True)),
                                     ("CMYK", dict(mode="CMYK"))])
def test_unsupported_jpeg_raises_naming_it(kind, kw):
    """Progressive and CMYK files are read (tests/test_torch_image_formats.py),
    arithmetic-coded progressive ones too since (SOF10,
    tests/test_torch_image_formats_more.py); the variants the decoder still
    refuses, as PIL does, name themselves: hierarchical progressive (SOF6)
    and a CMYK file sampled 4:1:1."""
    img = Image.fromarray(_texture(0, 24, 24))
    if kw.pop("mode", None):
        img = img.convert("CMYK")
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc2" if kind == "progressive" else b"\xff\xc0")
    if kind == "progressive":
        data[sof + 1] = 0xC6
        assert _pil_refuses(bytes(data))
    else:
        data[sof + 11] = 0x41  # the first component 4 x 1
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(ValueError, match=kind):
            decode(bytes(data))


@pytest.mark.parametrize("size", SIZES + [(1, 1), (33, 17)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_encode_decodes_as_cv2_imwrite(quality, size):
    """The port's file and cv2.imwrite's at the same quality (4:2:0,
    standard tables) decode to the same pixels: the quantized coefficients
    agree."""
    img = _texture(quality * 7 + size[1], *size)
    ok, ref = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    np.testing.assert_array_equal(_pil_decode(jpeg.encode(img, quality)),
                                  _pil_decode(ref.tobytes()))


def test_encode_tables_are_pil_and_cv2_baseline_tables():
    """The standard Huffman tables the encoder writes are the ones PIL's
    and cv2's libjpeg write (read back from a PIL file's DHT segments)."""
    data = _pil_jpeg(_texture(1, 16, 16), quality=95)
    seen = {}
    pos = 2
    while True:
        marker, _, body, pos = jpeg._next_marker(data, pos, "pil")
        if marker == 0xDA:
            break
        i = 0
        while marker == 0xC4 and i < len(body):
            n = sum(body[i + 1:i + 17])
            seen[body[i]] = (bytes(body[i + 1:i + 17]), bytes(body[i + 17:i + 17 + n]))
            i += 17 + n
    assert seen == {0x00: jpeg._DC_LUMA, 0x10: jpeg._AC_LUMA, 0x01: jpeg._DC_CHROMA,
                    0x11: jpeg._AC_CHROMA}
