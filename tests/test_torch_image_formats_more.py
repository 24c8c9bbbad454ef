"""The images PIL and OpenCV read and the port used to refuse: arithmetic-
coded and lossless JPEG (data/jpeg.py, csrc/host/jpeg.cpp), PNM
(data/pnm.py), GIF (data/gif.py), WebP (data/webp.py, csrc/host/webp.cpp)
and JPEG 2000 (data/jpeg2000.py, csrc/host/jpeg2000.cpp). Each file goes
through `read_image_u8` against PIL's `convert("RGB")` and through
`imread_rgb` against `cv2.imread(f)[..., ::-1]`, bit for bit, or both
raise where the reader they follow refuses the file. Tolerance: none.

The files come from the writers PIL and cv2 link: PIL's own savers, and
where they do not reach a variant, the same libraries through ctypes
(libjpeg-turbo via tests/data/make_jpeg_f4.c for arithmetic and lossless
JPEG; libwebp's advanced encoder for the loop-filter type, sharpness,
segments and token partitions; OpenJPEG's encoder for every code-block
style and SOP / EPH markers), or are assembled here (PNM, GIF with frame
offsets and local tables, a JP2 palette, an animated WebP whose first frame
does not cover the canvas). For JPEG the numpy decoder equals the native
one, also on truncated files and byte flips (the same pixels or the same
error). One planted fault per decoder (a coefficient, an LZW code, an MQ
or boolean-coded byte) must change the pixels. A scan of WebP and JPEG
2000 views reads in EvalDataset as in the JAX package's (PIL).
"""
import ctypes
import glob
import io
import os
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

import PIL
from mvsformerplusplus_tpu.data.eval_dataset import EvalDataset as JaxEvalDataset
from mvsformerplusplus_tpu_torch.data import jpeg, jpeg2000, native, webp
from mvsformerplusplus_tpu_torch.data.eval_dataset import EvalDataset
from mvsformerplusplus_tpu_torch.data.io import (DecodedImages, imread_rgb, read_image,
                                                 read_image_u8)
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_geometric_eval_scan

LIBS = Path(PIL.__file__).parents[1] / "pillow.libs"
FIXTURES = Path(__file__).resolve().parent / "data"


def _texture(seed, h, w, c=3):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([np.sin(x / (4.0 + k) + k) * 70 + np.cos(y / (3.0 + k)) * 40 + 120
                     for k in range(c)], -1)
    return np.clip(base + rng.randn(h, w, c) * 14, 0, 255).astype(np.uint8)


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # PIL refuses
        return None


def _cv2(data: bytes, path=None):
    """cv2.imread (from `path`, which holds `data`; imdecode where there is
    none) as RGB, or None where it refuses."""
    img = (cv2.imread(str(path), cv2.IMREAD_COLOR) if path is not None
           else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return None if img is None else img[..., ::-1]


def _check(data: bytes, tmp_path, name="x.img"):
    """read_image_u8 = PIL, imread_rgb = cv2.imread, or ValueError where
    each refuses; read_image = read_image_u8 / 255."""
    path = tmp_path / name
    path.write_bytes(data)
    for reader, want in ((read_image_u8, _pil(data)), (imread_rgb, _cv2(data, path))):
        if want is None:
            with pytest.raises(ValueError):
                reader(path)
        else:
            got = reader(path)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    if _pil(data) is not None:
        np.testing.assert_array_equal(read_image(path), read_image_u8(path) / np.float32(255))


# ------------------------------------------------------------------ PNM

def _pnm(kind: int, values: np.ndarray, maxval: int, comment=b"# made here\n") -> bytes:
    h, w = values.shape[:2]
    head = f"P{kind}\n".encode() + comment + f"{w} {h}\n".encode()
    if kind not in (1, 4):
        head += f"{maxval}\n".encode()
    if kind == 4:
        return head + np.packbits(values.astype(np.uint8), axis=1).tobytes()
    if kind in (1, 2, 3):
        sep = "" if kind == 1 else " "
        return head + sep.join(map(str, values.ravel().tolist())).encode() + b"\n"
    return head + values.astype(">u2" if maxval > 255 else np.uint8).tobytes()


@pytest.mark.parametrize("maxval", [1, 15, 100, 255, 256, 1000, 4095, 65535])
@pytest.mark.parametrize("kind", [2, 3, 5, 6])
def test_pnm_gray_and_rgb_at_every_maxval(tmp_path, kind, maxval):
    """PIL scales to 8 bits (16-bit gray through mode I, saturated); cv2
    scales plain 8-bit samples only and shifts 16-bit ones down."""
    rng = np.random.RandomState(kind * 7 + maxval % 97)
    shape = (7, 11, 3) if kind in (3, 6) else (7, 11)
    values = rng.randint(0, maxval + 1, shape)
    values.reshape(-1)[:4] = [0, maxval, maxval // 2, maxval // 3]
    _check(_pnm(kind, values, maxval), tmp_path)


@pytest.mark.parametrize("kind", [1, 4])
@pytest.mark.parametrize("size", [(5, 9), (13, 16), (1, 1)])
def test_pbm_bitmaps(tmp_path, kind, size):
    bits = np.random.RandomState(size[1]).randint(0, 2, size)
    _check(_pnm(kind, bits, 1), tmp_path)


def test_pnm_written_by_pil_and_cv2(tmp_path):
    img = _texture(1, 19, 23)
    for mode in ("RGB", "L", "1"):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "PPM")
        _check(buf.getvalue(), tmp_path)
    for ext in (".ppm", ".pgm", ".pbm"):
        ok, enc = cv2.imencode(ext, img[..., ::-1] if ext == ".ppm" else img[..., 0])
        assert ok
        _check(enc.tobytes(), tmp_path)


@pytest.mark.parametrize("tupl,depth,maxval", [("GRAYSCALE", 1, 255), ("GRAYSCALE", 1, 1000),
                                               ("RGB", 3, 100), ("RGB", 3, 65535),
                                               ("GRAYSCALE_ALPHA", 2, 255),
                                               ("RGB_ALPHA", 4, 255), ("BLACKANDWHITE", 1, 1)])
def test_pam_reads_as_cv2_and_pil_refuses_it(tmp_path, tupl, depth, maxval):
    """cv2 reads GRAYSCALE and RGB tuples; it misreads the others, which
    the port refuses naming them, as PIL refuses every PAM."""
    v = np.random.RandomState(depth).randint(0, maxval + 1, (5, 7, depth))
    data = (f"P7\nWIDTH 7\nHEIGHT 5\nDEPTH {depth}\nMAXVAL {maxval}\nTUPLTYPE {tupl}\n"
            "ENDHDR\n").encode() + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    if tupl in ("GRAYSCALE", "RGB"):
        _check(data, tmp_path)
        return
    assert _pil(data) is None
    for reader in (read_image_u8, imread_rgb):
        with pytest.raises(ValueError, match="PNM"):
            reader(_write(tmp_path, data))


@pytest.mark.parametrize("colour", [False, True])
def test_pfm_as_each_reader_reads_it(tmp_path, colour):
    """PIL reads the gray PFM (mode F, truncated to 0-255) and refuses the
    colour one; cv2 the opposite (rounded, saturated)."""
    f = (np.random.RandomState(2).rand(6, 9, 3 if colour else 1) * 300 - 20).astype("<f4")
    f[0, 0] = 0.5
    f[0, 1] = 254.5
    data = (b"PF" if colour else b"Pf") + b"\n9 6\n-1.0\n" + f.tobytes()
    _check(data, tmp_path)


# ------------------------------------------------------------------ GIF

def _lzw(idx: np.ndarray, mcs: int) -> bytes:
    """GIF LZW: codes LSB first, Clear first, widths growing as decoders
    expect, a Clear whenever the table fills."""
    clear, eoi = 1 << mcs, (1 << mcs) + 1
    out, acc, nbits, size = bytearray(), 0, 0, mcs + 1
    table, nxt = {}, eoi + 1

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    put(clear)
    cur = None
    for v in idx.ravel().tolist():
        if cur is None:
            cur = (v,)
            continue
        if cur + (v,) in table:
            cur = cur + (v,)
            continue
        put(cur[0] if len(cur) == 1 else table[cur])
        if nxt == (1 << size) and size < 12:
            size += 1
        if nxt < 4096:
            table[cur + (v,)] = nxt
            nxt += 1
        else:
            put(clear)
            table, nxt, size = {}, eoi + 1, mcs + 1
        cur = (v,)
    put(cur[0] if len(cur) == 1 else table[cur])
    if nxt == (1 << size) and size < 12:
        size += 1
    put(eoi)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _table(pal):
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    tab = np.zeros((1 << bits, 3), np.uint8)
    tab[:len(pal)] = pal
    return 0x80 | (bits - 1), tab.tobytes()


def _gif(screen, frame, global_pal=None, bg=0, left=0, top=0, local_pal=None, interlace=False,
         transparency=None, mcs=8) -> bytes:
    w, h = screen
    flags, table = _table(global_pal) if global_pal is not None else (0, b"")
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags | (0x70 if flags else 0), bg, 0) + table
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    fh, fw = frame.shape
    lflags, ltable = _table(local_pal) if local_pal is not None else (0, b"")
    out += b"\x2c" + struct.pack("<HHHHB", left, top, fw, fh, lflags | (0x40 if interlace else 0))
    rows = frame
    if interlace:
        rows = frame[[y for s, d in ((0, 8), (4, 8), (2, 4), (1, 2)) for y in range(s, fh, d)]]
    data = _lzw(rows, mcs)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return out + ltable + bytes([mcs]) + blocks + b"\x00\x3b"


GIF_CASES = {
    "plain": lambda r: _gif((30, 20), r.randint(0, 16, (20, 30)), r.randint(0, 256, (16, 3))),
    "interlaced": lambda r: _gif((33, 29), r.randint(0, 16, (29, 33)), r.randint(0, 256, (16, 3)),
                                 interlace=True),
    "mcs2": lambda r: _gif((30, 20), r.randint(0, 4, (20, 30)), r.randint(0, 256, (4, 3)), mcs=2),
    "mcs5": lambda r: _gif((30, 20), r.randint(0, 32, (20, 30)), r.randint(0, 256, (32, 3)),
                           mcs=5),
    "full_table": lambda r: _gif((130, 120), r.randint(0, 256, (120, 130)),
                                 r.randint(0, 256, (256, 3))),
    "offset_frame": lambda r: _gif((30, 20), r.randint(0, 8, (9, 11)), r.randint(0, 256, (16, 3)),
                                   bg=3, left=5, top=4),
    "offset_transparent": lambda r: _gif((30, 20), r.randint(0, 8, (9, 11)),
                                         r.randint(0, 256, (16, 3)), bg=3, left=5, top=4,
                                         transparency=5),
    "local_table": lambda r: _gif((30, 20), r.randint(0, 8, (9, 11)), r.randint(0, 256, (16, 3)),
                                  bg=3, left=5, top=4, transparency=5,
                                  local_pal=r.randint(0, 256, (8, 3))),
    "local_only": lambda r: _gif((30, 20), r.randint(0, 8, (9, 11)), None, left=5, top=4,
                                 local_pal=r.randint(0, 256, (8, 3))),
    "no_table": lambda r: _gif((30, 20), r.randint(0, 8, (9, 11)), None, left=5, top=4),
    "index_past_table": lambda r: _gif((30, 20), r.randint(0, 16, (20, 30)),
                                       r.randint(0, 256, (5, 3))),
    "background_past_table": lambda r: _gif((30, 20), r.randint(0, 4, (9, 11)),
                                            r.randint(0, 256, (4, 3)), bg=9, left=5, top=4,
                                            transparency=2),
    "frame_past_screen": lambda r: _gif((10, 8), r.randint(0, 8, (9, 11)),
                                        r.randint(0, 256, (16, 3)), left=5, top=4),
}


@pytest.mark.parametrize("case", list(GIF_CASES))
def test_gif_assembled_equals_pil_and_cv2(tmp_path, case):
    """Frames offset on the screen, local and missing tables, transparent
    indices, interlacing and every LZW width; cv2's refusals (an index past
    its table, a frame past the screen) and the file with no table at all,
    which cv2 misreads and the port refuses, raise."""
    data = GIF_CASES[case](np.random.RandomState(len(case)))
    if case == "no_table":
        np.testing.assert_array_equal(read_image_u8(_write(tmp_path, data)), _pil(data))
        with pytest.raises(ValueError, match="colour table"):
            imread_rgb(_write(tmp_path, data))
        return
    _check(data, tmp_path)


def _write(tmp_path, data, name="x.img"):
    (tmp_path / name).write_bytes(data)
    return tmp_path / name


@pytest.mark.parametrize("transparency", [None, 0, 7])
@pytest.mark.parametrize("size", [(15, 9), (40, 57)])
def test_gif_written_by_pil(tmp_path, size, transparency):
    """PIL's writer (interlaced from 16 pixels up) with a transparent index:
    PIL looks it up, cv2 shows the background colour there."""
    img = Image.fromarray(_texture(3, *size)).convert("P")
    kw = {} if transparency is None else dict(transparency=transparency)
    buf = io.BytesIO()
    img.save(buf, "GIF", **kw)
    _check(buf.getvalue(), tmp_path)
    buf = io.BytesIO()
    img.save(buf, "GIF", save_all=True, append_images=[img.rotate(90, expand=False)], **kw)
    _check(buf.getvalue(), tmp_path)


# ------------------------------------------------------------ JPEG, F4

@pytest.fixture(scope="module")
def f4_writer(tmp_path_factory):
    """tests/data/make_jpeg_f4.c built against PIL's libjpeg-turbo."""
    lib = glob.glob(str(LIBS / "libjpeg-*.so*"))[0]
    exe = tmp_path_factory.mktemp("f4") / "make_jpeg_f4"
    subprocess.run([os.environ.get("CC", "cc"), "-O1", "-o", str(exe),
                    str(FIXTURES / "make_jpeg_f4.c"), lib, f"-Wl,-rpath,{Path(lib).parent}"],
                   check=True)

    def write(img, *args):
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        out = exe.parent / "out.jpg"
        subprocess.run([str(exe), str(out), str(w), str(h), str(c), *map(str, args)],
                       input=np.ascontiguousarray(img).tobytes(), check=True)
        return out.read_bytes()
    return write


F4_CASES = {
    "arith_420": (3, ("arith",)),
    "arith_444_restart": (3, ("arith", 1, 0, 3)),
    "arith_422": (3, ("arith", 2, 0)),
    "arith_gray": (1, ("arith",)),
    "arith_dac": (3, ("arith", 0, 0x0A52, 0, 90)),
    "arith_q100_noise": (-3, ("arith", 0, 0, 0, 100)),
    "arith_q100_dac_noise": (-3, ("arith", 1, 0x0363, 2, 100)),
    "arith_progressive": (3, ("arith_prog",)),
    "arith_progressive_restart": (3, ("arith_prog", 0, 0, 2)),
    "arith_progressive_gray_dac": (1, ("arith_prog", 0, 0x0A52, 5)),
    "arith_progressive_q100_noise": (-3, ("arith_prog", 0, 0, 0, 100)),
    **{f"lossless_p{p}_pt{t}": (3, ("lossless", p, t)) for p in range(1, 8) for t in (0, 3)},
    "lossless_restart_noise": (-3, ("lossless", 4, 0, 61)),
    "lossless_gray_restart": (1, ("lossless", 6, 1, 122)),
    "lossless_ycc": (3, ("lossless", 1, 0, 0, 1)),
    "lossless_ycc420": (3, ("lossless", 5, 0, 0, 2)),
}


def _f4_file(f4_writer, case):
    c, args = F4_CASES[case]
    img = (np.random.RandomState(1).randint(0, 256, (45, 61, 3)).astype(np.uint8) if c < 0
           else _texture(5, 45, 61))
    return f4_writer(img[..., 0].copy() if c == 1 else img, *args)


@pytest.mark.parametrize("case", list(F4_CASES))
def test_arithmetic_and_lossless_jpeg_equal_pil_and_cv2(tmp_path, f4_writer, case):
    """numpy = native = PIL's np.asarray pixels, read_image_u8 = PIL's RGB,
    imread_rgb = cv2 (which refuses lossless gray)."""
    data = _f4_file(f4_writer, case)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(jpeg.decode_native(data), want)
    np.testing.assert_array_equal(jpeg.decode(data), want)
    _check(data, tmp_path)


def _same_result(data):
    """jpeg.decode and decode_native: the same pixels or the same error."""
    try:
        want = jpeg.decode(data)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            jpeg.decode_native(data)
        assert str(got.value) == str(e)
        return
    np.testing.assert_array_equal(jpeg.decode_native(data), want)


@pytest.mark.parametrize("case", ["arith_444_restart", "arith_progressive_restart",
                                  "lossless_restart_noise", "lossless_gray_restart"])
def test_f4_truncated_and_flipped_behave_as_numpy(f4_writer, case):
    data = _f4_file(f4_writer, case)
    for end in (len(data) // 3, len(data) // 2, len(data) - 40, len(data) - 2):
        _same_result(data[:end])
    start = data.index(b"\xff\xda")
    rng = np.random.RandomState(len(case))
    for _ in range(6):
        flipped = bytearray(data)
        at = int(rng.randint(start + 14, len(data) - 2))
        flipped[at] ^= 1 << int(rng.randint(8))
        _same_result(bytes(flipped))


def test_f4_planted_faults_change_the_pixels(f4_writer):
    """A coefficient off by one (arithmetic) and a difference off by one
    (lossless) change the decoded pixels: the equality checks above see a
    one-symbol fault."""
    data = _f4_file(f4_writer, "arith_420")
    want = np.asarray(Image.open(io.BytesIO(data)))
    coefs = []
    real = jpeg._reconstruct_native

    def spy(frame, comps, qt, c, *rest):
        c[64 * 5 + 1] += 1
        coefs.append(1)
        return real(frame, comps, qt, c, *rest)
    jpeg._reconstruct_native = spy
    try:
        assert not np.array_equal(jpeg.decode_native(data), want) and coefs
    finally:
        jpeg._reconstruct_native = real
    data = _f4_file(f4_writer, "lossless_p1_pt0")
    want = np.asarray(Image.open(io.BytesIO(data)))
    real_scan = jpeg._decode_lossless_scan

    def spy_scan(segments, bases, slots, step, tables, diffs, name, use_native):
        real_scan(segments, bases, slots, step, tables, diffs, name, use_native)
        diffs[bases[7]] += 1
    jpeg._decode_lossless_scan = spy_scan
    try:
        assert not np.array_equal(jpeg.decode(data), want)
    finally:
        jpeg._decode_lossless_scan = real_scan


@pytest.mark.parametrize("sof,kind", [(0xCB, "arithmetic-coded lossless"),
                                      (0xC7, "hierarchical lossless")])
def test_jpeg_processes_pil_refuses_raise(tmp_path, f4_writer, sof, kind):
    data = _f4_file(f4_writer, "lossless_p1_pt0")
    i = data.index(b"\xff\xc3")
    patched = data[:i + 1] + bytes([sof]) + data[i + 2:]
    assert _pil(patched) is None and _cv2(patched) is None
    for reader in (read_image_u8, imread_rgb):
        with pytest.raises(ValueError, match=kind):
            reader(_write(tmp_path, patched))


# ---------------------------------------------------------------- WebP

def _webp_lib():
    ctypes.CDLL(glob.glob(str(LIBS / "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(glob.glob(str(LIBS / "libwebp-*.so*"))[0])


_WEBP_FIELDS = ("lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
                "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                "show_compressed", "preprocessing", "partitions", "partition_limit",
                "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
                "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


class _WebPConfig(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR") else ctypes.c_int)
                for f in _WEBP_FIELDS] + [("pad", ctypes.c_uint32 * 8)]


class _MemWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def _libwebp_encode(img: np.ndarray, **config) -> bytes:
    """libwebp's WebPEncode with a WebPConfig (the fields PIL does not set:
    filter type and sharpness, segments, token partitions, alpha filter)."""
    lib = _webp_lib()
    cfg = _WebPConfig()
    assert any(lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75.0), v)
               for v in (0x20F, 0x210, 0x20E))
    assert (cfg.method, cfg.segments, cfg.filter_type) == (4, 4, 1)  # the layout holds
    for k, v in config.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg))
    pic = (ctypes.c_uint8 * 512)()
    assert lib.WebPPictureInitInternal(pic, 0x20F)
    h, w, c = img.shape
    ctypes.c_int.from_buffer(pic, 0).value = int(bool(config.get("lossless")))
    ctypes.c_int.from_buffer(pic, 8).value = w
    ctypes.c_int.from_buffer(pic, 12).value = h
    writer = _MemWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(lib.WebPMemoryWrite,
                                                             ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
    arr = np.ascontiguousarray(img)
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    assert importer(pic, arr.ctypes.data_as(ctypes.c_void_p), w * c)
    ok = lib.WebPEncode(ctypes.byref(cfg), pic)
    lib.WebPPictureFree(pic)
    assert ok
    return ctypes.string_at(writer.mem, writer.size)


def _pil_webp(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _with_alpha(img):
    a = np.full(img.shape[:2], 255, np.uint8)
    a[2:9, 3:20] = 0
    a[-6:, :] = np.random.RandomState(0).randint(0, 256, (min(6, a.shape[0]), a.shape[1]))
    return np.dstack([img, a])


WEBP_PIL = {
    **{f"lossy_q{q}": dict(quality=q) for q in (0, 10, 50, 75, 90, 100)},
    **{f"lossy_method{m}": dict(quality=60, method=m) for m in (0, 3, 6)},
    "lossless": dict(lossless=True),
    "lossless_q0_m0": dict(lossless=True, quality=0, method=0),
    "lossless_q100_m6": dict(lossless=True, quality=100, method=6),
    "lossy_alpha": dict(quality=80, alpha=True),
    "lossy_alpha_q50": dict(quality=80, alpha_quality=50, alpha=True),
    "lossless_alpha": dict(lossless=True, alpha=True),
    "lossless_alpha_exact": dict(lossless=True, exact=True, alpha=True),
}


@pytest.mark.parametrize("size", [(37, 53), (1, 1), (16, 17), (70, 31)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(WEBP_PIL))
def test_webp_written_by_pil_equals_pil_and_cv2(tmp_path, case, size):
    kw = dict(WEBP_PIL[case])
    img = _texture(7, *size)
    if kw.pop("alpha", False):
        img = _with_alpha(img)
    _check(_pil_webp(img, **kw), tmp_path)


@pytest.mark.parametrize("lossless", [False, True])
def test_animated_webp_reads_its_first_frame(tmp_path, lossless):
    img = _texture(8, 29, 41)
    frames = [Image.fromarray(img), Image.fromarray(img[::-1].copy())]
    for rgba in (False, True):
        fr = [Image.fromarray(_with_alpha(np.asarray(f))) for f in frames] if rgba else frames
        buf = io.BytesIO()
        fr[0].save(buf, "WEBP", save_all=True, append_images=fr[1:], lossless=lossless,
                   quality=70)
        _check(buf.getvalue(), tmp_path)


def test_animated_webp_first_frame_off_the_canvas_origin(tmp_path):
    """An ANMF frame at (6, 4) inside a larger canvas: transparent black
    around it, in PIL and cv2 alike."""
    small = _texture(9, 9, 13)
    for lossless in (True, False):
        inner = _pil_webp(small, lossless=lossless, quality=80)[12:]  # its VP8L / VP8 chunk

        def chunk(tag, body):
            return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")
        head = bytes([0x02, 0, 0, 0]) + (30).to_bytes(3, "little") + (22).to_bytes(3, "little")
        anmf = (b"".join(v.to_bytes(3, "little") for v in (3, 2, 12, 8, 100)) + b"\0" + inner)
        body = (b"WEBP" + chunk(b"VP8X", head) + chunk(b"ANIM", struct.pack("<IH", 0, 0))
                + chunk(b"ANMF", anmf))
        _check(b"RIFF" + struct.pack("<I", len(body)) + body, tmp_path)


LIBWEBP = {
    **{f"filter{ft}_sharp{sh}_parts{p}_seg{sg}": dict(filter_type=ft, filter_sharpness=sh,
                                                      partitions=p, segments=sg, quality=q)
       for ft, sh, p, sg, q in ((0, 0, 0, 4, 75), (0, 3, 2, 1, 30), (1, 7, 3, 4, 90),
                                (1, 5, 1, 2, 5), (0, 7, 3, 3, 50), (1, 2, 2, 4, 60))},
    "filter_off": dict(filter_strength=0, quality=100),
    "autofilter_sns100": dict(autofilter=1, sns_strength=100),
    "dithered_preprocessing": dict(preprocessing=2),
    "near_lossless60": dict(lossless=1, near_lossless=60),
    **{f"alpha_comp{c}_filter{f}_q{q}": dict(alpha_compression=c, alpha_filtering=f,
                                             alpha_quality=q, alpha=True)
       for c, f, q in ((0, 0, 100), (1, 0, 100), (1, 1, 100), (1, 2, 50), (0, 2, 100),
                       (1, 1, 10))},
}


@pytest.mark.parametrize("case", list(LIBWEBP))
def test_webp_loop_filters_partitions_and_alpha_filters(tmp_path, case):
    """libwebp's encoder with what PIL does not set: the simple and the
    normal loop filter at each sharpness, 1-8 token partitions, 1-4
    segments, raw and compressed alpha with each prediction filter."""
    kw = dict(LIBWEBP[case])
    img = _texture(10, 71, 97)
    if kw.pop("alpha", False):
        img = _with_alpha(img)
    _check(_libwebp_encode(img, **kw), tmp_path)


@pytest.mark.parametrize("ncolors", [2, 3, 5, 16, 40])
def test_webp_lossless_colour_indexing(tmp_path, ncolors):
    """Palettes of 2, 4, 16 and 256 entries pack 8, 4, 2 and 1 pixels per
    byte."""
    rng = np.random.RandomState(ncolors)
    pal = rng.randint(0, 256, (ncolors, 3)).astype(np.uint8)
    _check(_pil_webp(pal[rng.randint(0, ncolors, (23, 37))], lossless=True), tmp_path)


def test_webp_truncated_raises(tmp_path):
    for data in (_pil_webp(_texture(11, 40, 50), quality=70),
                 _pil_webp(_texture(11, 40, 50), lossless=True)):
        for end in (10, 30, len(data) // 2, len(data) - 1):
            assert _pil(data[:end]) is None
            with pytest.raises(ValueError):
                read_image_u8(_write(tmp_path, data[:end]))


def test_webp_planted_faults_change_the_pixels():
    """One flipped bit in the lossy token data and in the lossless
    entropy-coded data changes the pixels (or raises)."""
    img = _texture(12, 40, 50)
    for data in (_pil_webp(img, quality=90), _pil_webp(img, lossless=True)):
        want = webp.decode(data, "x")
        flipped = bytearray(data)
        flipped[len(data) * 2 // 3] ^= 0x10
        try:
            got = webp.decode(bytes(flipped), "x")
        except ValueError:
            continue
        assert not np.array_equal(got, want)


# ----------------------------------------------------------- JPEG 2000

def _pil_j2k(img, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


J2K_PIL = {
    "reversible": {},
    "irreversible": dict(irreversible=True),
    "raw_codestream": dict(no_jp2=True),
    "irreversible_raw": dict(irreversible=True, no_jp2=True),
    **{f"resolutions{n}": dict(num_resolutions=n) for n in (1, 2, 6)},
    "tiles": dict(tile_size=(16, 16)),
    "tiles_irreversible_layers": dict(tile_size=(24, 20), irreversible=True,
                                      quality_layers=[40, 10, 2]),
    "offset_tiles": dict(offset=(7, 9), tile_offset=(2, 3), tile_size=(16, 16)),
    "layers": dict(quality_layers=[40, 20, 10]),
    "layers_db": dict(quality_layers=[20, 30, 40], quality_mode="dB", irreversible=True),
    **{f"{p}_precincts": dict(progression=p, quality_layers=[30, 10], precinct_size=(32, 32),
                              num_resolutions=4, tile_size=(24, 20))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "codeblocks_8x16": dict(codeblock_size=(8, 16)),
    "codeblocks_4x4_irreversible": dict(codeblock_size=(4, 4), irreversible=True),
    "no_mct": dict(mct=0),
    "plt_comment": dict(plt=True, comment="port"),
    "signed": dict(signed=True),
}


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
@pytest.mark.parametrize("case", list(J2K_PIL))
def test_jpeg2000_written_by_pil_equals_pil_and_cv2(tmp_path, case, mode):
    """cv2 refuses signed samples, image offsets and gray raw codestreams;
    PIL reads them."""
    img = _texture(13, 37, 53, {"RGB": 3, "L": 1, "RGBA": 4, "LA": 2}[mode])
    img = img[..., 0] if mode == "L" else img
    _check(_pil_j2k(img, mode if mode == "LA" else None, **J2K_PIL[case]), tmp_path)


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (2, 2), (3, 17), (70, 45)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg2000_sizes(tmp_path, size):
    img = _texture(14, *size)
    # PIL's writer takes no more resolutions than the size allows, and its
    # 9/7 encoder asserts on one-sample signals
    nres = 1 + int(np.log2(min(size)))
    for kw in (dict(num_resolutions=1), dict(num_resolutions=nres),
               dict(num_resolutions=nres, irreversible=min(size) > 1)):
        _check(_pil_j2k(img, **kw), tmp_path)


def test_jpeg2000_16_bit_gray(tmp_path):
    """PIL's I;16 saturates at 255; cv2 shifts down 8 bits."""
    g = np.random.RandomState(15).randint(0, 65536, (23, 31)).astype(np.uint16)
    g[0, :4] = [0, 255, 256, 65535]
    for kw in ({}, dict(irreversible=True), dict(num_resolutions=3, quality_layers=[30, 10]),
               dict(no_jp2=True)):
        _check(_pil_j2k(g, "I;16", **kw), tmp_path)


def _with_precision(data: bytes, prec: int) -> bytes:
    """The codestream's SIZ rewritten to `prec` bits a sample (a valid
    stream: the tier-1 data do not depend on it)."""
    d = bytearray(data)
    i = d.index(b"\xff\x4f\xff\x51")
    for c in range(int.from_bytes(d[i + 40:i + 42], "big")):
        d[i + 42 + 3 * c] = prec - 1
    return bytes(d)


@pytest.mark.parametrize("prec", [1, 4, 7, 9, 12, 16])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_jpeg2000_precisions_as_each_reader_converts(tmp_path, prec, mode):
    """PIL shifts to 8 bits (rounding down-shifts; JP2's ihdr depth picks
    its mode, so a JP2 gray stays L), cv2 shifts down and refuses fewer than
    8 bits."""
    rng = np.random.RandomState(prec)
    img = rng.randint(0, 256, (20, 30) if mode == "L" else (20, 30, 3)).astype(np.uint8)
    for jp2 in (False, True):
        _check(_with_precision(_pil_j2k(img, no_jp2=not jp2, num_resolutions=2), prec), tmp_path)


def _openjpeg():
    return ctypes.CDLL(glob.glob(str(LIBS / "libopenjp2-*.so*"))[0])


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd", "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _OpjImage(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_ImageComp)),
        ("icc", ctypes.c_void_p), ("icc_len", ctypes.c_uint32)]


def _openjpeg_encode(tmp_path, planes, mode=0, csty=0, irreversible=False, layers=(30, 10, 1),
                     numres=4, cblk=(16, 16)) -> bytes:
    """OpenJPEG's encoder (opj_cparameters_t set from its defaults: the
    code-block style `mode`, SOP / EPH `csty`) on 8-bit components."""
    lib = _openjpeg()
    lib.opj_image_create.restype = ctypes.POINTER(_OpjImage)
    for fn in ("opj_create_compress", "opj_stream_create_default_file_stream"):
        getattr(lib, fn).restype = ctypes.c_void_p
    params = (ctypes.c_uint8 * (1 << 16))()
    lib.opj_set_default_encoder_parameters(params)
    ints = np.frombuffer(params, np.int32)
    floats = np.frombuffer(params, np.float32)
    at = next(i for i in range(len(ints) - 3) if tuple(ints[i:i + 3]) == (6, 64, 64))
    ints[at], ints[at + 1], ints[at + 2] = numres, cblk[0], cblk[1]
    ints[at + 3], ints[at + 4] = mode, int(irreversible)
    ints[12] = csty
    ints[at - 201] = len(layers)  # tcp_numlayers, then the rates
    floats[at - 200:at - 200 + len(layers)] = layers
    ints[5] = 1  # cp_disto_alloc
    h, w = planes[0].shape
    parms = (_CmptParm * len(planes))()
    for i in range(len(planes)):
        parms[i].dx = parms[i].dy = 1
        parms[i].w, parms[i].h, parms[i].prec, parms[i].bpp = w, h, 8, 8
    image = lib.opj_image_create(len(planes), parms, 1)
    image.contents.x1, image.contents.y1 = w, h
    for i, p in enumerate(planes):
        arr = np.ascontiguousarray(p, np.int32)
        ctypes.memmove(image.contents.comps[i].data, arr.ctypes.data, arr.nbytes)
    codec = ctypes.c_void_p(lib.opj_create_compress(0))
    assert lib.opj_setup_encoder(codec, params, image)
    path = tmp_path / "opj.j2k"
    stream = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(str(path).encode(), 0))
    ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
          and lib.opj_end_compress(codec, stream))
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    assert ok
    return path.read_bytes()


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("style", [0, 1, 2, 4, 8, 16, 32, 1 | 4, 1 | 2 | 8, 2 | 16 | 32,
                                   63, 1 | 32])
def test_jpeg2000_code_block_styles(tmp_path, style, irreversible):
    """Selective bypass (1), context reset (2), termination on each pass
    (4), vertically causal contexts (8), predictable termination (16) and
    segmentation symbols (32), alone and together, over three layers."""
    rng = np.random.RandomState(style)
    planes = [np.clip(_texture(16, 45, 61)[..., k].astype(int) + rng.randint(-20, 20, (45, 61)),
                      0, 255) for k in range(3)]
    _check(_openjpeg_encode(tmp_path, planes, mode=style, irreversible=irreversible), tmp_path)


@pytest.mark.parametrize("csty", [2, 4, 6])
def test_jpeg2000_sop_and_eph_markers(tmp_path, csty):
    planes = [_texture(17, 33, 47)[..., k] for k in range(3)]
    _check(_openjpeg_encode(tmp_path, planes, csty=csty), tmp_path)
    _check(_openjpeg_encode(tmp_path, planes, csty=csty, mode=1 | 4 | 32), tmp_path)


def _jp2_boxes(data):
    return jpeg2000._boxes(data, 0, len(data), "x")


def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def test_jpeg2000_palette(tmp_path):
    """A JP2 palette (pclr, cmap) over a gray codestream of indices: PIL's
    mode P, OpenJPEG's expansion in cv2."""
    rng = np.random.RandomState(18)
    index = rng.randint(0, 6, (21, 33)).astype(np.uint8)
    pal = rng.randint(0, 256, (6, 3)).astype(np.uint8)
    out = b""
    for kind, body in _jp2_boxes(_pil_j2k(index)):
        if kind == b"jp2h":
            inner = b""
            for k2, b2 in jpeg2000._boxes(body, 0, len(body), "x"):
                inner += _box(k2, bytes([1, 0, 0]) + struct.pack(">I", 16) if k2 == b"colr"
                              else b2)
            inner += _box(b"pclr", struct.pack(">HB", 6, 3) + bytes([7, 7, 7]) + pal.tobytes())
            inner += _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(3)))
            body = inner
        out += _box(kind, body)
    assert Image.open(io.BytesIO(out)).mode == "P"
    _check(out, tmp_path)
    np.testing.assert_array_equal(read_image_u8(_write(tmp_path, out)), pal[index])


def test_jpeg2000_missing_tile_stays_black(tmp_path):
    """A tile with no tile-part in the codestream is left at zero, as in the
    image OpenJPEG hands PIL."""
    data = _pil_j2k(_texture(22, 40, 40), tile_size=(32, 32), no_jp2=True)
    sots = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\x90"]
    cut = data[:sots[1]] + data[sots[2]:]
    assert _pil(cut)[0, 35].tolist() == [0, 0, 0]
    _check(cut, tmp_path)


def test_jpeg2000_refusals(tmp_path):
    """What PIL and cv2 refuse raises naming it: precincts of exponent 0
    above the lowest resolution (which OpenJPEG rejects) and truncated
    files."""
    img = _texture(19, 37, 53)
    data = _pil_j2k(img, precinct_size=(16, 16))
    assert _pil(data) is None and _cv2(data) is None
    with pytest.raises(ValueError, match="precinct"):
        read_image_u8(_write(tmp_path, data))
    for data in (_pil_j2k(img), _pil_j2k(img, no_jp2=True, irreversible=True)):
        for end in (20, len(data) // 2, len(data) - 3):
            assert _pil(data[:end]) is None
            with pytest.raises(ValueError):
                read_image_u8(_write(tmp_path, data[:end]))


def test_jpeg2000_planted_fault_changes_the_pixels():
    """One flipped bit of MQ-coded code-block data changes the pixels (or
    raises)."""
    data = _pil_j2k(_texture(20, 37, 53), no_jp2=True)
    want = jpeg2000.decode(data, "x", False)
    sod = data.index(b"\xff\x93") + 2
    flipped = bytearray(data)
    flipped[sod + (len(data) - sod) // 2] ^= 0x04
    try:
        got = jpeg2000.decode(bytes(flipped), "x", False)
    except ValueError:
        return
    assert not np.array_equal(got, want)


def test_gif_planted_fault_changes_the_pixels():
    """One LZW code changed changes the pixels (or raises)."""
    r = np.random.RandomState(21)
    data = bytearray(_gif((30, 20), r.randint(0, 16, (20, 30)), r.randint(0, 256, (16, 3))))
    from mvsformerplusplus_tpu_torch.data import gif
    want = gif.decode(bytes(data), "x", False)
    data[-20] ^= 0x08
    try:
        got = gif.decode(bytes(data), "x", False)
    except ValueError:
        return
    assert not np.array_equal(got, want)


# ------------------------------------------------------ fixtures, scans

@pytest.mark.parametrize("name", ["arith_420_q85.jpg", "arith_444_dac_r3.jpg",
                                  "arith_progressive_q85.jpg", "lossless_p1.jpg",
                                  "lossless_p7_pt2_r61.jpg", "lossless_gray_p4.jpg"])
def test_f4_fixtures_decode_to_the_stored_pil_pixels(name):
    path = FIXTURES / name
    want = np.load(FIXTURES / (name + ".npy"))
    np.testing.assert_array_equal(want, np.asarray(Image.open(path)))
    for got in (jpeg.decode_native(path.read_bytes()), jpeg.decode(path.read_bytes())):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["p6_1000.ppm", "p2_100.pgm", "p4.pbm", "interlaced_trans.gif",
                                  "lossy_q75.webp", "lossless.webp", "lossy_alpha.webp",
                                  "anim.webp", "irreversible_tiles.jp2", "reversible_rlcp.j2k",
                                  "gray16.jp2"])
def test_f5_fixtures_decode_to_the_stored_pil_pixels(name):
    path = FIXTURES / name
    want = np.load(FIXTURES / (name + ".npy"))
    np.testing.assert_array_equal(want, np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(read_image_u8(path), want)


def test_large_webp_and_jpeg2000_fixtures_match_their_pil_hashes():
    """chip_smoke.py's eval-size WebP and JPEG 2000 files: the port's pixels
    hash to PIL's RGB, as the hashes stored beside them say."""
    import hashlib
    import json

    meta = json.loads((FIXTURES / "large_format_fixtures.json").read_text())
    assert len(meta) == 2
    for name, m in meta.items():
        pixels = np.ascontiguousarray(read_image_u8(FIXTURES / name))
        assert list(pixels.shape) == m["shape"]
        assert hashlib.sha256(pixels.tobytes()).hexdigest() == m["sha256"]
        pil = np.ascontiguousarray(np.asarray(Image.open(FIXTURES / name).convert("RGB")))
        assert hashlib.sha256(pil.tobytes()).hexdigest() == m["sha256"]


def test_new_formats_decode_natively_and_count():
    counters = ("gif_lzw", "webp_lossy", "webp_lossless", "webp_alpha", "j2k_tile",
                "jpeg_decode_arith", "jpeg_decode_lossless", "jpeg_undifference")
    before = {k: native.calls[k] for k in counters}
    for name in ("interlaced_trans.gif", "lossy_alpha.webp", "lossless.webp",
                 "irreversible_tiles.jp2", "arith_420_q85.jpg", "lossless_p1.jpg"):
        read_image_u8(FIXTURES / name)
    assert all(native.calls[k] > before[k] for k in counters)


@pytest.fixture(scope="module")
def format_scans(tmp_path_factory):
    """A 3-view geometric scan, and copies whose views are lossy WebP and
    irreversible JPEG 2000 files under the scan's .jpg names (how
    colmap2mvsnet copies a user's images)."""
    root = tmp_path_factory.mktemp("formats")
    make_geometric_eval_scan(root, "scan1", n_views=3, h=100, w=150, ndepth=48,
                             scene=GeometricScene(seed=3, tex_res=128))
    for name, fmt, kw in (("webp", "WEBP", dict(quality=80)),
                          ("jp2", "JPEG2000", dict(irreversible=True))):
        shutil.copytree(root / "scan1", root / name)
        shutil.copytree(root / "gt_depths" / "scan1", root / "gt_depths" / name)
        for view in (root / name / "images").iterdir():
            img = Image.open(view).convert("RGB")
            buf = io.BytesIO()
            img.save(buf, fmt, **kw)
            view.write_bytes(buf.getvalue())
    return root


@pytest.mark.parametrize("scan", ["webp", "jp2"])
def test_eval_dataset_reads_webp_and_jpeg2000_views_as_jax(format_scans, scan):
    common = dict(nviews=3, ndepths=48, interval_scale={scan: 1.06}, dataset_name="dtu",
                  max_h=96, max_w=128, gt_depth_path=str(format_scans / "gt_depths"))
    port = EvalDataset(str(format_scans), [scan], **common)
    ref = JaxEvalDataset(str(format_scans), [scan], **common)
    for i in range(3):
        a, b = port[i], ref[i]
        for k in ("imgs", "ref_img"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port.views.decodes == 3
    cache = DecodedImages(4)
    for view in sorted((format_scans / scan / "images").iterdir()):
        np.testing.assert_array_equal(cache.get(view),
                                      np.asarray(Image.open(view).convert("RGB")))
    assert cache.decodes == 3
