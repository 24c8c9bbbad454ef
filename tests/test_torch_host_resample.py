"""The host library's share of OpenCV (csrc/host/resample.cpp through
data/native.py: resize_area, resize_nearest, resize_linear, hue_shift)
against its numpy versions (data/image.py) and cv2, on the CPU. Tolerance:
none; every comparison is bit for bit.

- Each native function equals its numpy version at odd sizes and scales:
  fractional and integer area shrinks (1 x 1 cells, one axis only, 2 x 2
  with 1, 3 and 4 channels), float32 and uint8, and any window of an area
  shrink equals the same slice of the whole.
- Area (float32 and uint8, the uint8 integer shrinks rounding as cv2 does),
  nearest and the hue shift equal cv2; linear equals cv2 at the eval
  scripts' resize ratios (DTU 1200 x 1600 -> 1152 x 1536, Tanks and
  Temples 1088 x 1920 -> 1024 x 1920, ETH3D 4032 x 6048 -> 1024 x 1600 at
  a quarter of the size, the same ratios) and at odd sizes whose taps fall
  within a rounding of a source sample. The one known gap to cv2: at width
  enlargements of about 8x or more, cv2's IPP path puts the columns clamped
  to an edge sample up to 2^-24 off in some rows; the test pins it
  there.
- Call counts: a library call counts in `native.calls` once it enters the
  library; the area enlargement left to numpy counts in
  `native.plain_calls["resize_area_enlarge"]`; a same-size copy counts
  nothing.
- A planted fault per function (a weight one float32 step off in the
  numpy tables, an output shifted by a pixel, the hue turned one step
  further) makes its comparison fail.
- DTUTrainDataset.get_sample equals the JAX dataset's (cv2) bit for bit
  at resize_range scales taking the fractional path, the integer 2 x 2
  path and none, calling the native functions and no numpy version;
  EvalDataset items equal the JAX EvalDataset's the same way, shrinking and
  enlarging.
- With no compiler the functions raise and count no call; nothing falls
  back to numpy.
"""
import cv2
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.data import synthetic as jsyn
from mvsformerplusplus_tpu.data import transforms as jtr
from mvsformerplusplus_tpu.data.eval_dataset import EvalDataset as JaxEvalDataset
from mvsformerplusplus_tpu.data.mvs_dataset import DTUTrainDataset as JaxDTU
from mvsformerplusplus_tpu_torch.data import image, native
from mvsformerplusplus_tpu_torch.data.eval_dataset import EvalDataset
from mvsformerplusplus_tpu_torch.data.mvs_dataset import DTUTrainDataset
from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene, make_geometric_eval_scan

AUG = dict(brightness=0.2, contrast=0.1, saturation=0.1, hue=0.05, min_gamma=0.9, max_gamma=1.1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed, h, w, c, dtype=np.float32):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, max(c, 1))
    img = img[..., 0] if c == 0 else img
    return (img * 255).astype(np.uint8) if dtype == np.uint8 else img.astype(np.float32)


# (source, destination): fractional shrinks, integer ones (2 x 2, 3 x 1,
# 1 x 1 cells on one axis), one axis only, a 1-pixel output
AREA_CASES = [((97, 131), (60, 80)), ((120, 160), (73, 98)), ((64, 96), (32, 48)),
              ((63, 95), (21, 95)), ((50, 70), (50, 35)), ((41, 43), (40, 43)),
              ((33, 17), (1, 1)), ((200, 300), (110, 165))]


@pytest.mark.parametrize("src,dst", AREA_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_resize_area_equals_numpy_and_cv2(src, dst, channels):
    img = _image(channels + src[0], *src, channels)
    got = native.resize_area(img, *dst)
    want = image.resize_area(img, *dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(want.reshape(cv.shape), cv)


@pytest.mark.parametrize("src,dst", AREA_CASES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_uint8_equals_numpy(src, dst, channels):
    img = _image(channels + src[1], *src, channels, np.uint8)
    got = native.resize_area(img, *dst)
    assert got.dtype == np.uint8
    want = image.resize_area(img, *dst)
    np.testing.assert_array_equal(got, want)
    cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(want.reshape(cv.shape), cv)


# integer shrinks: 2 x 2 rounds half up for 1, 3 and 4 channels (OpenCV's
# vector loop), every other factor and 2 x 2 of 2 channels rounds
# float32(sum) * float32(1 / n) half to even
@pytest.mark.parametrize("fy,fx", [(2, 2), (3, 3), (4, 4), (2, 3), (3, 1), (1, 4), (6, 6)])
@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
def test_resize_area_uint8_integer_shrinks_round_as_cv2(fy, fx, channels):
    rng = np.random.RandomState(fy * 10 + fx + channels)
    h, w = 13, 17
    img = rng.randint(0, 256, (h * fy, w * fx, max(channels, 1))).astype(np.uint8)
    img = img[..., 0] if channels == 0 else img
    got = native.resize_area(img, h, w)
    want = image.resize_area(img, h, w)
    np.testing.assert_array_equal(got, want)
    cv = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(want.reshape(cv.shape), cv)


@pytest.mark.parametrize("seed", range(6))
def test_resize_windows_equal_slices_of_the_whole(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(20, 90, 2)
    dh, dw = rng.randint(1, h + 1), rng.randint(1, w + 1)
    img = _image(seed, h, w, 3)
    oy, ox = rng.randint(0, dh), rng.randint(0, dw)
    win = (oy, ox, rng.randint(1, dh - oy + 1), rng.randint(1, dw - ox + 1))
    sl = np.s_[oy:oy + win[2], ox:ox + win[3]]
    np.testing.assert_array_equal(native.resize_area(img, dh, dw, win),
                                  native.resize_area(img, dh, dw)[sl])
    with pytest.raises(ValueError, match="outside"):
        native.resize_area(img, dh, dw, (oy, ox, dh + 1, 1))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32])
@pytest.mark.parametrize("channels", [0, 1, 3])
@pytest.mark.parametrize("src,dst", [((96, 128), (12, 16)), ((37, 53), (20, 9)),
                                     ((10, 14), (31, 40)), ((8, 8), (8, 3))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_nearest_equals_numpy_and_cv2(src, dst, channels, dtype):
    img = _image(src[0] + channels, *src, channels, np.uint8).astype(dtype)
    got = native.resize_nearest(img, *dst)
    want = image.resize_nearest(img, *dst)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if dtype != np.int32:  # cv2.resize takes no int32 with INTER_NEAREST on every build
        cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(want.reshape(cv.shape), cv)


@pytest.mark.parametrize("src,dst", [((1200, 1600), (1152, 1536)), ((1088, 1920), (1024, 1920)),
                                     ((1008, 1512), (256, 400)), ((60, 80), (30, 40)),
                                     ((32, 32), (64, 64))],
                         ids=["dtu", "tt", "eth3d_quarter", "half", "double"])
def test_resize_linear_equals_numpy_and_cv2_at_the_eval_ratios(src, dst):
    img = _image(src[1], *src, 3)
    got = native.resize_linear(img, *dst)
    want = image.resize_linear(img, *dst)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, cv2.resize(img, dst[::-1],
                                                   interpolation=cv2.INTER_LINEAR))


# odd sizes at which (d + 0.5) * src / dst - 0.5 falls within a rounding of
# a source sample in some rows (1 / (dst / src) would put it on the other
# side); width ratios under 8
@pytest.mark.parametrize("src,dst", [((3, 80), (53, 57)), ((15, 118), (279, 265)),
                                     ((107, 45), (213, 291)), ((48, 39), (272, 298)),
                                     ((104, 44), (184, 280)), ((19, 45), (74, 151))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_resize_linear_equals_cv2_at_odd_sizes(src, dst, channels):
    img = _image(channels + src[1], *src, channels)
    want = image.resize_linear(img, *dst)
    np.testing.assert_array_equal(native.resize_linear(img, *dst), want)
    cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(want.reshape(cv.shape), cv)


@pytest.mark.parametrize("src,dst", [((100, 64), (200, 640)), ((120, 160), (1152, 1536))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_linear_cv2_gap_is_confined_to_the_clamped_edge_columns(src, dst):
    """At a width enlargement of 10x and 9.6x cv2 (IPP) rounds the vertical
    tap pair twice in some of the columns clamped to the first or last
    source sample (image._edge_runs); the port follows it, so the whole
    image, edge columns included, is cv2's."""
    img = _image(src[0], *src, 3)
    cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(native.resize_linear(img, *dst), cv)
    np.testing.assert_array_equal(image.resize_linear(img, *dst), cv)


# width ratios of 8x to 100x: clamped regions of 4 to 50 pixels, with and
# without whole 16-pixel blocks and with remainders under and over 5
# (38.4x: 19 clamped pixels, a block and a remainder of 3)
@pytest.mark.parametrize("src,dst", [((40, 40), (30, 1536)), ((40, 40), (300, 1536)),
                                     ((12, 10), (9, 80)), ((9, 10), (31, 150)),
                                     ((7, 4), (12, 200)), ((6, 3), (9, 200)),
                                     ((33, 17), (70, 999)), ((5, 2), (13, 200))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_resize_linear_equals_cv2_at_wide_enlargements(src, dst, channels):
    img = _image(channels + src[1], *src, channels)
    cv = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    want = image.resize_linear(img, *dst)
    np.testing.assert_array_equal(want.reshape(cv.shape), cv)
    np.testing.assert_array_equal(native.resize_linear(img, *dst), want)


@pytest.mark.parametrize("src,dst", [((19, 45), (74, 151)), ((93, 109), (124, 3)),
                                     ((37, 53), (100, 131)), ((13, 17), (40, 9)),
                                     ((5, 1), (7, 1)), ((64, 48), (64, 48))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_resize_linear_equals_numpy_at_odd_sizes(src, dst, channels):
    img = _image(channels + src[0], *src, channels)
    np.testing.assert_array_equal(native.resize_linear(img, *dst),
                                  image.resize_linear(img, *dst))


@pytest.mark.parametrize("width", [1, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("shift", [-9, -1, 0, 5, 9])
def test_hue_shift_equals_numpy_and_cv2(width, shift):
    img = _image(width + shift + 10, 9, width, 3)
    img[0, 0] = 1.0  # the top of the range
    img[-1, -1] = (0.5, 0.5, 0.5)  # grey: hue and saturation 0
    got = native.hue_shift(img, shift)
    np.testing.assert_array_equal(got, image.hue_shift(img, shift))
    np.testing.assert_array_equal(got, jtr._adjust_hue(img, shift / 180))


# -------------------------------------------------------- planted faults

def _nudged(fn):
    """fn's tables with every float32 weight one step up."""
    def wrapped(*args):
        out = list(fn(*args))
        out[-1] = np.nextafter(out[-1], np.float32(2)).astype(np.float32)
        return tuple(out)
    return wrapped


def test_planted_faults_fail_the_comparisons(monkeypatch):
    img = _image(3, 97, 131, 3)
    area = native.resize_area(img, 60, 80)
    near = native.resize_nearest(img, 40, 50)
    lin = native.resize_linear(img, 74, 151)
    hue = native.hue_shift(img, 5)
    assert not np.array_equal(hue, image.hue_shift(img, 6))
    assert not np.array_equal(near, np.roll(image.resize_nearest(img, 40, 50), 1, axis=1))
    monkeypatch.setattr(image, "_area_table", _nudged(image._area_table))
    monkeypatch.setattr(image, "_linear_taps", _nudged(image._linear_taps))
    assert not np.array_equal(area, image.resize_area(img, 60, 80))
    assert not np.array_equal(lin, image.resize_linear(img, 74, 151))


# --------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def geometric_scan(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    jsyn.make_geometric_dtu(root, n_views=5, n_lights=7, h=160, w=240, ndepth=48,
                            scene=jsyn.GeometricScene(seed=3, tex_res=256))
    return root


# resize_range, crop: 0.8-0.96 (fractional), 0.5 (integer 2 x 2), 0.45 at
# the clip (fractional), 0.6 (fractional), 1.0 (none)
@pytest.mark.parametrize("resize_range,crop,idx", [
    ((1.0, 1.2), (128, 192), 9), ((1.25, 1.25), (64, 96), 3), ((0.7, 0.8), (64, 96), 23),
    ((1.5, 1.5), (64, 96), 34), ((1.0, 1.0), (160, 240), 5)])
def test_dtu_sample_equals_jax_bit_for_bit(geometric_scan, resize_range, crop, idx):
    kw = dict(nviews=5, ndepths=48, interval_scale=1.06, random_crop=True, augment=True,
              aug_args=AUG, resize_range=resize_range)
    listfile = str(geometric_scan / "train.txt")
    plain = dict(native.plain_calls)
    before = dict(native.calls)
    got = DTUTrainDataset(str(geometric_scan), listfile, **kw).get_sample(idx, crop, 1)
    assert native.plain_calls == plain
    assert native.calls["hue_shift"] == before["hue_shift"] + 5
    if resize_range[0] * crop[0] < 160:
        assert native.calls["resize_area"] == before["resize_area"] + 5
    want = JaxDTU(str(geometric_scan), listfile, **kw).get_sample(idx, crop, 1)
    assert got["filename"] == want["filename"]
    np.testing.assert_array_equal(got["imgs"], want["imgs"])
    for k in want["cams"]:
        np.testing.assert_array_equal(got["cams"][k], want["cams"][k])
    for k in ("depth_gt", "mask"):
        for s in want[k]:
            np.testing.assert_array_equal(got[k][s], want[k][s])


@pytest.mark.parametrize("name,fix_res", [("dtu", False), ("tt", True)])
def test_eval_items_equal_jax_through_native_linear(tmp_path, name, fix_res):
    make_geometric_eval_scan(tmp_path, "scan1", n_views=3, h=100, w=150, ndepth=48,
                             scene=GeometricScene(seed=5, tex_res=128))
    kw = dict(nviews=3, ndepths=48, max_h=64 if fix_res else 80, max_w=128, fix_res=fix_res,
              dataset_name=name)
    plain = dict(native.plain_calls)
    before = native.calls["resize_linear"]
    got = EvalDataset(str(tmp_path), ["scan1"], **kw)[1]
    assert native.plain_calls == plain and native.calls["resize_linear"] == before + 3
    want = JaxEvalDataset(str(tmp_path), ["scan1"], **kw)[1]
    for k in ("imgs", "depth_values", "ref_img"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in want["cams"]:
        np.testing.assert_array_equal(got["cams"][k], want["cams"][k])


# enlarging: the 100 x 150 views to 256 x 384 (2.56x) by the max-size
# ratio, and to exactly 192 x 320 with fix_res
@pytest.mark.parametrize("name,fix_res,max_hw", [("dtu", False, (256, 384)),
                                                 ("tt", True, (192, 320))], ids=["dtu", "tt"])
def test_eval_items_equal_jax_when_enlarging(tmp_path, name, fix_res, max_hw):
    make_geometric_eval_scan(tmp_path, "scan1", n_views=3, h=100, w=150, ndepth=48,
                             scene=GeometricScene(seed=6, tex_res=128))
    kw = dict(nviews=3, ndepths=48, max_h=max_hw[0], max_w=max_hw[1], fix_res=fix_res,
              dataset_name=name)
    plain = dict(native.plain_calls)
    before = native.calls["resize_linear"]
    got = EvalDataset(str(tmp_path), ["scan1"], **kw)[0]
    assert native.plain_calls == plain and native.calls["resize_linear"] == before + 3
    want = JaxEvalDataset(str(tmp_path), ["scan1"], **kw)[0]
    assert got["imgs"].shape[-2] > 100
    for k in ("imgs", "depth_values", "ref_img"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in want["cams"]:
        np.testing.assert_array_equal(got["cams"][k], want["cams"][k])


def test_missing_compiler_raises_for_every_resample(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    img = _image(0, 8, 8, 3)
    plain, calls = dict(native.plain_calls), dict(native.calls)
    for call in (lambda: native.resize_area(img, 4, 5), lambda: native.resize_nearest(img, 4, 5),
                 lambda: native.resize_linear(img, 4, 5), lambda: native.hue_shift(img, 3)):
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            call()
    assert native.plain_calls == plain and native.calls == calls


def test_calls_count_library_entries_and_the_numpy_enlarge():
    img = _image(1, 12, 20, 3)
    plain, calls = dict(native.plain_calls), dict(native.calls)
    native.resize_area(img, 12, 20)
    native.resize_linear(img, 12, 20)
    assert native.plain_calls == plain and native.calls == calls
    np.testing.assert_array_equal(native.resize_area(img, 30, 20), image.resize_area(img, 30, 20))
    plain["resize_area_enlarge"] += 1
    plain["resize_area"] += 1  # image.resize_area, the comparison's plain side
    assert native.plain_calls == plain and native.calls == calls
    native.resize_area(img, 6, 10)
    native.resize_linear(img, 30, 50)
    calls["resize_area"] += 1
    calls["resize_linear"] += 1
    assert native.plain_calls == plain and native.calls == calls
