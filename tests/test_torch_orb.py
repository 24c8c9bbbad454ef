"""The port's ORB (data/orb.py, csrc/host/orb.cpp) and the OpenCV primitives
it runs, against cv2 5.0 on the same images. Tolerance: none; keypoints
and descriptors are compared in cv2's order.

- FAST-9 (cv2.FastFeatureDetector_create(20, True)), the level blur
  (sepFilter2D's float path), INTER_LINEAR_EXACT and RGB -> gray, each
  native and (where it has one) numpy, at odd sizes;
- detectAndCompute at 1 and 8 levels, three seeds, odd sizes from 97 x 131
  to 480 x 640, a flat image and one with fewer than 8 keypoints: pt, size,
  angle, response, octave and the descriptors;
- the Hamming kNN against BFMatcher(NORM_HAMMING).knnMatch(k=2), and
  orb_match against the JAX tool's (tools/nerf2mvsnet.py, cv2 inside);
- the rBRIEF table against the one in cv2's binary, found by its first
  values, and the committed fixtures (tests/data/make_orb_fixtures.py);
- planted faults (one pattern pair swapped, a Harris k 1% off) change the
  result.
"""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu_torch.data import image, io, native, orb

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
sys.path.insert(0, str(DATA))
import make_orb_fixtures  # noqa: E402

torch.set_num_threads(1)


def _texture(seed, h, w):
    """Blocks of 8 pixels (corners for FAST) under uniform noise."""
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2), np.ones((8, 8)))[:h, :w]
    return (base * 200 + rng.rand(h, w) * 55).astype(np.uint8)


def _cv2_orb(gray, n_features, n_levels=8):
    kps, desc = cv2.ORB_create(nfeatures=n_features, nlevels=n_levels).detectAndCompute(gray,
                                                                                       None)
    rows = np.array([(k.pt[0], k.pt[1], k.size, k.angle, k.response, k.octave) for k in kps],
                    np.float32).reshape(-1, 6)
    return rows, (np.zeros((0, 32), np.uint8) if desc is None else desc)


SIZES = [(97, 131), (203, 157), (301, 419), (480, 640)]


# ------------------------------------------------------------ primitives

@pytest.mark.parametrize("size", SIZES + [(7, 7), (12, 40)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("threshold", [20, 7])
def test_fast9_equals_cv2(size, threshold):
    gray = _texture(size[0], *size)
    want = np.array([(k.pt[0], k.pt[1], k.response) for k in
                     cv2.FastFeatureDetector_create(threshold, True).detect(gray)],
                    np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(native.fast9(gray, threshold), want)


@pytest.mark.parametrize("size", [(1, 9), (5, 3), (41, 67), (97, 131), (480, 641)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_orb_blur_equals_cv2(size):
    """ORB's blur of a pyramid level, cv2.GaussianBlur(7 x 7, sigma 2) of a
    view into the pyramid, is sepFilter2D's float path with the float32
    Gaussian kernel."""
    gray = _texture(size[1], *size)
    k = cv2.getGaussianKernel(7, 2, ktype=cv2.CV_32F)
    np.testing.assert_array_equal(image.gaussian_kernel(7, 2.0), k.ravel())
    np.testing.assert_array_equal(orb.ORB_BLUR_TAPS, k.ravel())
    np.testing.assert_array_equal(native.blur_sep(gray, k.ravel()),
                                  cv2.sepFilter2D(gray, -1, k, k,
                                                  borderType=cv2.BORDER_REFLECT_101))


def test_blur_sep_rounds_the_row_tail_apart():
    """A 450-pixel row's last two values lie past its 32-pixel vector blocks,
    where OpenCV rounds each product and sum: here that moves an output by
    one level (a fused row pass everywhere would give 153, cv2 154)."""
    rng = np.random.default_rng(12)
    gray = np.kron(rng.integers(0, 256, (60, 70)), np.ones((7, 7))).astype(np.uint8)[:400, :450]
    k = cv2.getGaussianKernel(7, 2, ktype=cv2.CV_32F)
    want = cv2.sepFilter2D(gray, -1, k, k, borderType=cv2.BORDER_REFLECT_101)
    assert want[49, 449] == 154
    np.testing.assert_array_equal(native.blur_sep(gray, k.ravel()), want)


@pytest.mark.parametrize("src,dst", [((97, 131), (81, 109)), ((480, 640), (400, 533)),
                                     ((11, 21), (5, 10)), ((10, 20), (5, 10)),
                                     ((30, 40), (60, 77)), ((3, 9), (128, 256)),
                                     ((5, 7), (256, 256)), ((1, 9), (4, 3))],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_resize_linear_exact_equals_cv2(src, dst, channels):
    rng = np.random.RandomState(src[0] + dst[1])
    img = rng.randint(0, 256, src + ((channels,) if channels else ())).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR_EXACT).reshape(
        dst + img.shape[2:])
    np.testing.assert_array_equal(native.resize_linear_exact(img, *dst), want)
    np.testing.assert_array_equal(image.resize_linear_exact(img, *dst), want)


@pytest.mark.parametrize("size", [(1, 1), (37, 53), (480, 641)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_rgb_to_gray_equals_cv2(size):
    rgb = np.random.RandomState(size[1]).randint(0, 256, size + (3,)).astype(np.uint8)
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(native.rgb_to_gray(rgb), want)
    np.testing.assert_array_equal(image.rgb_to_gray(rgb), want)


# -------------------------------------------------------------------- ORB

def _assert_features_equal(f, rows, desc):
    np.testing.assert_array_equal(f.rows(), rows)
    np.testing.assert_array_equal(f.descriptors, desc)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_levels", [1, 8])
def test_detect_and_compute_equals_cv2(size, seed, n_levels):
    gray = _texture(seed * 100 + size[0], *size)
    n = 4000 if size == (480, 640) else 500
    rows, desc = _cv2_orb(gray, n, n_levels)
    assert len(rows) > 8
    _assert_features_equal(orb.detect_and_compute(gray, n, n_levels), rows, desc)


@pytest.mark.parametrize("kind", ["flat", "few"])
def test_detect_and_compute_without_enough_corners_equals_cv2(kind):
    gray = np.full((131, 177), 90, np.uint8)
    if kind == "few":
        gray[40:60, 50:75] = 200  # one bright block: a handful of corners
    rows, desc = _cv2_orb(gray, 4000)
    f = orb.detect_and_compute(gray, 4000)
    assert len(rows) == len(f) and len(rows) < 8
    _assert_features_equal(f, rows, desc)


def test_hamming_knn_equals_bfmatcher():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (300, 32)).astype(np.uint8)
    b = rng.randint(0, 256, (257, 32)).astype(np.uint8)
    b[100] = b[7]  # a tie: the lower train index first
    a[5] = b[7]
    idx, dist = orb.knn_match2(a, b)
    for i, (m, n) in enumerate(cv2.BFMatcher(cv2.NORM_HAMMING).knnMatch(a, b, k=2)):
        assert (idx[i, 0], idx[i, 1]) == (m.trainIdx, n.trainIdx)
        assert (dist[i, 0], dist[i, 1]) == (m.distance, n.distance)
    assert tuple(idx[5]) == (7, 100)


@pytest.mark.parametrize("shift", [(0, 0), (7, 11), (-13, 4)])
def test_orb_match_equals_the_jax_tools(shift):
    sys.path.insert(0, str(ROOT))
    from tools.nerf2mvsnet import orb_match as jax_orb_match

    rgb = io.read_image_u8(DATA / "photo_1152x1536_progressive_q75.jpg")[200:680, 300:940]
    other = np.ascontiguousarray(np.roll(rgb, shift, axis=(0, 1)))
    got = orb.orb_match(rgb, other)
    want = jax_orb_match(rgb, other)
    assert len(got[0]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


def test_orb_match_with_too_few_keypoints_is_empty():
    flat = np.full((120, 160, 3), 128, np.uint8)
    pa, pb = orb.orb_match(flat, flat)
    assert pa.shape == pb.shape == (0, 2)


# --------------------------------------------------- table and fixtures

def test_pattern_table_equals_cv2s():
    table = make_orb_fixtures.cv2_table()
    np.testing.assert_array_equal(native.orb_pattern().reshape(-1), table)
    np.testing.assert_array_equal(make_orb_fixtures.port_table(), table)


@pytest.mark.parametrize("name", make_orb_fixtures.IMAGES)
def test_fixtures_equal_cv2_and_the_port(name):
    rows = np.load(DATA / f"{name}.orb.npy")
    desc = np.load(DATA / f"{name}.orb_desc.npy")
    np.testing.assert_array_equal(rows, make_orb_fixtures.cv2_orb(DATA / name)[0])
    gray = native.rgb_to_gray(io.imread_rgb(DATA / name))
    _assert_features_equal(orb.detect_and_compute(gray, make_orb_fixtures.N_FEATURES), rows,
                           desc)


# --------------------------------------------------------- planted faults

def test_planted_faults_change_the_result():
    gray = _texture(5, 203, 157)
    rows, desc = _cv2_orb(gray, 500)
    pattern = native.orb_pattern().copy()
    pattern[[10, 11]] = pattern[[11, 10]]  # one pair of point pairs swapped
    f = orb.detect_and_compute(gray, 500, pattern=pattern)
    np.testing.assert_array_equal(f.rows(), rows)
    assert (f.descriptors != desc).any()
    f = orb.detect_and_compute(gray, 500, harris_k=orb.HARRIS_K * 1.01)
    assert not np.array_equal(f.rows(), rows)
