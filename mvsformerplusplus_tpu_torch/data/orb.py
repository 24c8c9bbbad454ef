"""OpenCV's ORB features and brute-force Hamming matching, as the NeRF scene
converter uses them (tools/nerf2mvsnet.orb_match): cv2.ORB_create with its
defaults and `detectAndCompute` on the gray image, then
BFMatcher(NORM_HAMMING).knnMatch(k=2) and Lowe's ratio test. The work runs
in the host library (csrc/host/orb.cpp, through data/native.py), step for
step in OpenCV 5.0's arithmetic, so keypoints, descriptors and their order
are cv2's: the pyramid of bit-exact linear resizes, FAST-9 with non-max
suppression, the border filter, KeyPointsFilter::retainBest (libstdc++'s
nth_element and partition, as OpenCV calls them), Harris responses over a
7 x 7 block, the intensity-centroid angle through cv::fastAtan2, and rBRIEF
on each level blurred by GaussianBlur's integer path.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from . import image, native

# cv2.ORB_create's defaults (nfeatures aside): scaleFactor, nlevels,
# edgeThreshold, fastThreshold, and HARRIS_SCORE's constant (orb.cpp
# HARRIS_K); firstLevel 0, WTA_K 2 and patchSize 31 are fixed here.
SCALE_FACTOR = 1.2
N_LEVELS = 8
EDGE_THRESHOLD = 31
FAST_THRESHOLD = 20
HARRIS_K = 0.04

# ORB blurs each pyramid level in place as a view into the pyramid's
# buffer, which sends cv2.GaussianBlur(7 x 7, sigma 2) past its bit-exact
# integer path (taken for whole images only) to sepFilter2D's float one
# with these taps (native.blur_sep).
ORB_BLUR_TAPS = image.gaussian_kernel(7, 2.0)


class Features(NamedTuple):
    """ORB's keypoints in cv2's order: pt [N, 2], size, angle (degrees),
    response, octave (all float32 but octave, int32), and the descriptors,
    uint8 [N, 32]."""
    pt: np.ndarray
    size: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    octave: np.ndarray
    descriptors: np.ndarray

    def __len__(self):
        return len(self.pt)

    def rows(self) -> np.ndarray:
        """float32 [N, 6]: (x, y, size, angle, response, octave)."""
        return np.concatenate([self.pt, self.size[:, None], self.angle[:, None],
                               self.response[:, None], self.octave[:, None].astype(np.float32)],
                              axis=1)


def detect_and_compute(gray: np.ndarray, n_features: int = 500, n_levels: int = N_LEVELS,
                       harris_k: float = HARRIS_K, pattern=None) -> Features:
    """cv2.ORB_create(nfeatures=n_features, nlevels=n_levels)
    .detectAndCompute(gray, None) on uint8 [H, W]. `harris_k` and `pattern`
    (int32 [256, 4], the rBRIEF pairs; None: OpenCV's) are for checks."""
    rows, desc = native.orb_detect_compute(gray, n_features, float(np.float32(SCALE_FACTOR)),
                                           n_levels, EDGE_THRESHOLD, FAST_THRESHOLD, harris_k,
                                           ORB_BLUR_TAPS, pattern)
    return Features(rows[:, :2].copy(), rows[:, 2].copy(), rows[:, 3].copy(), rows[:, 4].copy(),
                    rows[:, 5].astype(np.int32), desc)


def knn_match2(desc_a: np.ndarray, desc_b: np.ndarray):
    """BFMatcher(NORM_HAMMING).knnMatch(desc_a, desc_b, k=2): per row of
    desc_a the two nearest rows of desc_b, (indices, distances) int32
    [Na, 2]."""
    return native.hamming_knn2(desc_a, desc_b)


def orb_match(img_a: np.ndarray, img_b: np.ndarray, n_features: int = 4000,
              ratio: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX tool's orb_match: ORB on each RGB uint8 [H, W, 3] image's gray,
    kNN (k=2) Hamming matches of a's descriptors in b's, kept where the
    best distance is under `ratio` times the second: float64 [N, 2] point
    pairs (pts_a, pts_b) in a's keypoint order; none when either image has
    fewer than 8 keypoints."""
    fa = detect_and_compute(native.rgb_to_gray(img_a), n_features)
    fb = detect_and_compute(native.rgb_to_gray(img_b), n_features)
    if len(fa) < 8 or len(fb) < 8:
        return np.zeros((0, 2)), np.zeros((0, 2))
    idx, dist = knn_match2(fa.descriptors, fb.descriptors)
    good = dist[:, 0] < ratio * dist[:, 1].astype(np.float64)
    return (fa.pt[good].astype(np.float64), fb.pt[idx[good, 0]].astype(np.float64))
