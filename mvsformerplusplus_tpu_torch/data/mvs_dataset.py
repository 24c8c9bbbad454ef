"""Multi-view training samples (counterpart of
mvsformerplusplus_tpu/data/mvs_dataset.py): the shared geometry, crop and
augmentation of a sample, the DTU and BlendedMVS layouts, and the epoch
schedule of crop scales.

Every sample of a batch shares one crop scale; ShapeBucketSchedule assigns
the scales to batches from (seed, epoch), so a run is reproducible. Each
view's intrinsics are scaled by 0.125/0.25/0.5/1 into the per-stage
[V, 2, 4, 4] camera stacks the model takes. numpy and the host library
(data/native.py: its resizes and hue shift stand in for OpenCV, the codecs
behind data/io.py and data/jpeg.py for PIL, crop_normalize for the JAX
package's C pass).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import native
from .io import (DecodedImages, build_camera_stack, read_cam_file, read_image, read_pair_file,
                 read_pfm, read_png)
from .transforms import apply_color_jitter, sample_jitter_params, stage_pyramid

STAGE_SCALES = (0.125, 0.25, 0.5, 1.0)


def stage_cameras(intrinsics: np.ndarray, extrinsics: np.ndarray) -> Dict[str, np.ndarray]:
    """Full-resolution (K, E) -> {'stageN': [2, 4, 4]} with K scaled per stage."""
    cams = {}
    for i, s in enumerate(STAGE_SCALES):
        k = intrinsics.copy()
        k[:2] *= s
        cams[f"stage{i + 1}"] = build_camera_stack(k, extrinsics)
    return cams


def resized_size(h: int, w: int, scale: float) -> Tuple[int, int]:
    """(h, w) of an h x w view resized by `scale` (the JAX package's
    pre_resize)."""
    return (h, w) if scale == 1.0 else (int(h * scale), int(w * scale))


def resize_maps(depth, intrinsics, mask, hw: Tuple[int, int], scale: float):
    """The resize of everything but the image: depth and mask of an `hw`
    view by nearest, K scaled."""
    if scale == 1.0:
        return depth, intrinsics, mask
    nh, nw = resized_size(*hw, scale)
    k = intrinsics.copy()
    k[0] *= scale
    k[1] *= scale
    if depth is not None:
        depth = native.resize_nearest(depth, nh, nw)
    if mask is not None:
        mask = native.resize_nearest(mask, nh, nw)
    return depth, k, mask


def resize_image(img, scale: float, window=None):
    """The image's area shrink by `scale`; with `window` (oy, ox, h, w) only
    that part of the result, bit-equal to the same crop of the whole (each
    output pixel depends only on its own source cell)."""
    if scale == 1.0:
        if window is None:
            return img
        oy, ox, wh, ww = window
        return img[oy:oy + wh, ox:ox + ww]
    return native.resize_area(img, *resized_size(*img.shape[:2], scale), window)


def crop(depth, intrinsics, mask, crop_h, crop_w, offset_y, offset_x):
    """Crop depth and mask and shift the principal point (the image is
    cropped by resize_image's window)."""
    k = intrinsics.copy()
    k[0, 2] -= offset_x
    k[1, 2] -= offset_y
    if depth is not None:
        depth = depth[offset_y:offset_y + crop_h, offset_x:offset_x + crop_w]
    if mask is not None:
        mask = mask[offset_y:offset_y + crop_h, offset_x:offset_x + crop_w]
    return depth, k, mask


@dataclass
class MultiScaleArgs:
    """The config's data_loader.args.multi_scale_args."""

    scales: Sequence[Tuple[int, int]] = (
        (512, 640), (512, 704), (512, 768),
        (576, 704), (576, 768), (576, 832),
        (640, 832), (640, 896), (640, 960),
        (704, 896), (704, 960), (704, 1024),
        (768, 960), (768, 1024), (768, 1088),
        (832, 1024), (832, 1088), (832, 1152),
        (896, 1152), (896, 1216), (896, 1280),
        (960, 1216), (960, 1280), (960, 1344),
        (1024, 1280),
    )
    resize_range: Tuple[float, float] = (1.0, 1.2)
    scale_batch_map: Dict[str, int] = field(default_factory=lambda: {
        "512": 4, "576": 4, "640": 4, "704": 4,
        "768": 2, "832": 2, "896": 2, "960": 2, "1024": 2,
    })


class ShapeBucketSchedule:
    """(sample order, crop scale per batch) for an epoch, drawn from
    RandomState(seed * 10007 + epoch)."""

    def __init__(self, n_samples: int, scales: Sequence[Tuple[int, int]],
                 batch_size: int, seed: int = 0):
        self.n_samples = n_samples
        self.scales = list(scales)
        self.batch_size = batch_size
        self.seed = seed

    def epoch(self, epoch: int, order=None):
        """order (optional): a sample order given from outside (e.g.
        BalancedSchedule); the permutation is drawn all the same, so the
        scale draws stay the same either way."""
        rng = np.random.RandomState(self.seed * 10007 + epoch)
        if order is None:
            order = rng.permutation(self.n_samples)
        else:
            order = np.asarray(order)
            rng.permutation(self.n_samples)
        n_batches = len(order) // self.batch_size
        scale_idx = rng.randint(0, len(self.scales), size=n_batches)
        return [(order[b * self.batch_size:(b + 1) * self.batch_size], self.scales[scale_idx[b]])
                for b in range(n_batches)]


class MVSTrainDataset:
    """Sample loading given (scan, light, reference view, source views)
    metas; subclasses give `metas` and `load_view`."""

    def __init__(self, nviews=5, ndepths=192, interval_scale=1.06, random_crop=True,
                 augment=True, aug_args=None, resize_range=(1.0, 1.2), seed=0):
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.random_crop = random_crop
        self.augment = augment
        self.aug_args = aug_args or {}
        self.resize_range = resize_range
        self.metas: List = []
        self.seed = seed

    def load_view(self, meta, vid, want_depth: bool):
        """-> (img [H, W, 3] float in [0, 1], depth or None, mask or None, K,
        E, depth_min, depth_interval)."""
        raise NotImplementedError

    def full_resolution(self) -> Tuple[int, int]:
        """(H, W) of the raw images, read from the first sample's reference
        image."""
        if not hasattr(self, "_full_res"):
            img, *_ = self.load_view(self.metas[0], self.metas[0][2], want_depth=False)
            self._full_res = img.shape[:2]
        return self._full_res

    def shuffle_src_views(self, src_views, rng):
        srcs = list(src_views)
        rng.shuffle(srcs)
        return srcs

    def __len__(self):
        return len(self.metas)

    def _offsets(self, nprng, h, w, crop_h, crop_w):
        if self.random_crop:
            return nprng.randint(0, h - crop_h + 1), nprng.randint(0, w - crop_w + 1)
        return (h - crop_h) // 2, (w - crop_w) // 2

    def get_sample(self, idx: int, crop_hw: Tuple[int, int], epoch: int = 0):
        """One training sample at the given crop scale; every random draw
        comes from (seed, epoch, idx)."""
        meta = self.metas[idx]
        scan, _, ref_view, src_views = meta
        rng = random.Random((self.seed * 100003 + epoch) * 1000003 + idx)
        nprng = np.random.RandomState(rng.randrange(2 ** 31))

        srcs = self.shuffle_src_views(src_views, rng)
        view_ids = [ref_view] + srcs[: self.nviews - 1]
        crop_h, crop_w = crop_hw
        full_h, full_w = self.full_resolution()

        lo, hi = self.resize_range
        enlarge = lo + nprng.rand() * (hi - lo)
        resize_scale = max(float(np.clip(crop_h * enlarge / full_h, 0.45, 1.0)),
                           float(np.clip(crop_w * enlarge / full_w, 0.45, 1.0)))
        jitter = sample_jitter_params(nprng, **self.aug_args) if self.augment else None

        imgs, cams = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            img, depth, mask, K, E, dmin, dint = self.load_view(meta, vid, want_depth=(i == 0))
            # the resize: depth, mask and K whole, the image only in the
            # window its crop keeps, so the crop offsets are drawn before
            # the image's resize (which draws nothing: the JAX package's
            # order of draws)
            depth, K, mask = resize_maps(depth, K, mask, img.shape[:2], resize_scale)
            h, w = resized_size(*img.shape[:2], resize_scale)
            if i == 0:
                # retry the reference crop until its 1/8-resolution mask has
                # a valid pixel; the accepted offsets are the last drawn
                oy = ox = 0
                for _ in range(20):
                    oy, ox = self._offsets(nprng, h, w, crop_h, crop_w)
                    m_ = mask[oy:oy + crop_h, ox:ox + crop_w] if mask is not None else None
                    m_s1 = stage_pyramid(m_)["stage1"] if m_ is not None else None
                    if m_s1 is None or np.any(m_s1 > 0) or not self.random_crop:
                        break
                depth, K, mask = crop(depth, K, mask, crop_h, crop_w, oy, ox)
                depth_ms = stage_pyramid(depth) if depth is not None else None
                mask_ms = stage_pyramid(mask) if mask is not None else None
                depth_values = np.arange(dmin, dint * self.ndepths + dmin, dint,
                                         dtype=np.float32)[: self.ndepths]
            else:
                oy, ox = self._offsets(nprng, h, w, crop_h, crop_w)
                depth, K, mask = crop(depth, K, mask, crop_h, crop_w, oy, ox)
            img = resize_image(img, resize_scale, (oy, ox, crop_h, crop_w))

            gamma = 0.0
            if jitter is not None:
                img = apply_color_jitter(img, jitter, include_gamma=False)
                gamma = jitter["gamma"]
            # the fused (gamma +) ImageNet normalisation in the host library,
            # the JAX package's C pass
            imgs.append(native.crop_normalize(img, 0, 0, img.shape[0], img.shape[1], gamma))
            cams.append(stage_cameras(K, E))

        sample = {
            "imgs": np.stack(imgs).astype(np.float32),  # [V, H, W, 3]
            "cams": {k: np.stack([c[k] for c in cams]) for k in cams[0]},  # {stageN: [V, 2, 4, 4]}
            "depth_values": depth_values,
            "filename": f"{scan}/{{}}/{view_ids[0]:0>8}{{}}",
        }
        if depth_ms is not None:
            sample["depth_gt"] = depth_ms
            sample["mask"] = mask_ms
        return sample


class DTUTrainDataset(MVSTrainDataset):
    """DTU multi-scale training layout: metas = scan x reference view x 7
    lights; Rectified_raw images, Cameras/, Depths_raw ground truth and
    visibility masks (depth_visual > 10)."""

    def __init__(self, datapath, listfile, mode="train", **kwargs):
        super().__init__(**kwargs)
        self.datapath = datapath
        self.mode = mode
        if mode != "train":
            self.random_crop = False
            self.augment = False
        with open(listfile) as f:
            scans = [ln.strip() for ln in f if ln.strip()]
        pairs = read_pair_file(os.path.join(datapath, "Cameras/pair.txt"))
        self.metas = [(scan, light, ref, srcs) for scan in scans for ref, srcs in pairs
                      for light in range(7)]

    def load_view(self, meta, vid, want_depth):
        scan, light_idx, _, _ = meta
        img = read_image(os.path.join(
            self.datapath, f"Rectified_raw/{scan}/rect_{vid + 1:0>3}_{light_idx}_r5000.png"))
        K, E, dmin, dint, _ = read_cam_file(
            os.path.join(self.datapath, f"Cameras/{vid:0>8}_cam.txt"), self.interval_scale)
        depth = mask = None
        if want_depth:
            depth = read_pfm(os.path.join(
                self.datapath, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm"))[0]
            m = read_png(os.path.join(
                self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")).astype(np.float32)
            mask = (m > 10).astype(np.float32)
        return img, depth, mask, K, E, dmin, dint


class BlendedTrainDataset(MVSTrainDataset):
    """BlendedMVS layout: {scan}/blended_images/{id:08d}.jpg,
    {scan}/cams/{id:08d}_cam.txt and pair.txt, and
    {scan}/rendered_depth_maps/{id:08d}.pfm, each scan flat under datapath
    or nested as {scan}/{scan}/{scan}. metas = every reference view with a
    source (light 0); the sources are shuffled within the pair's top 7; the
    mask is depth > 0; a cam file with a depth_num field has its interval
    re-derived as (depth_max - depth_min) / ndepths * interval_scale.

    A view is read by several samples and its JPEG takes seconds to decode
    at BlendedMVS's 1536 x 2048 (PERF.md): the dataset keeps the decoded
    pixels of its last CACHED_VIEWS views (`views`, read-only; every sample
    converts them into arrays of its own).
    """

    CACHED_VIEWS = 16  # 16 x 1536 x 2048 x 3 bytes = 151 MB

    def __init__(self, datapath, listfile, mode="train", **kwargs):
        super().__init__(**kwargs)
        self.datapath = datapath
        self.mode = mode
        if mode != "train":
            self.random_crop = False
            self.augment = False
        with open(listfile) as f:
            scans = [ln.strip() for ln in f if ln.strip()]
        self.metas = []
        for scan in scans:
            pair_path = os.path.join(datapath, scan, "cams", "pair.txt")
            if not os.path.exists(pair_path):
                pair_path = os.path.join(datapath, scan, scan, scan, "cams", "pair.txt")
            self.metas += [(scan, 0, ref, srcs) for ref, srcs in read_pair_file(pair_path)
                           if len(srcs) > 0]
        self.views = DecodedImages(self.CACHED_VIEWS)

    def shuffle_src_views(self, src_views, rng):
        srcs = list(src_views[:7])
        rng.shuffle(srcs)
        return srcs

    def _scan_dir(self, scan):
        d = os.path.join(self.datapath, scan)
        nested = os.path.join(d, scan, scan)
        return nested if os.path.isdir(nested) else d

    def load_view(self, meta, vid, want_depth):
        base = self._scan_dir(meta[0])
        pixels = self.views.get(os.path.join(base, "blended_images", f"{vid:0>8}.jpg"))
        img = np.asarray(pixels, np.float32) / 255.0
        K, E, dmin, dint, extra = read_cam_file(
            os.path.join(base, "cams", f"{vid:0>8}_cam.txt"), self.interval_scale)
        if extra.get("depth_num", 0) > 0:
            dint = (extra["depth_max"] - dmin) / self.ndepths * self.interval_scale
        depth = mask = None
        if want_depth:
            depth = read_pfm(os.path.join(base, "rendered_depth_maps", f"{vid:0>8}.pfm"))[0]
            mask = (depth > 0).astype(np.float32)
        return img, depth, mask, K, E, dmin, dint
