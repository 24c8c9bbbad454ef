"""Evaluation dataset for DTU / Tanks&Temples / ETH3D / custom scans
(counterpart of mvsformerplusplus_tpu/data/eval_dataset.py): the MVSNet
scan layout (images/*.jpg, cams/*_cam.txt, pair.txt), per-scene interval
scale, T&T's 4-row edge pad with the cy shift, a resize toward max_h x
max_w rounded down to multiples of 64 (exactly max_h x max_w with
fix_res), per-stage intrinsics, and the optional DTU ground-truth depth.

A view is read by the samples whose reference or sources it is: each
dataset keeps the decoded uint8 pixels of its last max(CACHED_VIEWS,
2 x the most views a sample reads) views, room for what the eval loader's
two threads read between two reads of a view. So a sweep over a scan whose
pair file lists each view's nearest sources first along the camera path
(as the converters write it) decodes each view once
(tests/test_torch_eval_data.py, on scans several times a sample long); a
least-recently-used cache smaller than a sample's views misses on nearly
every read. The resize is the host library's (native.resize_linear, cv2's
INTER_LINEAR bit for bit at the eval scripts' sizes).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native
from .io import DecodedImages, read_cam_file, read_pair_file, read_pfm
from .mvs_dataset import stage_cameras
from .transforms import normalize_imagenet

# the least number of decoded views kept: 16 x 1200 x 1600 x 3 bytes = 92 MB at
# DTU's size, 1.2 GB at ETH3D's 4032 x 6048; more where a sample reads more
# than 8 views (22 x 6.2 MB at Tanks and Temples' 11)
CACHED_VIEWS = 16


class EvalDataset:
    def __init__(self, datapath, scan_list: Sequence[str], nviews=5, ndepths=192,
                 interval_scale=1.06, max_h=1152, max_w=1536, fix_res=False,
                 dataset_name="dtu", gt_depth_path: Optional[str] = None):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h = max_h
        self.max_w = max_w
        self.fix_res = fix_res
        self.dataset_name = dataset_name
        self.gt_depth_path = gt_depth_path
        if isinstance(interval_scale, dict):
            self.interval_scale = interval_scale
        else:
            self.interval_scale = {s: interval_scale for s in scan_list}
        self.metas: List[Tuple[str, int, List[int]]] = []
        for scan in scan_list:
            for ref, srcs in read_pair_file(os.path.join(datapath, scan, "pair.txt")):
                if len(srcs) > 0:
                    self.metas.append((scan, ref, srcs))
        reads = max((1 + min(len(srcs), nviews - 1) for _, _, srcs in self.metas), default=1)
        self.views = DecodedImages(max(CACHED_VIEWS, 2 * reads))

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, scan, vid):
        path = os.path.join(self.datapath, scan, "cams", f"{vid:0>8}_cam.txt")
        if not os.path.exists(path):
            path = os.path.join(self.datapath, scan, "cams_1", f"{vid:0>8}_cam.txt")
        K, E, dmin, raw_int, extra = read_cam_file(path, 1.0)
        if self.dataset_name == "eth3d":
            # eth3d cams: the second field of the range line is depth_max
            dint = (raw_int - dmin) / self.ndepths
        elif "depth_num" in extra and extra["depth_num"] > 0:
            # a cam with its own hypothesis count: that range over this ndepths
            dmax = dmin + extra["depth_num"] * raw_int
            dint = (dmax - dmin) / self.ndepths
        else:
            dint = raw_int
        dint *= self.interval_scale[scan]
        return K, E, dmin, dint

    def _pixels(self, scan, vid) -> np.ndarray:
        """The view's decoded uint8 RGB (images/, else images_post/), from
        the cache or the file."""
        path = os.path.join(self.datapath, scan, "images", f"{vid:0>8}.jpg")
        if not os.path.exists(path):
            path = os.path.join(self.datapath, scan, "images_post", f"{vid:0>8}.jpg")
        return self.views.get(path)

    def _scale_to_max(self, img, K):
        """Resize toward (max_h, max_w): with fix_res exactly there, else by
        the smaller of the two ratios (up or down) rounded down to multiples
        of 64, so the cascade's stride-8 U-Nets divide evenly; K follows."""
        h, w = img.shape[:2]
        if self.fix_res:
            new_h, new_w = self.max_h, self.max_w
        else:
            scale = min(self.max_h / h, self.max_w / w)
            new_h = int(h * scale) // 64 * 64
            new_w = int(w * scale) // 64 * 64
        sx, sy = new_w / w, new_h / h
        img = native.resize_linear(img, new_h, new_w)
        K = K.copy()
        K[0] *= sx
        K[1] *= sy
        return img, K

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, cams = [], []
        depth_values = gt_depth = ref_img = None
        for i, vid in enumerate(view_ids):
            img = np.asarray(self._pixels(scan, vid), np.float32) / 255.0
            K, E, dmin, dint = self._read_cam(scan, vid)
            if self.dataset_name == "tt":
                # T&T: 4 rows of edge pad top and bottom (1080 -> 1088), cy shifted
                img = np.pad(img, ((4, 4), (0, 0), (0, 0)), mode="edge")
                K = K.copy()
                K[1, 2] += 4.0
            img, K = self._scale_to_max(img, K)
            if i == 0:
                ref_img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                depth_values = np.arange(
                    dmin, dint * self.ndepths + dmin, dint, dtype=np.float32)[: self.ndepths]
                if self.gt_depth_path is not None:
                    gt_file = os.path.join(self.gt_depth_path, scan, f"depth_map_{vid:0>4}.pfm")
                    if os.path.exists(gt_file):
                        gt_depth = read_pfm(gt_file)[0].astype(np.float32)
            imgs.append(normalize_imagenet(img))
            cams.append(stage_cameras(K, E))

        sample = {
            "imgs": np.stack(imgs).astype(np.float32),
            "cams": {k: np.stack([c[k] for c in cams]) for k in cams[0]},
            "depth_values": depth_values,
            "filename": f"{scan}/{{}}/{view_ids[0]:0>8}{{}}",
            "scan": scan,
            "ref_view": ref_view,
            "ref_img": ref_img,
        }
        if gt_depth is not None:
            sample["gt_depth"] = gt_depth
        return sample
