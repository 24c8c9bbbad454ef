"""Depth-map validation metrics (counterpart of
mvsformerplusplus_tpu/train/metrics.py), in torch.

Masked means over the valid ground-truth pixels of each image, averaged over
the batch. Thresholds are nominal millimetres scaled per sample by `scale`
(scalar or [B]): di / 2.65 for DTU-format data, which is exactly N mm at the
standard 2.5 x 1.06 interval, and di for BlendedMVS, whose scenes have no
metric scale.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor
Scale = Union[float, Tensor]


def _per_image_masked_mean(value: Tensor, mask: Tensor) -> Tensor:
    """value, mask [B, H, W] -> [B] mean over the mask (0 where it is empty)."""
    m = mask.float()
    return (value * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1.0)


def _bhw(scale: Scale, like: Tensor) -> Tensor:
    s = torch.as_tensor(scale, dtype=torch.float32, device=like.device)
    return s[:, None, None] if s.ndim == 1 else s


def thres_metric(depth_est: Tensor, depth_gt: Tensor, mask: Tensor, thres: float,
                 scale: Scale = 1.0) -> Tensor:
    """Fraction of valid pixels with |err| > thres * scale, batch-averaged."""
    err = (depth_est - depth_gt).abs()
    return _per_image_masked_mean((err > thres * _bhw(scale, err)).float(), mask).mean()


def abs_depth_error(depth_est: Tensor, depth_gt: Tensor, mask: Tensor,
                    band: Tuple[float, float] = (0.0, 1e9), scale: Scale = 1.0) -> Tensor:
    """Mean |err| over valid pixels whose err is in scale * [lo, hi)."""
    err = (depth_est - depth_gt).abs()
    s = _bhw(scale, err)
    m = mask.bool() & (err >= band[0] * s) & (err < band[1] * s)
    return _per_image_masked_mean(err, m).mean()


def depth_metrics(depth_est: Tensor, depth_gt: Tensor, mask: Tensor,
                  thresholds: Sequence[float] = (2.0, 4.0, 8.0, 14.0, 20.0),
                  scale: Scale = 1.0) -> Dict[str, Tensor]:
    """The validation metric set: thresNmm error rates, absolute error in
    bands, and mean_error (the mean of the 2/4/8/14 mm rates, the monitor)."""
    out = {f"thres{int(t)}mm_error": thres_metric(depth_est, depth_gt, mask, t, scale)
           for t in thresholds}
    out["abs_depth_error"] = abs_depth_error(depth_est, depth_gt, mask, scale=1.0)
    for lo, hi in ((0, 2), (2, 4), (4, 8), (8, 14)):
        out[f"abs_error_{lo}-{hi}"] = abs_depth_error(depth_est, depth_gt, mask,
                                                      (float(lo), float(hi)), scale)
    out["mean_error"] = (out["thres2mm_error"] + out["thres4mm_error"] + out["thres8mm_error"]
                         + out["thres14mm_error"]) / 4.0
    return out
