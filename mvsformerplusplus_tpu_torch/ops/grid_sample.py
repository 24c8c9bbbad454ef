"""Bilinear sampling and the plane-sweep warp (counterpart of
mvsformerplusplus_tpu/ops/grid_sample.py). The warp is exact, so none of the
JAX package's windowed samplers (grouped / banded) are needed."""
from __future__ import annotations

import torch

from .cuda.warp import WarpBilinear, warp_bilinear_plain
from .geometry import plane_sweep_coords

Tensor = torch.Tensor


# img [B, H, W, C] sampled at pixel-unit (x, y) coords [B, ..., 2] with
# grid_sample(bilinear, zeros, align_corners=True) semantics -> f32: the warp
# kernel's plain version
bilinear_sample = warp_bilinear_plain


def homography_warp(src_feat: Tensor, src_proj: Tensor, ref_proj: Tensor,
                    depth_values: Tensor):
    """Warp src features [B, H, W, C] into the ref frustum at depth_values
    ([B, D] or [B, D, H, W]). Returns (warped [B, D, H, W, C] f32, invalid
    [B, D, H, W] bool). CUDA tensors go through the warp kernel. The
    features get the warp's exact image gradient; the coordinates get none
    (the JAX warp stops their gradient)."""
    b, h, w, _ = src_feat.shape
    coords, invalid = plane_sweep_coords(src_proj, ref_proj, depth_values, h, w)
    return WarpBilinear.apply(src_feat, coords.detach()), invalid
