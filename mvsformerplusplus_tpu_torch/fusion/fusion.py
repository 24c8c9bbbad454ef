"""Geometric-consistency depth fusion (counterpart of
mvsformerplusplus_tpu/fusion/fusion.py), in fp32 on the tensors' device:

- `pcd_fuse`: static thresholds; each source depth map is reprojected into
  the reference view, views that agree within a pixel distance and a
  relative depth are counted, and the agreeing depths averaged;
- `dpcd_fuse`: dynamic thresholds k / dist_base and k / rel_diff_base
  over k = 2 .. V agreeing source views (the round trip ref -> src -> ref);
- `gipuma_fuse`: fusibile's semantics (probability filter, nearest-pixel
  absolute depth agreement, the mean of the supporting world points).

Pixel centres are at (x + 0.5, y + 0.5); cameras are [2, 4, 4] stacks
(extrinsic; intrinsic in the top-left 3 x 3). The products are fp32 (the
JAX package uses Precision.HIGHEST; the caller keeps TF32 off on the card).
The bilinear samples of a depth map (C=1) and of the (x, y, depth) field
(C=3) go through the warp kernel (ops/cuda/warp.py) with the field padded
to 4 f32 channels, the vector kernel's width; on CPU tensors its plain
version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cuda.warp import warp_bilinear

Tensor = torch.Tensor


def _pixel_grid_center(h: int, w: int, device=None) -> Tensor:
    """[H, W, 3] homogeneous (x + 0.5, y + 0.5, 1)."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
                          torch.arange(w, dtype=torch.float32, device=device) + 0.5,
                          indexing="ij")
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _mat(m: Tensor, pts: Tensor) -> Tensor:
    """m [..., i, j] applied to pts [..., H, W, j] -> [..., H, W, i]."""
    return torch.einsum("...ij,...hwj->...hwi", m, pts)


def _img2cam(xy1: Tensor, depth: Tensor, cam: Tensor) -> Tensor:
    """Pixel homogeneous [..., H, W, 3] and depth [..., H, W] -> camera
    homogeneous [..., H, W, 4]."""
    pts = _mat(torch.linalg.inv(cam[..., 1, :3, :3]), xy1)
    pts = pts / (pts[..., 2:3] + 1e-9) * depth[..., None]
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _cam2world(pts: Tensor, cam: Tensor) -> Tensor:
    out = _mat(torch.linalg.inv(cam[..., 0, :, :]), pts)
    return out / (out[..., 3:4] + 1e-9)


def _world2cam(pts: Tensor, cam: Tensor) -> Tensor:
    out = _mat(cam[..., 0, :, :], pts)
    return out / (out[..., 3:4] + 1e-9)


def _cam2img(pts: Tensor, cam: Tensor) -> Tensor:
    p3 = pts[..., :3] / (pts[..., 3:4] + 1e-9)
    out = _mat(cam[..., 1, :3, :3], p3)
    return out / (out[..., 2:3] + 1e-9)


def bilinear_sample(img: Tensor, coords: Tensor) -> Tensor:
    """img [V, H, W, C <= 4] sampled at pixel (x, y) coords [V, H', W', 2]
    (grid_sample bilinear, zeros padding, align_corners=True) ->
    [V, H', W', C] f32, through the warp kernel at C = 4."""
    c = img.shape[-1]
    padded = F.pad(img.float(), (0, 4 - c))
    return warp_bilinear(padded, coords.float().contiguous())[..., :c]


def project_ref(ref_depth: Tensor, ref_cam: Tensor, src_cams: Tensor) -> Tensor:
    """Each ref pixel's point at its depth, projected into each source view:
    ref_depth [H, W], ref_cam [2, 4, 4], src_cams [V, 2, 4, 4] -> the
    source image's homogeneous pixel [V, H, W, 3] (centre convention)."""
    v = src_cams.shape[0]
    h, w = ref_depth.shape
    xy1 = _pixel_grid_center(h, w, ref_depth.device)
    ref_cam_v = ref_cam.expand(v, 2, 4, 4)
    world = _cam2world(_img2cam(xy1[None], ref_depth.expand(v, h, w), ref_cam_v), ref_cam_v)
    return _cam2img(_world2cam(world, src_cams), src_cams)


def reproject_dynamic(ref_depth: Tensor, src_depths: Tensor, ref_cam: Tensor,
                      src_cams: Tensor) -> Tensor:
    """The ref -> src -> ref round trip: ref_depth [H, W], src_depths
    [V, H, W], ref_cam [2, 4, 4], src_cams [V, 2, 4, 4] -> [V, H, W, 3],
    the (x + 0.5, y + 0.5) ref-pixel position and ref-frame depth of each
    source view's surface. The source depth is sampled at the projected
    pixel taken as align_corners=True coordinates, as the reference's
    grid_sample does."""
    ref_cam_v = ref_cam.expand(src_cams.shape[0], 2, 4, 4)
    src_img_pts = project_ref(ref_depth, ref_cam, src_cams)
    sampled = bilinear_sample(src_depths[..., None], src_img_pts[..., :2])[..., 0]
    world2 = _cam2world(_img2cam(src_img_pts, sampled, src_cams), src_cams)
    back_cam = _world2cam(world2, ref_cam_v)
    back_img = _cam2img(back_cam, ref_cam_v)
    return torch.cat([back_img[..., :2], back_cam[..., 2:3]], dim=-1)


def vis_filter_dynamic(ref_depth: Tensor, reproj_xyd: Tensor, dist_base: float = 4.0,
                       rel_diff_base: float = 1300.0):
    """Dynamic consistency: masks [V, V-1, H, W] (view v consistent at
    relaxation level k = 2 .. V) and the strictest level's mask [V, H, W]."""
    v, h, w, _ = reproj_xyd.shape
    xy = _pixel_grid_center(h, w, ref_depth.device)[..., :2]
    coord_diff = torch.linalg.vector_norm(reproj_xyd[..., :2] - xy[None], dim=-1)
    depth_diff = (ref_depth[None] - reproj_xyd[..., 2]).abs() / (ref_depth[None] + 1e-9)
    ks = torch.arange(2, v + 1, dtype=torch.float32, device=ref_depth.device)
    masks = ((coord_diff[:, None] < (ks / dist_base)[None, :, None, None])
             & (depth_diff[:, None] < (ks / rel_diff_base)[None, :, None, None]))
    return masks, masks[:, -1]


def dpcd_fuse(ref_depth: Tensor, ref_conf: Tensor, src_depths: Tensor, ref_cam: Tensor,
              src_cams: Tensor, conf_thresh: float = 0.5, dist_base: float = 4.0,
              rel_diff_base: float = 1300.0):
    """The dpcd filter of one reference view -> (world points [H, W, 3],
    mask [H, W] bool)."""
    v = src_depths.shape[0]
    dy_range = v + 1
    reproj = reproject_dynamic(ref_depth, src_depths, ref_cam, src_cams)
    masks, vis_mask = vis_filter_dynamic(ref_depth, reproj, dist_base, rel_diff_base)
    reproj_depth = torch.where(vis_mask, reproj[..., 2], 0.0)
    geo_mask_sums = masks.int().sum(dim=0)  # [V-1, H, W]
    geo_mask_sum = vis_mask.int().sum(dim=0)
    depth_avg = (reproj_depth.sum(dim=0) + ref_depth) / (geo_mask_sum + 1)
    geo_mask = geo_mask_sum >= dy_range
    for i in range(2, dy_range):
        geo_mask = geo_mask | (geo_mask_sums[i - 2] >= i)
    mask = geo_mask & (ref_conf > conf_thresh)
    h, w = ref_depth.shape
    xy1 = _pixel_grid_center(h, w, ref_depth.device)
    return _cam2world(_img2cam(xy1, depth_avg, ref_cam), ref_cam)[..., :3], mask


def reproject_static(ref_depth: Tensor, src_depths: Tensor, ref_cam: Tensor,
                     src_cams: Tensor):
    """src -> ref reprojection of the pcd filter: each source surface's
    (x_ref, y_ref, d_ref), resampled at the ref grid through the ref depth:
    at the ref pixel's projection scaled by (size - 1) / size (the
    reference's /width normalisation under align_corners=True). Returns
    reproj_xyd [V, H, W, 3], in_range [V, H, W]."""
    v, h, w = src_depths.shape
    xy1 = _pixel_grid_center(h, w, ref_depth.device)
    ref_cam_v = ref_cam.expand(v, 2, 4, 4)
    world = _cam2world(_img2cam(xy1[None], src_depths, src_cams), src_cams)
    ref_cam_pts = _world2cam(world, ref_cam_v)
    ref_img_pts = _cam2img(ref_cam_pts, ref_cam_v)
    xyd_src = torch.cat([ref_img_pts[..., :2], ref_cam_pts[..., 2:3]], dim=-1)
    wc = project_ref(ref_depth, ref_cam, src_cams)[..., :2]
    in_range = ((wc[..., 0] / w >= 0) & (wc[..., 0] / w <= 1)
                & (wc[..., 1] / h >= 0) & (wc[..., 1] / h <= 1))
    coords = torch.stack([wc[..., 0] / w * (w - 1), wc[..., 1] / h * (h - 1)], dim=-1)
    return bilinear_sample(xyd_src, coords), in_range


def vis_filter_static(ref_depth: Tensor, reproj_xyd: Tensor, in_range: Tensor,
                      img_dist_thresh: float, depth_thresh: float, vthresh: float):
    """Static thresholds: per-view masks [V, H, W] and the count rule's
    mask [H, W]."""
    h, w = ref_depth.shape
    xy = _pixel_grid_center(h, w, ref_depth.device)[..., :2]
    dist_ok = torch.linalg.vector_norm(reproj_xyd[..., :2] - xy[None], dim=-1) < img_dist_thresh
    depth_ok = (ref_depth[None] - reproj_xyd[..., 2]).abs() < (
        torch.maximum(ref_depth[None], reproj_xyd[..., 2]) * depth_thresh)
    masks = in_range & dist_ok & depth_ok
    return masks, masks.float().sum(dim=0) >= (vthresh - 1.1)


def pcd_fuse(ref_depth: Tensor, ref_conf: Tensor, src_depths: Tensor, src_confs: Tensor,
             ref_cam: Tensor, src_cams: Tensor, conf_thresh: float = 0.5,
             img_dist_thresh: float = 1.0, depth_thresh: float = 0.01, vthresh: float = 4.0):
    """The static pcd filter of one reference view -> (world points
    [H, W, 3], mask [H, W] bool)."""
    src_depths = torch.where(src_confs > conf_thresh, src_depths, 0.0)
    reproj, in_range = reproject_static(ref_depth, src_depths, ref_cam, src_cams)
    masks, vis_mask = vis_filter_static(ref_depth, reproj, in_range, img_dist_thresh,
                                        depth_thresh, vthresh)
    fused = ((reproj[..., 2] * masks).sum(dim=0) + ref_depth) / (masks.float().sum(dim=0) + 1)
    mask = vis_mask & (ref_conf > conf_thresh)
    h, w = ref_depth.shape
    xy1 = _pixel_grid_center(h, w, ref_depth.device)
    return _cam2world(_img2cam(xy1, fused, ref_cam), ref_cam)[..., :3], mask


def gipuma_fuse(ref_depth: Tensor, ref_conf: Tensor, src_depths: Tensor, src_confs: Tensor,
                ref_cam: Tensor, src_cams: Tensor, prob_threshold: float = 0.5,
                disp_threshold: float = 0.1, num_consistent: int = 3):
    """fusibile-semantics fusion of one reference view: every depth zeroed
    where its confidence <= prob_threshold; a source is consistent where
    the ref pixel's point, projected into it, lands on a pixel whose depth
    agrees within |z_proj - d_src| < disp_threshold (absolute depth units,
    nearest pixel floor(u)); a ref pixel with >= num_consistent consistent
    sources emits the mean of its world point and theirs.

    Returns points [H, W, 3], mask [H, W] bool, consistent [V, H, W] bool
    and src_px [V, H, W, 2] int32, the (x, y) source pixel each ref pixel
    projected to (the caller's duplicate suppression)."""
    v, h, w = src_depths.shape
    src_depths = torch.where(src_confs > prob_threshold, src_depths, 0.0)
    ref_valid = (ref_conf > prob_threshold) & (ref_depth > 0)
    xy1 = _pixel_grid_center(h, w, ref_depth.device)
    ref_world = _cam2world(_img2cam(xy1, ref_depth, ref_cam), ref_cam)  # [H, W, 4]
    src_cam_pts = _world2cam(ref_world.expand(v, h, w, 4), src_cams)
    z_proj = src_cam_pts[..., 2]
    img_pts = _cam2img(src_cam_pts, src_cams)
    ux = torch.floor(img_pts[..., 0]).int()
    uy = torch.floor(img_pts[..., 1]).int()
    in_bounds = (ux >= 0) & (ux < w) & (uy >= 0) & (uy < h) & (z_proj > 0)
    uxc, uyc = ux.clamp(0, w - 1), uy.clamp(0, h - 1)
    d_src = src_depths.reshape(v, -1).gather(1, (uyc * w + uxc).reshape(v, -1).long())
    d_src = d_src.reshape(v, h, w)
    consistent = in_bounds & (d_src > 0) & ((z_proj - d_src).abs() < disp_threshold)
    sxy1 = torch.stack([uxc.float() + 0.5, uyc.float() + 0.5, torch.ones_like(z_proj)], dim=-1)
    src_world = _cam2world(_img2cam(sxy1, d_src, src_cams), src_cams)[..., :3]
    cnt = consistent.float().sum(dim=0)
    mask = ref_valid & (cnt >= num_consistent)
    fused = (ref_world[..., :3] + (src_world * consistent[..., None]).sum(dim=0)) / (
        cnt[..., None] + 1.0)
    return fused, mask, consistent, torch.stack([uxc, uyc], dim=-1)
