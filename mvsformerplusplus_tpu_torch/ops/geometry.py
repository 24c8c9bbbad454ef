"""Camera geometry for plane-sweep MVS, fp32 (counterpart of
mvsformerplusplus_tpu/ops/geometry.py).

A camera is a [..., 2, 4, 4] stack: [..., 0] the world->cam extrinsic,
[..., 1, :3, :3] the intrinsic. Pixel (0, 0) is the centre of the top-left
pixel (align_corners=True convention).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def compose_projection(cam: Tensor) -> Tensor:
    """[..., 2, 4, 4] camera stack -> 4x4 projection: top rows K @ E[:3, :4],
    last row from the extrinsic."""
    cam = cam.float()
    ext = cam[..., 0, :, :]
    intr = cam[..., 1, :3, :3]
    top = intr @ ext[..., :3, :4]
    return torch.cat([top, ext[..., 3:4, :4]], dim=-2)


def pixel_grid(height: int, width: int, device=None) -> Tensor:
    """Homogeneous pixel coordinates [3, H*W] (rows x, y, 1), fp32."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), torch.ones_like(x).reshape(-1)])


def plane_sweep_coords(src_proj: Tensor, ref_proj: Tensor, depth_values: Tensor,
                       height: int, width: int):
    """Project every ref pixel at every depth hypothesis into the src image.

    src_proj/ref_proj: [B, 4, 4]; depth_values: [B, D] or [B, D, H, W].
    Returns coords [B, D, H, W, 2] (x, y) in src pixel units and the invalid
    mask [B, D, H, W] (outside the image or behind the camera).
    """
    b = src_proj.shape[0]
    d = depth_values.shape[1]
    proj = src_proj.float() @ torch.linalg.inv(ref_proj.float())
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3]
    xyz = pixel_grid(height, width, device=src_proj.device)
    rot_xyz = torch.einsum("bij,jn->bin", rot, xyz)  # [B, 3, HW]
    depth = depth_values.float().reshape(b, 1, d, -1)
    proj_xyz = rot_xyz[:, :, None, :] * depth + trans[:, :, None, None]  # [B, 3, D, HW]
    z = proj_xyz[:, 2]
    proj_xy = proj_xyz[:, :2] / (z[:, None] + 1e-6)
    x, y = proj_xy[:, 0], proj_xy[:, 1]
    x_norm = x / ((width - 1) / 2) - 1
    y_norm = y / ((height - 1) / 2) - 1
    invalid = (x_norm.abs() > 1) | (y_norm.abs() > 1) | (z <= 0)
    coords = torch.stack([x, y], dim=-1).reshape(b, d, height, width, 2)
    return coords, invalid.reshape(b, d, height, width)


def get_position_3d(intrinsics: Tensor, depth_values: Tensor, height: int, width: int,
                    depth_min, depth_max, bounds=None):
    """Normalized camera-space XYZ per (depth, pixel) for the 3D PE.

    intrinsics [B, 3, 3]; depth_values [B, D] or [B, D, H, W]. Returns
    (position3d [B, 3, D, H, W] in [0, 1], bounds) where bounds =
    (w_min, w_max, h_min, h_max) is computed here when not given and reused
    by later stages.
    """
    b = intrinsics.shape[0]
    d = depth_values.shape[1]
    xyz = pixel_grid(height, width, device=intrinsics.device)
    cam_rays = torch.einsum("bij,jn->bin", torch.linalg.inv(intrinsics.float()), xyz)
    depth = depth_values.float().reshape(b, 1, d, -1)
    pos = cam_rays[:, :, None, :] * depth  # [B, 3, D, HW]
    if bounds is None:
        bounds = (pos[:, 0].min(), pos[:, 0].max(), pos[:, 1].min(), pos[:, 1].max())
    w_min, w_max, h_min, h_max = bounds
    px = (pos[:, 0] - w_min) / (w_max - w_min + 1e-5)
    py = (pos[:, 1] - h_min) / (h_max - h_min + 1e-5)
    pz = (pos[:, 2].clamp(depth_min, depth_max) - depth_min) / (depth_max - depth_min + 1e-5)
    position3d = torch.stack([px, py, pz], dim=1).reshape(b, 3, d, height, width)
    return position3d, bounds
