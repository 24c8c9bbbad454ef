"""Depth-hypothesis schedulers and regressions, fp32 (counterpart of
mvsformerplusplus_tpu/ops/sampling.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import resize_hw_axes

Tensor = torch.Tensor


def _itv(ndepths: int, device) -> Tensor:
    return torch.arange(ndepths, dtype=torch.float32, device=device) / (ndepths - 1)


def init_range(cur_depth: Tensor, ndepths: int, height: int, width: int) -> Tensor:
    """Uniform-in-depth init: [B, Dfull] -> [B, D, H, W]."""
    cur_depth = cur_depth.float()
    dmin, dmax = cur_depth[:, 0], cur_depth[:, -1]
    step = (dmax - dmin) / (ndepths - 1)
    samples = dmin[:, None] + torch.arange(ndepths, dtype=torch.float32,
                                           device=cur_depth.device)[None] * step[:, None]
    return samples[:, :, None, None].expand(-1, -1, height, width)


def init_inverse_range(cur_depth: Tensor, ndepths: int, height: int, width: int) -> Tensor:
    """Uniform-in-inverse-depth init: [B, Dfull] -> [B, D, H, W], depth
    descending along D."""
    cur_depth = cur_depth.float()
    inv_min = 1.0 / cur_depth[:, 0]
    inv_max = 1.0 / cur_depth[:, -1]
    inv = inv_max[:, None] + (inv_min - inv_max)[:, None] * _itv(ndepths, cur_depth.device)[None]
    return (1.0 / inv)[:, :, None, None].expand(-1, -1, height, width)


def schedule_inverse_range(depth: Tensor, depth_hypo: Tensor, ndepths: int, split_itv: float,
                           height: int, width: int) -> Tensor:
    """Band of ±split_itv·(previous inverse interval) around 1/depth, upsampled
    bilinearly (align_corners=True) to [B, D, height, width]."""
    depth = depth.float()
    depth_hypo = depth_hypo.float()
    last_itv = 1.0 / depth_hypo[:, 2] - 1.0 / depth_hypo[:, 1]
    inv_min = 1.0 / depth + split_itv * last_itv
    inv_max = 1.0 / depth - split_itv * last_itv
    itv = _itv(ndepths, depth.device)
    inv = inv_max[:, None] + (inv_min - inv_max)[:, None] * itv[None, :, None, None]
    inv = resize_hw_axes(inv, height, width, h_axis=-2, w_axis=-1, method="linear",
                         align_corners=True)
    return 1.0 / inv


def schedule_range(cur_depth: Tensor, ndepths: int, depth_interval_pixel: Tensor,
                   height: int, width: int) -> Tensor:
    """Metric-depth band of ±(D/2)·interval around cur_depth [B, h, w]."""
    cur_depth = cur_depth.float()
    if depth_interval_pixel.ndim == 1:
        depth_interval_pixel = depth_interval_pixel[:, None, None]
    dmin = torch.clamp(cur_depth - ndepths / 2 * depth_interval_pixel, min=0.001)
    dmax = cur_depth + ndepths / 2 * depth_interval_pixel
    step = (dmax - dmin) / (ndepths - 1)
    samples = dmin[:, None] + torch.arange(
        ndepths, dtype=torch.float32, device=cur_depth.device)[None, :, None, None] * step[:, None]
    return resize_hw_axes(samples, height, width, h_axis=-2, w_axis=-1, method="linear",
                          align_corners=True)


def depth_regression(prob: Tensor, depth_values: Tensor) -> Tensor:
    """Soft-argmax depth: sum_d p(d)·depth(d); prob [B, D, H, W]."""
    if depth_values.ndim == 2:
        depth_values = depth_values[:, :, None, None]
    return torch.sum(prob * depth_values, dim=1)


def conf_regression(prob: Tensor, n: int = 4) -> Tensor:
    """Probability mass in an n-bin window around the soft-argmax bin:
    [B, D, H, W] -> [B, H, W]."""
    b, d, h, w = prob.shape
    prob = prob.float()
    pad = (n // 2, n // 2) if n % 2 == 1 else (n // 2 - 1, n // 2)
    padded = F.pad(prob, (0, 0, 0, 0, pad[0], pad[1]))
    csum = torch.cat([torch.zeros_like(padded[:, :1]), torch.cumsum(padded, dim=1)], dim=1)
    win = csum[:, n:] - csum[:, :-n]
    idx = depth_regression(prob, torch.arange(d, dtype=torch.float32, device=prob.device)[None])
    idx = idx.to(torch.int64).clamp(0, d - 1)
    return torch.gather(win, 1, idx[:, None]).squeeze(1)
