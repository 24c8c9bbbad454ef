"""Sinusoidal position encodings (counterpart of mvsformerplusplus_tpu/ops/pe.py)."""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

Tensor = torch.Tensor


@lru_cache(maxsize=None)
def _sine_pe_2d_np(d_model: int, height: int, width: int, norm_h: int, norm_w: int) -> np.ndarray:
    """[H, W, C] resolution-normalized 2-D sine PE: 1-based positions scaled
    by max_shape/size; channels interleave sin/cos of x then y."""
    y_pos = np.broadcast_to(np.arange(1, height + 1, dtype=np.float64)[:, None] * norm_h / height,
                            (height, width))
    x_pos = np.broadcast_to(np.arange(1, width + 1, dtype=np.float64)[None, :] * norm_w / width,
                            (height, width))
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float64)
                 * (-math.log(10000.0) / (d_model // 2)))
    pe = np.zeros((d_model, height, width), dtype=np.float64)
    pe[0::4] = np.sin(x_pos[None] * div[:, None, None])
    pe[1::4] = np.cos(x_pos[None] * div[:, None, None])
    pe[2::4] = np.sin(y_pos[None] * div[:, None, None])
    pe[3::4] = np.cos(y_pos[None] * div[:, None, None])
    return np.moveaxis(pe.astype(np.float32), 0, -1)


def sine_pe_2d(d_model: int, height: int, width: int, max_shape=(128, 128), device=None) -> Tensor:
    """Resolution-normalized sine PE, [H, W, C] fp32."""
    return torch.from_numpy(_sine_pe_2d_np(d_model, height, width, max_shape[0], max_shape[1])
                            ).to(device)


def position_encoding_3d_parts(position3d: Tensor, channels: int, rescale: float = 4.0) -> Tensor:
    """Per-axis sin/cos encoding [B, 3, D, H, W, C] (channel interleaves sin/cos)."""
    b, _, d, h, w = position3d.shape
    div = torch.exp(torch.arange(0, channels, 2, dtype=torch.float32, device=position3d.device)
                    * (-math.log(10000.0) / channels))
    ang = (position3d.float() * rescale)[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(b, 3, d, h, w, channels)


def position_encoding_3d(position3d: Tensor, channels: int, rescale: float = 4.0) -> Tensor:
    """[B, 3, D, H, W] in [0, 1] -> [B, D, H, W, 3*channels] (x, y, z concat)."""
    b, _, d, h, w = position3d.shape
    inter = position_encoding_3d_parts(position3d, channels, rescale)
    return torch.movedim(inter, 1, -2).reshape(b, d, h, w, 3 * channels)
