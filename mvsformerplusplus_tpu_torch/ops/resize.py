"""Separable resizing as interpolation matmuls (counterpart of
mvsformerplusplus_tpu/ops/resize.py).

A 1-D interpolation is a fixed [out, in] matrix; applying it along H and W
resizes NHWC tensors with torch's exact coordinate rules:
- align_corners=True: src = dst * (in-1)/(out-1);
- align_corners=False: src = (dst+0.5) * in/out - 0.5 (edge-clamped taps);
- an explicit `scale` follows F.interpolate(scale_factor=s):
  src = (dst+0.5)/s - 0.5 (DINOv2's pos-embed "+0.1" resize);
- cubic is Keys a=-0.75; nearest is torch's floor rule.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

Tensor = torch.Tensor


@lru_cache(maxsize=None)
def _interp_matrix_np(in_size: int, out_size: int, method: str, align_corners: bool,
                      scale: float = None) -> np.ndarray:
    """[out_size, in_size] float32 row-stochastic interpolation matrix."""
    if in_size == out_size and scale is None:
        return np.eye(out_size, dtype=np.float32)
    out_i = np.arange(out_size, dtype=np.float64)
    if scale is not None:
        src = (out_i + 0.5) / scale - 0.5
    elif align_corners:
        src = np.zeros_like(out_i) if out_size == 1 else out_i * (in_size - 1) / (out_size - 1)
    else:
        src = (out_i + 0.5) * in_size / out_size - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    if method == "nearest":
        idx = np.clip(np.floor(out_i * in_size / out_size).astype(np.int64), 0, in_size - 1)
        mat[rows, idx] = 1.0
    elif method == "linear":
        x0 = np.floor(src).astype(np.int64)
        frac = src - x0
        for tap, w in ((x0, 1 - frac), (x0 + 1, frac)):
            np.add.at(mat, (rows, np.clip(tap, 0, in_size - 1)), w)
    elif method == "cubic":
        a = -0.75

        def k(x):
            x = np.abs(x)
            return np.where(x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
                            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))

        x0 = np.floor(src).astype(np.int64)
        frac = src - x0
        for offset in (-1, 0, 1, 2):
            np.add.at(mat, (rows, np.clip(x0 + offset, 0, in_size - 1)), k(frac - offset))
    else:
        raise ValueError(f"unknown resize method {method}")
    return mat.astype(np.float32)


def interp_matrix(in_size: int, out_size: int, method: str = "linear",
                  align_corners: bool = False, scale: float = None,
                  device=None, dtype=torch.float32) -> Tensor:
    return torch.from_numpy(_interp_matrix_np(in_size, out_size, method, align_corners, scale)
                            ).to(device=device, dtype=dtype)


def resize2d(x: Tensor, out_h: int, out_w: int, method: str = "linear",
             align_corners: bool = False, scale_h: float = None,
             scale_w: float = None) -> Tensor:
    """Resize [..., H, W, C] to [..., out_h, out_w, C].

    fp32 inputs interpolate in fp32; bf16 inputs multiply by bf16 matrices
    with fp32 accumulation and round once per axis, as the JAX package does.
    """
    h, w = x.shape[-3], x.shape[-2]
    if h == out_h and w == out_w and scale_h is None and scale_w is None:
        return x
    mdtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    mh = interp_matrix(h, out_h, method, align_corners, scale_h, x.device, mdtype)
    mw = interp_matrix(w, out_w, method, align_corners, scale_w, x.device, mdtype)
    y = torch.einsum("Oh,...hwc->...Owc", mh, x.to(mdtype))
    y = torch.einsum("Pw,...hwc->...hPc", mw, y)
    return y.to(x.dtype)


def resize_hw_axes(x: Tensor, out_h: int, out_w: int, h_axis: int, w_axis: int,
                   method: str = "linear", align_corners: bool = False) -> Tensor:
    """Resize two arbitrary axes of an ND tensor in fp32 (e.g. [B, D, H, W])."""
    x = torch.movedim(x, (h_axis, w_axis), (-2, -1))
    mh = interp_matrix(x.shape[-2], out_h, method, align_corners, device=x.device)
    mw = interp_matrix(x.shape[-1], out_w, method, align_corners, device=x.device)
    y = torch.einsum("Oh,...hw->...Ow", mh, x.float())
    y = torch.einsum("Pw,...hw->...hP", mw, y).to(x.dtype)
    return torch.movedim(y, (-2, -1), (h_axis, w_axis))
