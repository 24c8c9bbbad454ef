"""Plane-sweep warp: bilinear sampling of source features at homography-
projected points (csrc/warp.cu).

Replaces the Pallas kernel mvsformerplusplus_tpu/ops/pallas/warp_band.py
`banded_warp_blocked_fused` (the TPU's eval warp at stages 2-4; stage 1 used
XLA's gather). The TPU kernel zeroes samples that escape its band window;
this one is exact grid_sample(bilinear, zeros, align_corners=True) in pixel
units, so it needs no windows and serves all four stages.

Bound on the H100: memory. Each output element is one f32 write and the four
corner reads mostly hit L1/L2 (neighbouring samples share corners), so the
least time is the f32 output over 3.35 TB/s (stage 4 at DTU eval: 226 MB per
source view). Design: one thread per (sample, channel), channel fastest, so
the output write is fully coalesced and the coordinate load is shared by the
C threads of a sample through L1.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, dtype_code, load, ptr, stream

Tensor = torch.Tensor


def warp_bilinear_plain(src: Tensor, coords: Tensor) -> Tensor:
    """src [B, H, W, C], coords [B, ..., 2] (x, y) pixel units -> [B, ..., C] f32.

    Corners outside the image contribute zero with their bilinear weight
    (torch grid_sample zeros padding, align_corners=True)."""
    b, h, w, c = src.shape
    out_shape = coords.shape[:-1] + (c,)
    xy = coords.reshape(b, -1, 2).float()
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = src.reshape(b, h * w, c)
    out = torch.zeros(b, xy.shape[1], c, dtype=torch.float32, device=src.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()
            out += vals * torch.where(inside, wy * wx, 0.0)[..., None]
    return out.reshape(out_shape)


def warp_bilinear(src: Tensor, coords: Tensor) -> Tensor:
    """Bilinear warp: src [B, H, W, C] bf16|f32, coords [B, D, H', W', 2] f32
    -> [B, D, H', W', C] f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not src.is_cuda:
        return warp_bilinear_plain(src, coords)
    if coords.dtype != torch.float32 or coords.shape[-1] != 2 or coords.shape[0] != src.shape[0]:
        raise ValueError(f"coords must be f32 [B, ..., 2] matching src batch, got "
                         f"{tuple(coords.shape)} {coords.dtype}")
    src = src.contiguous()
    coords = coords.contiguous()
    b, h, w, c = src.shape
    nsamp = coords.numel() // (2 * b)
    out = torch.empty(coords.shape[:-1] + (c,), dtype=torch.float32, device=src.device)
    lib = load("warp")
    fn = lib.warp_bilinear
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ptr(src), ptr(coords), ptr(out), b, h, w, c, nsamp, dtype_code(src), stream()),
          "warp_bilinear")
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0
