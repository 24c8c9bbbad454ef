"""Plane-sweep warp: bilinear sampling of source features at homography-
projected points (csrc/warp.cu), and its image gradient (csrc/warp_bwd.cu).

Every TPU warp kernel of the JAX package (mvsformerplusplus_tpu/ops/pallas/,
the rows of PERF.md's kernel table) computes a windowed form of one of these
two functions: the forward serves rows 1, 4, 5, 10 and 12, the backward rows
6, 7 and 11 (see each wrapper). The TPU kernels zero samples that escape
their band or patch window; these are exact grid_sample(bilinear, zeros,
align_corners=True) in pixel units and its transpose, so they need no
windows, equal each TPU form wherever no sample escapes it
(tests/test_torch_warp_rows.py) and serve every stage and warp mode.

Bound on the H100: memory. Each output element is one f32 write and the four
corner reads mostly hit L1/L2 (neighbouring samples share corners), so the
least time is the f32 output over 3.35 TB/s (stage 4 at DTU eval: 226 MB per
source view). Design: one thread per (sample, channel), channel fastest, so
the output write is fully coalesced and the coordinate load is shared by the
C threads of a sample through L1. The backward reads the f32 cotangent the
same way and reduces it into the four corners with f32 atomics.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, dtype_code, load, ptr, stream

Tensor = torch.Tensor


def bilinear_corners(coords: Tensor, h: int, w: int):
    """Yield (flat pixel index, weight zeroed outside the image) for the four
    bilinear corners of each sample; coords [B, N, 2] f32."""
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            yield idx, torch.where(inside, wy * wx, 0.0)


def warp_bilinear_plain(src: Tensor, coords: Tensor) -> Tensor:
    """src [B, H, W, C], coords [B, ..., 2] (x, y) pixel units -> [B, ..., C] f32.

    Corners outside the image contribute zero with their bilinear weight
    (torch grid_sample zeros padding, align_corners=True)."""
    b, h, w, c = src.shape
    out_shape = coords.shape[:-1] + (c,)
    xy = coords.reshape(b, -1, 2).float()
    flat = src.reshape(b, h * w, c)
    out = torch.zeros(b, xy.shape[1], c, dtype=torch.float32, device=src.device)
    for idx, wt in bilinear_corners(xy, h, w):
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()
        out += vals * wt[..., None]
    return out.reshape(out_shape)


def warp_bilinear_bwd_plain(g: Tensor, coords: Tensor, src_shape) -> Tensor:
    """The transpose of warp_bilinear_plain in its image argument: g
    [B, ..., C] cotangent, coords [B, ..., 2] -> dsrc [B, H, W, C] f32, an
    index_add_ of g x bilinear weight at the four corners (zero-padded
    corners get nothing)."""
    b, h, w, c = src_shape
    xy = coords.reshape(b, -1, 2).float()
    gf = g.reshape(b, -1, c).float()
    dsrc = torch.zeros(b * h * w, c, dtype=torch.float32, device=g.device)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None]
    for idx, wt in bilinear_corners(xy, h, w):
        dsrc.index_add_(0, (idx + base).reshape(-1), (gf * wt[..., None]).reshape(-1, c))
    return dsrc.reshape(b, h, w, c)


def _check_coords(src: Tensor, coords: Tensor) -> None:
    if coords.dtype != torch.float32 or coords.shape[-1] != 2 or coords.shape[0] != src.shape[0]:
        raise ValueError(f"coords must be f32 [B, ..., 2] matching src batch, got "
                         f"{tuple(coords.shape)} {coords.dtype}")


def warp_bilinear(src: Tensor, coords: Tensor) -> Tensor:
    """Bilinear warp: src [B, H, W, C] bf16|f32, coords [B, D, H', W', 2] f32
    -> [B, D, H', W', C] f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel (csrc/warp.cu).

    Serves the TPU rows (mvsformerplusplus_tpu/ops/pallas/): 1
    warp_band.py:395 banded_warp_blocked_fused and 4 :195 banded_warp_rows
    (the banded warp mode), 5 :511 banded_warp_blocked (banded with
    banded_fused=False), 10 warp_blend.py:132 _blend_fwd_impl and 12 :153
    blend_ygrouped_dfold (the pallas warp mode, unfolded and depth-folded)."""
    if not src.is_cuda:
        return warp_bilinear_plain(src, coords)
    _check_coords(src, coords)
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


def warp_bilinear_bwd(g: Tensor, coords: Tensor, src_shape) -> Tensor:
    """Image gradient of warp_bilinear: g [B, D, H', W', C] f32, coords
    [B, D, H', W', 2] f32 -> dsrc [B, H, W, C] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (csrc/warp_bwd.cu).

    Serves the TPU rows (mvsformerplusplus_tpu/ops/pallas/): 6
    warp_band.py:231 banded_warp_rows_bwd, 7 :478 banded_warp_blocked_bwd
    and 11 warp_blend.py:217 _blend_bwd (the y-grouped blend's VJP). The
    kernel sums with atomics, in an order that varies from run to run, so
    it matches the plain version within fp32 summation noise (the f32
    tolerance of `ops.cuda.tolerance`), not bit for bit."""
    if not g.is_cuda:
        return warp_bilinear_bwd_plain(g, coords, src_shape)
    b, h, w, c = src_shape
    _check_coords(g, coords)
    if g.dtype != torch.float32 or g.shape != coords.shape[:-1] + (c,):
        raise ValueError(f"cotangent must be f32 {tuple(coords.shape[:-1]) + (c,)}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    g = g.contiguous()
    coords = coords.contiguous()
    nsamp = coords.numel() // (2 * b)
    dsrc = torch.zeros(b, h, w, c, dtype=torch.float32, device=g.device)
    lib = load("warp_bwd")
    fn = lib.warp_bilinear_bwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ptr(g), ptr(coords), ptr(dsrc), b, h, w, c, nsamp, stream()), "warp_bilinear_bwd")
    warp_bilinear_bwd.launches += 1
    return dsrc


warp_bilinear.launches = 0
warp_bilinear_bwd.launches = 0


class WarpBilinear(torch.autograd.Function):
    """Differentiable warp_bilinear: the image gets the transpose of the
    sample (warp_bilinear_bwd); the coordinates get no gradient, as every
    warp of the JAX package stops it (grid_sample.py:813-818)."""

    @staticmethod
    def forward(ctx, src: Tensor, coords: Tensor) -> Tensor:
        ctx.save_for_backward(coords)
        ctx.src_shape, ctx.src_dtype = tuple(src.shape), src.dtype
        return warp_bilinear(src, coords)

    @staticmethod
    def backward(ctx, g: Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        (coords,) = ctx.saved_tensors
        dsrc = warp_bilinear_bwd(g.float(), coords.detach(), ctx.src_shape)
        return dsrc.to(ctx.src_dtype), None
