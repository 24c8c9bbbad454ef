"""Plain PyTorch operations of the reference models: resizing, camera
geometry, depth hypotheses, position encodings, attention, the plane-sweep
warp and the stride-1 convolution, each in float32 with no kernel of its
own. A frozen copy of the arithmetic the MVSFormer++ code describes; it
imports nothing of the program under test.

`PRECISION` selects how every product's operands are rounded before it:
"fp32" (none, the reference) or "fp8" (each operand fake-quantized to
float8 e4m3 with a per-tensor scale, the benchmark's control). `record`
collects the calls of the three functions that the program runs on its
hand-written kernels or the library's (attention, every convolution, the
warp), with their shapes, for the roofline metric.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

PRECISION = {"mode": "fp32"}
FP8_MAX = 448.0
CALLS: list = []
RECORDING = {"on": False}


def _fp8(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, as float32."""
    with torch.no_grad():
        xf = x.float()
        scale = xf.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (xf / scale).to(torch.float8_e4m3fn).float() * scale


def q(x: Tensor) -> Tensor:
    """x as a product's operand at the selected precision (float32 values)."""
    if PRECISION["mode"] != "fp8" or not x.is_floating_point():
        return x
    return _fp8(x)


def record(fn: str, **shapes) -> None:
    if RECORDING["on"]:
        CALLS.append((fn, shapes))


# ----------------------------------------------------------------- resize

@lru_cache(maxsize=None)
def _interp_np(in_size: int, out_size: int, method: str, align_corners: bool,
               scale: float = None) -> np.ndarray:
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
    else:  # cubic, Keys a = -0.75
        a = -0.75

        def k(x):
            x = np.abs(x)
            return np.where(x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
                            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))

        x0 = np.floor(src).astype(np.int64)
        frac = src - x0
        for off in (-1, 0, 1, 2):
            np.add.at(mat, (rows, np.clip(x0 + off, 0, in_size - 1)), k(frac - off))
    return mat.astype(np.float32)


def interp(in_size, out_size, method, align_corners, scale=None, device=None) -> Tensor:
    return torch.from_numpy(_interp_np(in_size, out_size, method, align_corners, scale)).to(device)


def resize2d(x: Tensor, out_h: int, out_w: int, method="linear", align_corners=False,
             scale_h=None, scale_w=None) -> Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C] in float32."""
    h, w = x.shape[-3], x.shape[-2]
    if h == out_h and w == out_w and scale_h is None and scale_w is None:
        return x.float()
    mh = interp(h, out_h, method, align_corners, scale_h, x.device)
    mw = interp(w, out_w, method, align_corners, scale_w, x.device)
    y = torch.einsum("Oh,...hwc->...Owc", mh, x.float())
    return torch.einsum("Pw,...hwc->...hPc", mw, y)


def resize_hw(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear (align_corners) resize of the last two axes, float32."""
    mh = interp(x.shape[-2], out_h, "linear", True, device=x.device)
    mw = interp(x.shape[-1], out_w, "linear", True, device=x.device)
    y = torch.einsum("Oh,...hw->...Ow", mh, x.float())
    return torch.einsum("Pw,...hw->...hP", mw, y)


# --------------------------------------------------------------- geometry

def compose_projection(cam: Tensor) -> Tensor:
    cam = cam.float()
    ext, intr = cam[..., 0, :, :], cam[..., 1, :3, :3]
    return torch.cat([intr @ ext[..., :3, :4], ext[..., 3:4, :4]], dim=-2)


def pixel_grid(h: int, w: int, device=None) -> Tensor:
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), torch.ones_like(x).reshape(-1)])


def sweep_coords(src_proj: Tensor, ref_proj: Tensor, depth: Tensor, h: int, w: int) -> Tensor:
    """Each ref pixel at each hypothesis projected into the source view:
    [B, D, H, W, 2] (x, y) pixel coordinates."""
    b, d = src_proj.shape[0], depth.shape[1]
    proj = src_proj.float() @ torch.linalg.inv(ref_proj.float())
    rot_xyz = torch.einsum("bij,jn->bin", proj[:, :3, :3], pixel_grid(h, w, src_proj.device))
    p = rot_xyz[:, :, None, :] * depth.float().reshape(b, 1, d, -1) + proj[:, :3, 3, None, None]
    xy = p[:, :2] / (p[:, 2:3] + 1e-6)
    return xy.permute(0, 2, 3, 1).reshape(b, d, h, w, 2)


def position_3d(intr: Tensor, depth: Tensor, h: int, w: int, dmin, dmax, bounds=None):
    b, d = intr.shape[0], depth.shape[1]
    rays = torch.einsum("bij,jn->bin", torch.linalg.inv(intr.float()),
                        pixel_grid(h, w, intr.device))
    pos = rays[:, :, None, :] * depth.float().reshape(b, 1, d, -1)
    if bounds is None:
        bounds = (pos[:, 0].min(), pos[:, 0].max(), pos[:, 1].min(), pos[:, 1].max())
    w0, w1, h0, h1 = bounds
    px = (pos[:, 0] - w0) / (w1 - w0 + 1e-5)
    py = (pos[:, 1] - h0) / (h1 - h0 + 1e-5)
    pz = (pos[:, 2].clamp(dmin, dmax) - dmin) / (dmax - dmin + 1e-5)
    return torch.stack([px, py, pz], dim=1).reshape(b, 3, d, h, w), bounds


# ------------------------------------------------------ depth hypotheses

def _itv(n: int, device) -> Tensor:
    return torch.arange(n, dtype=torch.float32, device=device) / (n - 1)


def init_inverse_range(dv: Tensor, n: int, h: int, w: int) -> Tensor:
    dv = dv.float()
    inv_min, inv_max = 1.0 / dv[:, 0], 1.0 / dv[:, -1]
    inv = inv_max[:, None] + (inv_min - inv_max)[:, None] * _itv(n, dv.device)[None]
    return (1.0 / inv)[:, :, None, None].expand(-1, -1, h, w)


def schedule_inverse_range(depth: Tensor, hypo: Tensor, n: int, ratio: float, h: int,
                           w: int) -> Tensor:
    depth, hypo = depth.float(), hypo.float()
    last = 1.0 / hypo[:, 2] - 1.0 / hypo[:, 1]
    inv_min, inv_max = 1.0 / depth + ratio * last, 1.0 / depth - ratio * last
    inv = inv_max[:, None] + (inv_min - inv_max)[:, None] * _itv(n, depth.device)[None, :, None,
                                                                                   None]
    return 1.0 / resize_hw(inv, h, w)


def depth_regression(prob: Tensor, dv: Tensor) -> Tensor:
    if dv.ndim == 2:
        dv = dv[:, :, None, None]
    return torch.sum(prob * dv, dim=1)


# ------------------------------------------------------ position encoding

@lru_cache(maxsize=None)
def _sine_np(c: int, h: int, w: int, nh: int = 128, nw: int = 128) -> np.ndarray:
    y = np.broadcast_to(np.arange(1, h + 1, dtype=np.float64)[:, None] * nh / h, (h, w))
    x = np.broadcast_to(np.arange(1, w + 1, dtype=np.float64)[None, :] * nw / w, (h, w))
    div = np.exp(np.arange(0, c // 2, 2, dtype=np.float64) * (-math.log(10000.0) / (c // 2)))
    pe = np.zeros((c, h, w), dtype=np.float64)
    pe[0::4] = np.sin(x[None] * div[:, None, None])
    pe[1::4] = np.cos(x[None] * div[:, None, None])
    pe[2::4] = np.sin(y[None] * div[:, None, None])
    pe[3::4] = np.cos(y[None] * div[:, None, None])
    return np.moveaxis(pe.astype(np.float32), 0, -1)


def sine_pe_2d(c: int, h: int, w: int, device=None) -> Tensor:
    return torch.from_numpy(_sine_np(c, h, w)).to(device)


def position_encoding_3d(pos: Tensor, c: int, rescale: float = 4.0) -> Tensor:
    """[B, 3, D, H, W] -> [B, D, H, W, 3c] (sin/cos interleaved per axis)."""
    b, _, d, h, w = pos.shape
    div = torch.exp(torch.arange(0, c, 2, dtype=torch.float32, device=pos.device)
                    * (-math.log(10000.0) / c))
    ang = (pos.float() * rescale)[..., None] * div
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(b, 3, d, h, w, c)
    return torch.movedim(enc, 1, -2).reshape(b, d, h, w, 3 * c)


# -------------------------------------------------------------- attention

def entropy_inv_scale(dh: int, n: int, avg) -> float:
    s = dh ** -0.5
    if avg is not None and n > 1:
        s *= math.log(n, avg)
    return s


def linear_attention(qq: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """elu+1 linear attention, [B, N, H, Dh] -> [B, N, H, Dh]."""
    qq = F.elu(q(qq).float()) + 1
    k = F.elu(q(k).float()) + 1
    v = q(v).float()
    kv = torch.einsum("bshd,bshm->bhmd", k, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", qq, k.sum(dim=1)) + 1e-6)
    return torch.einsum("blhd,bhmd,blh->blhm", qq, kv, z)


def softmax_attention(qq: Tensor, k: Tensor, v: Tensor, scale: float,
                      chunk: int = 4096) -> Tensor:
    """softmax(q kᵀ · scale) v, [B, N, H, Dh] x [B, M, H, Dh], `chunk` query
    rows at a time (the [N, M] scores never whole)."""
    b, n, h, dh = qq.shape
    record("attention", b=b, h=h, n=n, m=k.shape[1], dh=dh)
    qf = q(qq).float().transpose(1, 2)
    kf = q(k).float().transpose(1, 2)
    vf = q(v).float().transpose(1, 2)
    outs = []
    for s in range(0, n, chunk):
        p = torch.softmax((qf[:, :, s:s + chunk] @ kf.transpose(-1, -2)) * scale, dim=-1)
        outs.append(q(p) @ vf)
    return torch.cat(outs, dim=2).transpose(1, 2)


# ------------------------------------------------------- warp and convs

def warp(src: Tensor, coords: Tensor) -> Tensor:
    """Bilinear samples of src [B, H, W, C] at pixel coordinates [B, D, H', W',
    2] (zeros outside, align_corners=True) -> [B, D, H', W', C]."""
    b, h, w, c = src.shape
    _, d, hh, ww, _ = coords.shape
    record("warp", b=b, h=h, w=w, c=c, n=d * hh * ww)
    grid = torch.stack([coords[..., 0] / ((w - 1) / 2) - 1, coords[..., 1] / ((h - 1) / 2) - 1],
                       dim=-1).reshape(b, d * hh, ww, 2)
    out = F.grid_sample(src.float().permute(0, 3, 1, 2), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).reshape(b, d, hh, ww, c)


def conv2d_same(x: Tensor, weight: Tensor) -> Tensor:
    """Stride-1 zero-padded odd-k conv, x [B, H, W, Ci], weight [Co, Ci, k,
    k] -> [B, H, W, Co]."""
    b, hh, ww, ci = x.shape
    co, _, k, _ = weight.shape
    y = F.conv2d(q(x.float()).permute(0, 3, 1, 2), q(weight.float()), padding=(k - 1) // 2)
    record_conv(x, weight, y, transposed=False)
    return y.permute(0, 2, 3, 1)


def record_conv(x: Tensor, weight: Tensor, y: Tensor, transposed: bool) -> None:
    """A convolution's multiply-adds and elements (input, weights, output);
    a transposed one's input element meets every weight of its channel."""
    if RECORDING["on"]:
        taps = weight[0, 0].numel()
        macs = (x.numel() * weight.shape[1] if transposed else y.numel() * weight.shape[1]) * taps
        record("conv", macs=macs, x=x.numel(), w=weight.numel(), y=y.numel())
