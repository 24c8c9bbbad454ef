"""The benchmark's inputs: views of an analytic scene rendered on the card
from a seed (a frozen copy of the repository's synthetic geometric scene
and its two camera rigs), as the float32 host arrays the eval CLI's loader
hands to the model.

A scene is a union of textured planar quads in world space (mm): a tilted
background, three mid-ground slabs and a near one, each with a band-limited
random texture. `pool` renders distinct samples (each its own textures and
a jittered scene) with one rig: "dtu" (a DTU-like convergent rig, focal
2892.33 px at 1600 wide, baselines of 55 mm, 425 mm + k * interval depth
hypotheses) or "tnt" (a Tanks-and-Temples-like orbit, focal 1160 px at 1920
wide, the range from the rendered depths). Every sample of a traffic mix
has the same sizes; the seed changes only the content.
"""
from __future__ import annotations

import math

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGE_SCALES = (0.125, 0.25, 0.5, 1.0)
QUADS = (  # p0, e1, e2 (mm)
    ((-900, -700, 820), (1800, 0, 120), (0, 1400, -60)),
    ((-350, -260, 620), (380, 0, 60), (0, 320, -40)),
    ((40, -60, 560), (300, 30, -50), (-30, 280, 35)),
    ((-260, 60, 680), (240, -20, 45), (25, 230, -30)),
    ((-80, -200, 505), (200, 15, 25), (-10, 170, 18)),
)


def lookat(pos, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World-to-camera 4x4 with +z toward `target` (x right, y down)."""
    pos = np.asarray(pos, np.float64)
    z = np.asarray(target, np.float64) - pos
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    r = np.stack([x, np.cross(z, x), z], 0)
    e = np.eye(4)
    e[:3, :3], e[:3, 3] = r, -r @ pos
    return e


def dtu_rig(n: int, h: int, w: int, baseline: float = 55.0):
    f = 2892.33 * (w / 1600.0)
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    return [(k, lookat([baseline * ((i + 1) // 2) * (1 if i % 2 else -1),
                        0.35 * baseline * ((i % 3) - 1), 0.0], [0.0, 0.0, 650.0]))
            for i in range(n)]


def tnt_rig(n: int, h: int, w: int, arc=80.0, height=45.0, roll=10.0, radius=650.0):
    f = 1160.0 * (w / 1920.0)
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    target = np.array([0.0, 0.0, 650.0])
    cams = []
    for i in range(n):
        t = ((i + 1) // 2) * (1 if i % 2 else -1) / max(1, (n - 1) // 2)
        yaw, pitch = math.radians(arc / 2 * t), math.radians(height / 2 * math.sin(3.1 * t))
        pos = target + radius * np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                                          -math.cos(yaw) * math.cos(pitch)])
        r = math.radians(roll) * math.sin(7.3 * t)
        cams.append((k, lookat(pos, target, up=(math.sin(r), -math.cos(r), 0.0))))
    return cams


RIGS = {"dtu": dtu_rig, "tnt": tnt_rig}


def _texture(gen, res: int, device, octaves: int = 3) -> torch.Tensor:
    """[res, res, 3] band-limited noise in [0, 1]: bilinearly upsampled
    octaves of uniform noise."""
    tex = torch.zeros(3, res, res, device=device)
    for o in range(octaves):
        n = max(2, res >> (octaves - 1 - o + 2))
        coarse = torch.rand(1, 3, n, n, generator=gen, device=device)
        tex += torch.nn.functional.interpolate(coarse, size=(res, res), mode="bilinear",
                                               align_corners=True)[0] / (o + 1)
    flat = tex.reshape(3, -1)
    lo, hi = flat.min(1).values[:, None, None], flat.max(1).values[:, None, None]
    return ((tex - lo) / (hi - lo).clamp(min=1e-8)).permute(1, 2, 0)


def render(quads, k, e, h: int, w: int, device):
    """One view: (image [h, w, 3] in [0, 1], camera-frame depth [h, w], 0
    where nothing is hit), float32 on `device`."""
    kk = torch.as_tensor(k, dtype=torch.float64, device=device)
    ee = torch.as_tensor(e, dtype=torch.float64, device=device)
    r, t = ee[:3, :3], ee[:3, 3]
    c = -r.T @ t
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], 0).reshape(3, -1)
    dirs = r.T @ (torch.linalg.inv(kk) @ pix)
    best = torch.full((h * w,), math.inf, dtype=torch.float64, device=device)
    img = torch.zeros(h * w, 3, device=device)
    for p0, e1, e2, tex in quads:
        n = torch.linalg.cross(e1, e2)
        tau = (n @ (p0 - c)) / (n @ dirs)
        rel = c[:, None] + tau[None] * dirs - p0[:, None]
        g11, g12, g22 = e1 @ e1, e1 @ e2, e2 @ e2
        b1, b2 = e1 @ rel, e2 @ rel
        det = g11 * g22 - g12 * g12
        s, tt = (g22 * b1 - g12 * b2) / det, (g11 * b2 - g12 * b1) / det
        hit = (torch.isfinite(tau) & (tau > 1e-6) & (s >= 0) & (s <= 1) & (tt >= 0)
               & (tt <= 1) & (tau < best))
        res = tex.shape[0]
        sv = (s.clamp(0, 1) * (res - 1)).clamp(max=res - 1 - 1e-6)
        tv = (tt.clamp(0, 1) * (res - 1)).clamp(max=res - 1 - 1e-6)
        s0, t0 = sv.long(), tv.long()
        fs, ft = (sv - s0).float()[:, None], (tv - t0).float()[:, None]
        col = (tex[t0, s0] * (1 - fs) * (1 - ft) + tex[t0, s0 + 1] * fs * (1 - ft)
               + tex[t0 + 1, s0] * (1 - fs) * ft + tex[t0 + 1, s0 + 1] * fs * ft)
        img = torch.where(hit[:, None], col, img)
        best = torch.where(hit, tau, best)
    depth = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    return img.reshape(h, w, 3), depth.reshape(h, w).float()


def scene_quads(gen, device, tex_res: int):
    """The scene's quads, each slab moved by up to 20 mm, with textures."""
    out = []
    for i, (p0, e1, e2) in enumerate(QUADS):
        jitter = (torch.rand(3, generator=gen, device=device, dtype=torch.float64) - 0.5) * 40
        p = torch.tensor(p0, dtype=torch.float64, device=device) + (jitter if i else 0)
        out.append((p, torch.tensor(e1, dtype=torch.float64, device=device),
                    torch.tensor(e2, dtype=torch.float64, device=device),
                    _texture(gen, tex_res, device)))
    return out


def stage_cams(k: np.ndarray, e: np.ndarray) -> np.ndarray:
    """[4, 2, 4, 4]: (E, K) per stage, K scaled to the stage's resolution."""
    out = np.zeros((4, 2, 4, 4), np.float32)
    for i, s in enumerate(STAGE_SCALES):
        kk = k.copy()
        kk[:2] *= s
        out[i, 0] = e
        out[i, 1, :3, :3] = kk
    return out


def sample(traffic: dict, gen, device) -> dict:
    """One sample of a mix: {"imgs" [V, H, W, 3] ImageNet-normalised, "cams"
    [4, V, 2, 4, 4] (stage-major), "depth_values" [D], "depth" [V, H, W]}
    as float32 tensors on `device`."""
    v, h, w = traffic["views"], traffic["height"], traffic["width"]
    quads = scene_quads(gen, device, traffic.get("texture", 1024))
    rig = RIGS[traffic["rig"]](v, h, w)
    imgs, depths = zip(*(render(quads, k, e, h, w, device) for k, e in rig))
    imgs, depths = torch.stack(imgs), torch.stack(depths)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    nd = traffic["ndepths"]
    if "depth_min" in traffic:  # the rig's fixed range (DTU's cam files)
        dmin, itv = traffic["depth_min"], traffic["depth_interval"]
    else:  # the range of the rendered reference depths, with a margin
        valid = depths[0][depths[0] > 0]
        dmin = float(valid.min()) * 0.94
        itv = (float(valid.max()) * 1.04 - dmin) / nd
    itv *= traffic.get("interval_scale", 1.0)
    cams = np.stack([stage_cams(k, e) for k, e in rig], 1)
    return {"imgs": (imgs - mean) / std, "cams": torch.from_numpy(cams).to(device),
            "depth_values": dmin + torch.arange(nd, device=device, dtype=torch.float32) * itv,
            "depth": depths}
