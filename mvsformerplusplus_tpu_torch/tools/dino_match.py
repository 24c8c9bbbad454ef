"""DINOv2 dense matcher on the port's ViT (counterpart of the repo's
tools/dino_match.py): coarse matches between two images from the frozen
DINOv2 patch tokens, for the camera-range triangulation of the NeRF
converter. Per image: an area resize to a working size whose longest side
is about `long_side` pixels, both sides multiples of the 14-px patch; the
ViT's last tokens, L2-normalised; then the cosine similarities of every
token pair, mutual nearest neighbours with a best / second-best ratio gate,
a soft-argmax over a window of B-side patches for sub-patch precision, and
patch centres scaled back to pixels.

    from mvsformerplusplus_tpu_torch.tools.dino_match import make_dino_matcher
    match_fn = make_dino_matcher("dinov2_vitb14_pretrain.pth")   # or the .npz
    pts_a, pts_b = match_fn(img_a_uint8_rgb, img_b_uint8_rgb)

The ViT runs in fp32 on the card (its attention through the f32 flash
kernel) unless device="cpu". The resize is the host library's
native.resize_area (data/image.resize_area's values), OpenCV's INTER_AREA,
which shrinks or enlarges.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..convert import from_jax_variables, load_vit
from ..data import native
from ..models.dino import DinoVisionTransformer

# ImageNet normalisation, DINOv2's input distribution
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _work_shape(h: int, w: int, long_side: int, patch: int = 14):
    """Resize target: the longest side about long_side, both sides
    multiples of the patch."""
    s = long_side / max(h, w)
    wh = max(patch, int(round(h * s / patch)) * patch)
    ww = max(patch, int(round(w * s / patch)) * patch)
    return wh, ww


def _vit_from(vit_path, params, device) -> DinoVisionTransformer:
    """DINOv2-B in fp32 on `device`: from a flax parameter tree `params` (the
    JAX tool's argument), else from vit_path (.npz or .pth)."""
    holder = nn.Module()
    holder.vit = DinoVisionTransformer(dtype=torch.float32)
    if params is not None:
        holder.vit.load_state_dict(from_jax_variables({"params": params}), strict=True)
    elif vit_path is not None:
        load_vit(vit_path, holder)
    else:
        raise ValueError("make_dino_matcher needs vit_path, params or model")
    return holder.vit.to(device).eval()


def make_dino_matcher(vit_path=None, long_side: int = 644, sim_thresh: float = 0.1,
                      ratio: float = 1.02, refine_win: int = 3, params=None, model=None,
                      device="cuda"):
    """Build match_fn(img_a, img_b) -> (pts_a [N, 2], pts_b [N, 2]) in pixels.

    Args:
      vit_path: DINOv2-B weights, the converted flax .npz or the original
        torch .pth (chosen by suffix).
      long_side: working resolution of the longest image side.
      sim_thresh: least cosine similarity of a match.
      ratio: best / second-best similarity gate (1.0 turns it off).
      refine_win: half-window (patches) of the soft-argmax refinement.
      params: a flax parameter tree of the ViT (tests); overrides vit_path.
      model: a DinoVisionTransformer of this package to use as it is;
        overrides both.
      device: "cuda" (default) or "cpu".
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the matcher runs on the card and CUDA is not available; pass "
                           "device='cpu' to run it on the CPU")
    vit = model if model is not None else _vit_from(vit_path, params, device)

    def feats_of(img: np.ndarray) -> np.ndarray:  # [H, W, 3] -> [h0*w0, C] normalised
        with torch.inference_mode():
            x = torch.from_numpy(img[None]).to(device)
            tokens = vit(x)[-1][0].float()
            tokens = tokens / (tokens.norm(dim=-1, keepdim=True) + 1e-8)
        return tokens.cpu().numpy()

    def extract(img_u8):
        h, w = img_u8.shape[:2]
        wh, ww = _work_shape(h, w, long_side)
        im = native.resize_area(np.asarray(img_u8, np.uint8), wh, ww)
        im = (im.astype(np.float32) / 255.0 - _MEAN) / _STD
        return feats_of(im), (wh // 14, ww // 14), (w / ww, h / wh)

    def match_fn(img_a, img_b):
        fa, (ha, wa), (sxa, sya) = extract(img_a)
        fb, (hb, wb), (sxb, syb) = extract(img_b)

        sim = fa @ fb.T  # [Na, Nb] cosine similarities
        best_ab = sim.argmax(1)
        best_ba = sim.argmax(0)
        ia = np.arange(len(fa))
        mutual = best_ba[best_ab] == ia

        s_sorted = np.sort(sim, axis=1)
        s1, s2 = s_sorted[:, -1], s_sorted[:, -2]
        keep = mutual & (s1 >= sim_thresh) & (s1 >= ratio * np.maximum(s2, 1e-6))
        ia = ia[keep]
        ib = best_ab[keep]
        if len(ia) == 0:
            return np.zeros((0, 2)), np.zeros((0, 2))

        # soft-argmax refinement of the B-side patch position: the expected
        # (x, y) under a softmax over the local similarity window
        by = (ib // wb).astype(np.float64)
        bx = (ib % wb).astype(np.float64)
        ry, rx = np.zeros(len(ib)), np.zeros(len(ib))
        win = range(-refine_win, refine_win + 1)
        offs = [(dy, dx) for dy in win for dx in win]
        local = np.full((len(ib), len(offs)), -np.inf)
        for k, (dy, dx) in enumerate(offs):
            ny, nx = by + dy, bx + dx
            ok = (ny >= 0) & (ny < hb) & (nx >= 0) & (nx < wb)
            idx = (ny.clip(0, hb - 1) * wb + nx.clip(0, wb - 1)).astype(int)
            local[ok, k] = sim[ia[ok], idx[ok]]
        # a temperature at which a ~0.05 similarity edge over the window decides
        wgt = np.exp((local - local.max(1, keepdims=True)) / 0.02)
        wgt /= wgt.sum(1, keepdims=True)
        for k, (dy, dx) in enumerate(offs):
            ry += wgt[:, k] * dy
            rx += wgt[:, k] * dx

        ay = (ia // wa) + 0.5
        ax = (ia % wa) + 0.5
        pts_a = np.stack([ax * 14 * sxa, ay * 14 * sya], -1)
        pts_b = np.stack([(bx + rx + 0.5) * 14 * sxb, (by + ry + 0.5) * 14 * syb], -1)
        return pts_a, pts_b

    return match_fn
