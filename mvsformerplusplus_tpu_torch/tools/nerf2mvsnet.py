"""NeRF-format scene (transforms.json: poses, no points) -> MVSNet-format
scan, the repo's tools/nerf2mvsnet.py on the port: match neighbouring
views, triangulate the matches, take each view's 1% / 99% depth
percentiles and score view pairs over the triangulated points, then write
cams/, images/ and pair.txt. No OpenCV is needed: images are read by
data/io.imread_rgb (OpenCV's imread, EXIF orientation and all), written by
data/jpeg.write_jpeg at quality 95 (cv2.imwrite's default), and the default
matcher is OpenCV's ORB + brute-force Hamming kNN + ratio test in the host
library (data/orb.py, bit for bit cv2's). `--matcher dino` matches on
DINOv2-B patch tokens instead (tools/dino_match.py, the ViT on the card).

NeRF/Blender cameras look down -Z with +Y up, OpenCV's down +Z with -Y up:
columns 1 and 2 of each camera-to-world rotation are negated.

    python -m mvsformerplusplus_tpu_torch.tools.nerf2mvsnet --scene_dir SCENE \\
        [--out_dir OUT] [--matcher orb | --matcher dino --vit_path dinov2.pth]
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ..data.io import imread_rgb, save_cam_file, save_pair_file
from ..data.jpeg import write_jpeg
from ..data.orb import orb_match


def nerf_to_opencv(c2w: np.ndarray) -> np.ndarray:
    """Flip NeRF camera axes to OpenCV's and return w2c (the extrinsic)."""
    c2w = np.asarray(c2w, np.float64).copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return np.linalg.inv(c2w)


def triangulate(pts_a, pts_b, K, ext_a, ext_b):
    """DLT triangulation -> the [N, 3] world points in front of both views."""
    pa = np.asarray(K @ ext_a[:3])
    pb = np.asarray(K @ ext_b[:3])
    n = len(pts_a)
    out = np.zeros((n, 3))
    ok = np.zeros(n, bool)
    for i in range(n):
        a = np.stack([
            pts_a[i, 0] * pa[2] - pa[0],
            pts_a[i, 1] * pa[2] - pa[1],
            pts_b[i, 0] * pb[2] - pb[0],
            pts_b[i, 1] * pb[2] - pb[1],
        ])
        _, _, vt = np.linalg.svd(a)
        X = vt[-1]
        if abs(X[3]) < 1e-12:
            continue
        X = X[:3] / X[3]
        za = (ext_a[:3, :3] @ X + ext_a[:3, 3])[2]
        zb = (ext_b[:3, :3] @ X + ext_b[:3, 3])[2]
        if za > 0 and zb > 0:
            out[i] = X
            ok[i] = True
    return out[ok]


def make_matcher(matcher: str = "orb", vit_path=None, params=None, device="cuda", **kw):
    """match_fn(img_a, img_b) -> (pts_a, pts_b): "orb" (orb_match) or "dino"
    (tools/dino_match.make_dino_matcher on `device`, from vit_path or a flax
    parameter tree `params`; kw goes to it)."""
    if matcher == "orb":
        return orb_match
    if matcher == "dino":
        from .dino_match import make_dino_matcher

        return make_dino_matcher(vit_path, params=params, device=device, **kw)
    raise ValueError(f"unknown matcher {matcher!r} (orb or dino)")


def _image_path(scene: Path, frame) -> Path:
    p = scene / frame["file_path"]
    if not p.exists():
        for ext in (".png", ".jpg", ".jpeg"):
            if p.with_suffix(ext).exists():
                return p.with_suffix(ext)
    return p


def convert(scene_dir, out_dir=None, max_d=192, interval_scale=1.06, theta0=5.0, sigma1=1.0,
            sigma2=10.0, n_pairs=10, pairs_per_view=4, match_fn=None, matcher="orb",
            vit_path=None, device="cuda"):
    """The JAX tool's convert. The matcher is match_fn when given, else
    make_matcher(matcher, vit_path, device=device). Returns (per-view
    (depth_min, depth_max) of the triangulated points, None where a view has
    under 10, and the view-pair score matrix)."""
    scene = Path(scene_dir)
    out = Path(out_dir) if out_dir else scene
    if match_fn is None:
        match_fn = make_matcher(matcher, vit_path, device=device)
    with open(scene / "transforms.json") as f:
        meta = json.load(f)

    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    n = len(frames)
    imgs = {}

    def get_img(i):
        if i not in imgs:
            imgs[i] = imread_rgb(_image_path(scene, frames[i]))
        return imgs[i]

    h, w = get_img(0).shape[:2]
    # intrinsics: the dataset's camera_angle_x, or explicit fl_x / fl_y
    if "fl_x" in meta:
        fx, fy = meta["fl_x"], meta.get("fl_y", meta["fl_x"])
        cx, cy = meta.get("cx", w / 2), meta.get("cy", h / 2)
    else:
        fx = fy = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
        cx, cy = w / 2, h / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    exts = [nerf_to_opencv(fr["transform_matrix"]) for fr in frames]
    centers = [(-e[:3, :3].T @ e[:3, 3]) for e in exts]

    # match each view with its nearest views by camera distance, triangulate
    dists = np.array([[np.linalg.norm(ci - cj) for cj in centers] for ci in centers])
    np.fill_diagonal(dists, np.inf)
    per_view_points = [[] for _ in range(n)]
    covis = np.zeros((n, n))
    for i in range(n):
        for j in np.argsort(dists[i])[:pairs_per_view]:
            j = int(j)
            if j < i and covis[j, i] > 0:
                continue
            pa, pb = match_fn(get_img(i), get_img(j))
            if len(pa) < 8:
                continue
            pts = triangulate(pa, pb, K, exts[i], exts[j])
            if len(pts) == 0:
                continue
            per_view_points[i].append(pts)
            per_view_points[j].append(pts)
            a = centers[i] - pts
            b = centers[j] - pts
            cos = np.sum(a * b, axis=1) / (
                np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12)
            theta = np.degrees(np.arccos(np.clip(cos, -1, 1)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            s = float(np.sum(np.exp(-((theta - theta0) ** 2) / (2 * sigma**2))))
            covis[i, j] = covis[j, i] = s

    (out / "cams").mkdir(parents=True, exist_ok=True)
    (out / "images").mkdir(parents=True, exist_ok=True)
    all_depths = []
    for i in range(n):
        pts = np.concatenate(per_view_points[i]) if per_view_points[i] else np.zeros((0, 3))
        if len(pts) >= 10:
            z = (exts[i][:3, :3] @ pts.T + exts[i][:3, 3:4])[2]
            z = np.sort(z[z > 0])
            dmin = float(z[int(len(z) * 0.01)])
            dmax = float(z[int(len(z) * 0.99)])
        else:
            dmin = dmax = None  # too few points: take the scene median below
        all_depths.append((dmin, dmax))
    have = [d for d in all_depths if d[0] is not None]
    med_min = float(np.median([d[0] for d in have])) if have else 0.1
    med_max = float(np.median([d[1] for d in have])) if have else 10.0
    for i in range(n):
        dmin, dmax = all_depths[i]
        if dmin is None or dmax <= dmin or dmax / max(dmin, 1e-9) > 1e3:
            dmin, dmax = med_min, med_max
        dint = (dmax - dmin) / (max_d - 1) / interval_scale
        save_cam_file(out / "cams" / f"{i:0>8}_cam.txt", K, exts[i], dmin, dint, max_d, dmax)
        src = _image_path(scene, frames[i])
        dst = out / "images" / f"{i:0>8}.jpg"
        if not dst.exists():
            if src.suffix.lower() in (".jpg", ".jpeg"):
                shutil.copyfile(src, dst)
            else:
                write_jpeg(dst, get_img(i), quality=95)

    pairs = []
    for i in range(n):
        order = np.argsort(covis[i])[::-1]
        pairs.append((i, [(int(j), float(covis[i, j])) for j in order[:n_pairs]
                          if covis[i, j] > 0]))
    save_pair_file(out / "pair.txt", pairs)
    return all_depths, covis


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene_dir", required=True, help="dir with transforms.json")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--matcher", default="orb", choices=["orb", "dino"],
                   help="'dino': dense matching on frozen DINOv2-B patch tokens "
                        "(tools/dino_match.py, on the card) for low-texture scenes where ORB "
                        "starves; needs --vit_path")
    p.add_argument("--vit_path", default=None,
                   help="DINOv2-B weights for --matcher dino (the .pth or the converted .npz)")
    p.add_argument("--device", default="cuda", help="where the dino matcher's ViT runs")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.matcher == "dino" and not args.vit_path:
        p.error("--matcher dino requires --vit_path")
    return convert(args.scene_dir, args.out_dir, args.max_d, args.interval_scale,
                   matcher=args.matcher, vit_path=args.vit_path, device=args.device)


if __name__ == "__main__":
    main()
