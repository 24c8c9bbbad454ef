"""Synthetic DTU-format training data and eval scans (counterpart of
mvsformerplusplus_tpu/data/synthetic.py), written with this package's own
PNG, JPEG, PFM and cam writers.

- `make_synthetic_dtu`: random images and depths in the DTU training
  layout; exercises the plumbing only.
- `GeometricScene` + `make_geometric_dtu`: an analytic scene of textured
  planar quads rendered by exact ray-quad intersection, so every view is
  photometrically consistent with every other and the ground-truth depth is
  closed-form; a short training run on it can converge;
  `make_geometric_eval_scan` renders it into the MVSNet eval layout and
  `make_blended_scan` into the BlendedMVS training layout.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from .io import save_cam_file, save_pair_file, save_pfm, write_png
from .jpeg import write_jpeg


def make_synthetic_dtu(root: Path, n_scans: int = 1, n_views: int = 5, n_lights: int = 2,
                       h: int = 256, w: int = 320, seed: int = 0):
    """The DTU training layout (Cameras/pair.txt and per-view cam files,
    Rectified_raw images, Depths_raw ground truth) with random content.
    Returns the scan list."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / "Cameras").mkdir(parents=True)
    pairs = []
    for v in range(n_views):
        ang = 0.01 * v
        c, s = np.cos(ang), np.sin(ang)
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        ext[0, 3] = 0.02 * v
        intr = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2], [0, 0, 1]], np.float32)
        save_cam_file(root / "Cameras" / f"{v:0>8}_cam.txt", intr, ext, 2.5, 0.05)
        pairs.append((v, [(s_, 10.0) for s_ in range(n_views) if s_ != v]))
    save_pair_file(root / "Cameras" / "pair.txt", pairs)

    scans = [f"scan{i + 1}" for i in range(n_scans)]
    for scan in scans:
        (root / "Rectified_raw" / scan).mkdir(parents=True)
        (root / "Depths_raw" / scan).mkdir(parents=True)
        for v in range(n_views):
            for light in range(n_lights):
                img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
                write_png(root / "Rectified_raw" / scan / f"rect_{v + 1:0>3}_{light}_r5000.png",
                          img)
            depth = rng.uniform(3.0, 7.0, (h, w)).astype(np.float32)
            save_pfm(root / "Depths_raw" / scan / f"depth_map_{v:0>4}.pfm", depth)
            mask = (rng.rand(h, w) > 0.2).astype(np.uint8) * 255
            write_png(root / "Depths_raw" / scan / f"depth_visual_{v:0>4}.png", mask)
    (root / "train.txt").write_text("\n".join(scans) + "\n")
    return scans


def _smooth_noise(rng, res: int, octaves: int = 3) -> np.ndarray:
    """Band-limited random texture in [0, 1]: a sum of bilinearly upsampled
    noise octaves (white noise would alias between views)."""
    tex = np.zeros((res, res), np.float32)
    for o in range(octaves):
        n = max(2, res >> (octaves - 1 - o + 2))
        coarse = rng.rand(n, n).astype(np.float32)
        yy = np.linspace(0, n - 1, res, dtype=np.float32)
        xx = np.linspace(0, n - 1, res, dtype=np.float32)
        y0 = np.clip(yy.astype(np.int64), 0, n - 2)
        x0 = np.clip(xx.astype(np.int64), 0, n - 2)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        up = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
              + coarse[y0 + 1][:, x0] * fy * (1 - fx)
              + coarse[y0][:, x0 + 1] * (1 - fy) * fx
              + coarse[y0 + 1][:, x0 + 1] * fy * fx)
        tex += up / (o + 1)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-8)
    return tex


class GeometricScene:
    """A union of textured planar quads in world space (mm, DTU-like). Each
    quad is (P0, e1, e2, texture [res, res, 3]): points P0 + s e1 + t e2 for
    s, t in [0, 1]. Rays are X = C + tau R^T K^-1 [u, v, 1], so tau is the
    camera-frame depth, the plane-sweep warp's depth."""

    def __init__(self, seed: int = 0, tex_res: int = 1024):
        rng = np.random.RandomState(seed)
        self.quads = []

        def add_quad(p0, e1, e2):
            tex = np.stack([_smooth_noise(rng, tex_res) for _ in range(3)], -1)
            self.quads.append((np.asarray(p0, np.float32), np.asarray(e1, np.float32),
                               np.asarray(e2, np.float32), tex))

        # background ~850 mm out, slightly tilted, covering every view's rays
        add_quad([-900, -700, 820], [1800, 0, 120], [0, 1400, -60])
        # mid-ground slabs at staggered depths and tilts
        add_quad([-350, -260, 620], [380, 0, 60], [0, 320, -40])
        add_quad([40, -60, 560], [300, 30, -50], [-30, 280, 35])
        add_quad([-260, 60, 680], [240, -20, 45], [25, 230, -30])
        # near slab (the fine stages' narrow hypothesis bands)
        add_quad([-80, -200, 505], [200, 15, 25], [-10, 170, 18])

    def render(self, K: np.ndarray, E: np.ndarray, h: int, w: int):
        """One view: (image float32 [h, w, 3] in [0, 1], depth float32 [h, w],
        the camera-frame z of the nearest hit, 0 where nothing is hit). K is
        3x3 at (h, w), E the 4x4 world-to-camera extrinsic; pixel (0, 0) is
        the centre of the top-left pixel."""
        R = E[:3, :3].astype(np.float64)
        t = E[:3, 3].astype(np.float64)
        C = -R.T @ t
        u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64),
                           indexing="xy")
        pix = np.stack([u, v, np.ones_like(u)], 0).reshape(3, -1)
        dirs = R.T @ (np.linalg.inv(K.astype(np.float64)) @ pix)  # [3, N]

        best_tau = np.full(h * w, np.inf)
        img = np.zeros((h * w, 3), np.float32)
        for p0, e1, e2, tex in self.quads:
            n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
            denom = n @ dirs
            with np.errstate(divide="ignore", invalid="ignore"):
                tau = (n @ (p0.astype(np.float64) - C)) / denom
            hit = C[:, None] + tau[None] * dirs
            rel = hit - p0.astype(np.float64)[:, None]
            g11, g12, g22 = e1 @ e1, e1 @ e2, e2 @ e2
            b1, b2 = e1 @ rel, e2 @ rel
            det = g11 * g22 - g12 * g12
            s = (g22 * b1 - g12 * b2) / det
            tt = (g11 * b2 - g12 * b1) / det
            valid = (np.isfinite(tau) & (tau > 1e-6) & (s >= 0) & (s <= 1) & (tt >= 0)
                     & (tt <= 1) & (tau < best_tau))
            if not valid.any():
                continue
            res = tex.shape[0]
            sv = np.clip(s[valid] * (res - 1), 0, res - 1 - 1e-6)
            tv = np.clip(tt[valid] * (res - 1), 0, res - 1 - 1e-6)
            s0 = sv.astype(np.int64)
            t0 = tv.astype(np.int64)
            fs = (sv - s0).astype(np.float32)[:, None]
            ft = (tv - t0).astype(np.float32)[:, None]
            img[valid] = (tex[t0, s0] * (1 - fs) * (1 - ft) + tex[t0, s0 + 1] * fs * (1 - ft)
                          + tex[t0 + 1, s0] * (1 - fs) * ft + tex[t0 + 1, s0 + 1] * fs * ft)
            best_tau[valid] = tau[valid]
        depth = np.where(np.isfinite(best_tau), best_tau, 0.0)
        return img.reshape(h, w, 3).astype(np.float32), depth.reshape(h, w).astype(np.float32)

    def point_to_surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Distance from each point [N, 3] to the union of quads (a fused
        cloud's accuracy): the distance to each quad's closest point, its
        plane coordinates clamped to the quad, and the least over quads."""
        best = np.full(len(pts), np.inf)
        for p0, e1, e2, _ in self.quads:
            rel = pts - p0[None]
            g11, g12, g22 = e1 @ e1, e1 @ e2, e2 @ e2
            b1 = rel @ e1
            b2 = rel @ e2
            det = g11 * g22 - g12 * g12
            s = np.clip((g22 * b1 - g12 * b2) / det, 0, 1)
            t = np.clip((g11 * b2 - g12 * b1) / det, 0, 1)
            closest = p0[None] + s[:, None] * e1[None] + t[:, None] * e2[None]
            best = np.minimum(best, np.linalg.norm(pts - closest, axis=1))
        return best


def lookat_extrinsic(cam_pos, target, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World-to-camera 4x4 with +z toward `target` (x right, y down)."""
    cam_pos = np.asarray(cam_pos, np.float64)
    z = np.asarray(target, np.float64) - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 0)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R.astype(np.float32)
    E[:3, 3] = (-R @ cam_pos).astype(np.float32)
    return E


def geometric_cameras(n_views: int, h: int, w: int, baseline: float = 55.0):
    """DTU-like convergent rig, all cameras looking at the scene centre:
    [(K 3x3, E 4x4), ...] at (h, w), the reference view in the middle."""
    f = 2892.33 * (w / 1600.0)  # the DTU focal length scaled to this width
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    target = np.array([0.0, 0.0, 650.0])
    cams = []
    for i in range(n_views):
        dx = baseline * ((i + 1) // 2) * (1 if i % 2 else -1)
        dy = 0.35 * baseline * ((i % 3) - 1)
        cams.append((K.copy(), lookat_extrinsic([dx, dy, 0.0], target)))
    return cams


def tnt_cameras(n_views: int, h: int, w: int, arc_deg: float = 80.0, height_deg: float = 45.0,
                roll_deg: float = 10.0, radius: float = 650.0):
    """A Tanks-and-Temples-like rig: wide-baseline views on an orbit segment
    around the scene centre at varied heights, each with a slight roll, a
    short focal length (wide field of view); the reference view in the
    middle, sources staggered outward: [(K 3x3, E 4x4), ...] at (h, w)."""
    f = 1160.0 * (w / 1920.0)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], np.float32)
    target = np.array([0.0, 0.0, 650.0])
    cams = []
    for i in range(n_views):
        t = ((i + 1) // 2) * (1 if i % 2 else -1) / max(1, (n_views - 1) // 2)
        yaw = np.deg2rad(arc_deg / 2.0 * t)
        pitch = np.deg2rad(height_deg / 2.0 * np.sin(3.1 * t))
        pos = target + radius * np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                                          -np.cos(yaw) * np.cos(pitch)])
        roll = np.deg2rad(roll_deg) * np.sin(7.3 * t)
        up = np.array([np.sin(roll), -np.cos(roll), 0.0])
        cams.append((K.copy(), lookat_extrinsic(pos, target, up=up)))
    return cams


def _depth_range(depths, ndepth: int):
    """(depth_min, interval) covering the rendered depths with a margin."""
    valid = depths[depths > 0]
    lo = float(valid.min()) * 0.94
    hi = float(valid.max()) * 1.04
    return lo, (hi - lo) / ndepth


def make_geometric_dtu(root: Path, n_views: int = 5, n_lights: int = 7, h: int = 512,
                       w: int = 640, ndepth: int = 192, seed: int = 0,
                       scene: "GeometricScene" = None):
    """The DTU training layout (Cameras/, Rectified_raw/, Depths_raw/,
    train.txt) rendered from the analytic scene, one scan 'scan1'; every
    light is the same render. Returns the scene."""
    scene = scene or GeometricScene(seed)
    root = Path(root)
    (root / "Cameras").mkdir(parents=True, exist_ok=True)
    cams = geometric_cameras(n_views, h, w)
    scan = "scan1"
    (root / "Rectified_raw" / scan).mkdir(parents=True, exist_ok=True)
    (root / "Depths_raw" / scan).mkdir(parents=True, exist_ok=True)
    renders = [scene.render(K, E, h, w) for K, E in cams]
    dmin, dint = _depth_range(np.stack([d for _, d in renders]), ndepth)

    pairs = []
    for vid, (K, E) in enumerate(cams):
        img, depth = renders[vid]
        first = root / "Rectified_raw" / scan / f"rect_{vid + 1:0>3}_0_r5000.png"
        write_png(first, (img * 255).astype(np.uint8))
        for light in range(1, n_lights):
            shutil.copyfile(first, root / "Rectified_raw" / scan
                            / f"rect_{vid + 1:0>3}_{light}_r5000.png")
        save_pfm(root / "Depths_raw" / scan / f"depth_map_{vid:0>4}.pfm", depth)
        write_png(root / "Depths_raw" / scan / f"depth_visual_{vid:0>4}.png",
                  ((depth > 0) * 255).astype(np.uint8))
        save_cam_file(root / "Cameras" / f"{vid:0>8}_cam.txt", K, E, dmin, dint)
        pairs.append((vid, [(s, 100.0) for s in range(n_views) if s != vid]))
    save_pair_file(root / "Cameras" / "pair.txt", pairs)
    (root / "train.txt").write_text(f"{scan}\n")
    return scene


def make_geometric_eval_scan(root: Path, scan: str = "scan1", n_views: int = 5, h: int = 1152,
                             w: int = 1536, ndepth: int = 192, seed: int = 0,
                             scene: "GeometricScene" = None, cameras=None):
    """The MVSNet eval layout (scan/images/*.jpg at quality 97, scan/cams,
    scan/pair.txt, every other view a source of each) rendered from the
    analytic scene, and its ground-truth depth PFMs under
    root/gt_depths/<scan>/ (the eval CLI's --gt_depth_path). `cameras`, a
    [(K, E), ...] list (e.g. tnt_cameras), replaces the DTU-like rig.
    Returns the scene."""
    scene = scene or GeometricScene(seed)
    sd = Path(root) / scan
    (sd / "images").mkdir(parents=True, exist_ok=True)
    (sd / "cams").mkdir(parents=True, exist_ok=True)
    gt_dir = Path(root) / "gt_depths" / scan
    gt_dir.mkdir(parents=True, exist_ok=True)
    cams = cameras if cameras is not None else geometric_cameras(n_views, h, w)
    depths = []
    for vid, (K, E) in enumerate(cams):
        img, depth = scene.render(K, E, h, w)
        write_jpeg(sd / "images" / f"{vid:0>8}.jpg", (img * 255).astype(np.uint8), quality=97)
        save_pfm(gt_dir / f"depth_map_{vid:0>4}.pfm", depth)
        depths.append(depth)
    dmin, dint = _depth_range(np.stack(depths), ndepth)
    for vid, (K, E) in enumerate(cams):
        save_cam_file(sd / "cams" / f"{vid:0>8}_cam.txt", K, E, dmin, dint)
    save_pair_file(sd / "pair.txt", [(r, [(s, 100.0) for s in range(n_views) if s != r])
                                      for r in range(n_views)])
    return scene


def make_blended_scan(root: Path, scan: str = "scan1", n_views: int = 8, h: int = 1536,
                      w: int = 2048, ndepth: int = 192, seed: int = 0, depth_num: bool = True,
                      nested: bool = False, scene: "GeometricScene" = None):
    """The BlendedMVS training layout rendered from the analytic scene:
    <scan>/blended_images/{id:08d}.jpg (quality 95), <scan>/cams/{id:08d}_cam.txt
    (with the depth_num and depth_max fields when `depth_num`, else the
    two-field range line), <scan>/cams/pair.txt (every other view a source
    of each) and <scan>/rendered_depth_maps/{id:08d}.pfm; with `nested`
    under <scan>/<scan>/<scan>/. Appends the scan to root/train.txt.
    Returns the scene."""
    scene = scene or GeometricScene(seed)
    sd = Path(root) / scan
    if nested:
        sd = sd / scan / scan
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        (sd / sub).mkdir(parents=True, exist_ok=True)
    cams = geometric_cameras(n_views, h, w)
    depths = []
    for vid, (K, E) in enumerate(cams):
        img, depth = scene.render(K, E, h, w)
        write_jpeg(sd / "blended_images" / f"{vid:0>8}.jpg", (img * 255).astype(np.uint8))
        save_pfm(sd / "rendered_depth_maps" / f"{vid:0>8}.pfm", depth)
        depths.append(depth)
    dmin, dint = _depth_range(np.stack(depths), ndepth)
    extra = dict(depth_num=ndepth, depth_max=dmin + ndepth * dint) if depth_num else {}
    for vid, (K, E) in enumerate(cams):
        save_cam_file(sd / "cams" / f"{vid:0>8}_cam.txt", K, E, dmin, dint, **extra)
    save_pair_file(sd / "cams" / "pair.txt",
                   [(r, [(s, 100.0 - abs(s - r)) for s in range(n_views) if s != r])
                    for r in range(n_views)])
    with open(Path(root) / "train.txt", "a") as f:
        f.write(f"{scan}\n")
    return scene
