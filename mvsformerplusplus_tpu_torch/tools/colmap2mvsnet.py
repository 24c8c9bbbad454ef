"""COLMAP sparse reconstruction -> MVSNet-format scan (cams/, images/,
pair.txt), the repo's tools/colmap2mvsnet.py on the port: the same readers,
depth ranges, view selection and files, written with this package's
writers and, for --convert_format, read and encoded by its own image codecs
(data/io.imread_rgb, OpenCV's imread; data/jpeg.write_jpeg at quality 95,
cv2.imwrite's default). No OpenCV is needed.

Per view the depth range is the 1% / 99% percentile of its visible sparse
points' depths (a view without points takes the scene's points in front of
it); the view-selection score of a pair is sum_p exp(-(theta - theta0)^2 /
2 sigma^2) over the points both see, sigma = sigma1 below theta0 and sigma2
above; --max_d 0 derives each view's depth count from its inverse-depth
step.

    python -m mvsformerplusplus_tpu_torch.tools.colmap2mvsnet \\
        --dense_folder SCENE [--max_d 256] [--convert_format]

SCENE holds sparse/ (cameras, images, points3D as .bin or .txt) and
images_col/; the scan is written into SCENE.
"""
from __future__ import annotations

import argparse
import collections
import shutil
import struct
from pathlib import Path

import numpy as np

from ..data.io import imread_rgb, save_cam_file, save_pair_file
from ..data.jpeg import write_jpeg

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple("Image", ["id", "qvec", "tvec", "camera_id", "name", "point3d_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz"])

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}

# each model's parameter names, in COLMAP's order
PARAM_NAMES = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"], "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "k4", "sx1",
                           "sy1"],
}


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
    ])


# --- binary readers ---------------------------------------------------------

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cid] = Camera(cid, name, w, h, params)
    return cams


def read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c in (b"\x00", b""):
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.fromfile(f, np.dtype("<f8, <f8, <i8"), count=npts)
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode(), data["f2"])
    return images


def read_points3d_bin(path):
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            f.read(3 + 8)  # rgb, error
            (tl,) = _read(f, "<Q")
            f.read(8 * tl)
            pts[pid] = Point3D(pid, xyz)
    return pts


# --- text readers -----------------------------------------------------------

def _lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#") and ln.strip()]


def read_cameras_txt(path):
    cams = {}
    for line in _lines(path):
        el = line.split()
        cams[int(el[0])] = Camera(int(el[0]), el[1], int(el[2]), int(el[3]),
                                  np.array(list(map(float, el[4:]))))
    return cams


def read_images_txt(path):
    images = {}
    lines = _lines(path)
    for meta, pts in zip(lines[0::2], lines[1::2]):
        el = meta.split()
        pids = np.array(list(map(int, pts.split()[2::3])))
        images[int(el[0])] = Image(
            int(el[0]), np.array(list(map(float, el[1:5]))),
            np.array(list(map(float, el[5:8]))), int(el[8]), el[9], pids)
    return images


def read_points3d_txt(path):
    pts = {}
    for line in _lines(path):
        el = line.split()
        pts[int(el[0])] = Point3D(int(el[0]), np.array(list(map(float, el[1:4]))))
    return pts


def read_model(model_dir):
    model_dir = Path(model_dir)
    if (model_dir / "cameras.bin").exists():
        return (read_cameras_bin(model_dir / "cameras.bin"),
                read_images_bin(model_dir / "images.bin"),
                read_points3d_bin(model_dir / "points3D.bin"))
    return (read_cameras_txt(model_dir / "cameras.txt"),
            read_images_txt(model_dir / "images.txt"),
            read_points3d_txt(model_dir / "points3D.txt"))


# --- conversion -------------------------------------------------------------

def intrinsics_of(cam: Camera) -> np.ndarray:
    d = dict(zip(PARAM_NAMES[cam.model], cam.params))
    fx = d.get("fx", d.get("f"))
    fy = d.get("fy", d.get("f"))
    return np.array([[fx, 0, d["cx"]], [0, fy, d["cy"]], [0, 0, 1]])


def _depth_range(v, images, extr, intr, pid_to_xyz, all_xyz, max_d, interval_scale):
    pids = [p for p in images[v].point3d_ids if p != -1 and p in pid_to_xyz]
    xyz = np.array([pid_to_xyz[p] for p in pids]) if pids else all_xyz
    z = (extr[v][:3, :3] @ xyz.T + extr[v][:3, 3:4])[2]
    if not pids:
        z = z[z > 0]  # scene points behind this camera can't bound it
    z = np.sort(z)
    depth_min = z[int(len(z) * 0.01)]
    depth_max = z[int(len(z) * 0.99)]
    if max_d == 0:
        # the depth count whose inverse-depth steps match one pixel at depth_min
        K = intr[images[v].camera_id]
        p1 = np.array([K[0, 2], K[1, 2], 1.0])
        p2 = np.array([K[0, 2] + 1, K[1, 2], 1.0])
        P1 = np.linalg.inv(K) @ p1 * depth_min
        P2 = np.linalg.inv(K) @ p2 * depth_min
        step = np.linalg.norm(P2 - P1)
        depth_num = (1 / depth_min - 1 / depth_max) / (1 / depth_min - 1 / (depth_min + step))
    else:
        depth_num = max_d
    depth_interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
    return depth_min, depth_interval, depth_num, depth_max


def convert(dense_folder, max_d=256, interval_scale=1.0, theta0=5.0,
            sigma1=1.0, sigma2=10.0, n_pairs=10, convert_format=False,
            image_subdir="images_col", model_subdir="sparse", write=True):
    """The JAX tool's convert: returns (depth_ranges {image id: (min,
    interval, num, max)}, view_sel [[(index, score), ...] per view]) and,
    with `write`, writes cams/, images/ and pair.txt into dense_folder."""
    dense = Path(dense_folder)
    cameras, images, points3d = read_model(dense / model_subdir)
    idx_list = sorted(images.keys())
    n = len(idx_list)

    intr = {cid: intrinsics_of(c) for cid, c in cameras.items()}
    extr = {}
    for iid, im in images.items():
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(im.qvec)
        e[:3, 3] = im.tvec
        extr[iid] = e

    pid_to_xyz = {pid: p.xyz for pid, p in points3d.items()}
    all_xyz = np.array(list(pid_to_xyz.values()))
    depth_ranges = {v: _depth_range(v, images, extr, intr, pid_to_xyz, all_xyz, max_d,
                                    interval_scale) for v in idx_list}

    # view-selection scores, vectorised over the points each pair sees
    centers = {v: -extr[v][:3, :3].T @ extr[v][:3, 3] for v in idx_list}
    vis_sets = {v: set(int(p) for p in images[v].point3d_ids if p != -1 and p in pid_to_xyz)
                for v in idx_list}
    score = np.zeros((n, n))
    for i in range(n):
        vi = idx_list[i]
        for j in range(i + 1, n):
            vj = idx_list[j]
            common = vis_sets[vi] & vis_sets[vj]
            if not common:
                continue
            p = np.array([pid_to_xyz[pid] for pid in common])
            a = centers[vi] - p
            b = centers[vj] - p
            cos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
            theta = np.degrees(np.arccos(np.clip(cos, -1, 1)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            s = np.sum(np.exp(-((theta - theta0) ** 2) / (2 * sigma**2)))
            score[i, j] = score[j, i] = s

    view_sel = []
    for i in range(n):
        order = np.argsort(score[i])[::-1]
        view_sel.append([(int(k), float(score[i, k])) for k in order[:n_pairs]])

    if not write:
        return depth_ranges, view_sel

    cam_dir = dense / "cams"
    img_dir = dense / "images"
    cam_dir.mkdir(exist_ok=True)
    img_dir.mkdir(exist_ok=True)
    for i, v in enumerate(idx_list):
        dmin, dint, dnum, dmax = depth_ranges[v]
        save_cam_file(cam_dir / f"{i:0>8}_cam.txt", intr[images[v].camera_id], extr[v], dmin,
                      dint, dnum, dmax)
        src = dense / image_subdir / images[v].name
        dst = img_dir / f"{i:0>8}.jpg"
        if convert_format:
            write_jpeg(dst, imread_rgb(src), quality=95)
        elif src.exists() and not dst.exists():
            shutil.copyfile(src, dst)
    save_pair_file(dense / "pair.txt", list(enumerate(view_sel)))
    return depth_ranges, view_sel


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--max_d", type=int, default=256)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--theta0", type=float, default=5.0)
    p.add_argument("--sigma1", type=float, default=1.0)
    p.add_argument("--sigma2", type=float, default=10.0)
    p.add_argument("--convert_format", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return convert(args.dense_folder, args.max_d, args.interval_scale, args.theta0,
                   args.sigma1, args.sigma2, convert_format=args.convert_format)


if __name__ == "__main__":
    main()
