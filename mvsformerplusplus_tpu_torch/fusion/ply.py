"""Binary PLY point clouds (counterpart of
mvsformerplusplus_tpu/fusion/ply.py): float32 x/y/z and uint8
red/green/blue, binary little endian, the vertex layout the DTU MATLAB
evaluator and the Tanks and Temples tooling read.
"""
from __future__ import annotations

import numpy as np


def write_ply(filename, points: np.ndarray, colors: np.ndarray = None) -> None:
    """points: [N, 3] float; colors: [N, 3] uint8 (optional)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    with_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if with_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    if with_color:
        dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                          ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        rec = np.empty(n, dtype)
        rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
        colors = np.asarray(colors, np.uint8)
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    else:
        dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec = np.empty(n, dtype)
        rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]

    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def read_ply(filename):
    """Minimal reader for round-trip tests: returns (points, colors|None)."""
    with open(filename, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if "red" in props:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        rec = np.fromfile(f, np.dtype(fields), count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1)
    cols = None
    if "red" in props:
        cols = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
    return pts, cols
