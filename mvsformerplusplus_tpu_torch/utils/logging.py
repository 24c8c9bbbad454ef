"""The training run's scalar and image sinks (counterpart of
mvsformerplusplus_tpu/utils/logging.py): `scalars.jsonl`, one JSON record
{"time", "mode", "step", ...} per write, and PNG panels of depth, ground
truth, error and confidence under `images/`, written with the port's own
PNG encoder (data/io.py).

With `tensorboard` (the config's trainer.tensorboard) both are mirrored, as
the JAX writers mirror them to tensorboardX, into a TensorBoard event file
under save_dir/tb (utils/tfevents.py, no tensorboard package): each scalar
as "{mode}/{name}", each panel as the image "{mode}/{panel}" (depth_gt,
depth_est, abs_error, confidence). Across ranks only rank 0 writes.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..data.io import write_png
from ..parallel.dist import is_writer
from .tfevents import EventWriter


class ScalarWriter:
    """Appends one record per `write` to save_dir/scalars.jsonl (the file
    opened for each record: a run writes one every logged step) and, with
    `tensorboard`, one event per scalar to the event file under
    save_dir/tb (`self.tb`, which the ImageWriter shares)."""

    def __init__(self, save_dir, tensorboard: bool = False):
        self.path = Path(save_dir) / "scalars.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.tb = EventWriter(Path(save_dir) / "tb") if tensorboard else None

    def write(self, mode: str, scalars: Dict[str, float], step: int):
        if not is_writer():  # across ranks only rank 0 writes
            return
        rec = {"time": time.time(), "mode": mode, "step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{mode}/{k}", float(v), int(step))


def _colorize(x: np.ndarray, lo: float = None, hi: float = None,
              mask: Optional[np.ndarray] = None) -> np.ndarray:
    """[H, W] float -> uint8 [H, W, 3] on a blue-green-red ramp over [lo,
    hi], by default the 2nd and 98th percentiles of the finite (and masked)
    values; zero outside the mask, black where nothing is finite."""
    x = np.asarray(x, np.float32)
    finite = np.isfinite(x)
    sel = finite if mask is None else (finite & (mask > 0.5))
    vals = x[sel]
    if vals.size == 0:
        return np.zeros((*x.shape, 3), np.uint8)
    lo = float(np.percentile(vals, 2)) if lo is None else lo
    hi = float(np.percentile(vals, 98)) if hi is None else hi
    t = np.clip((np.where(finite, x, lo) - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    img = np.stack([r, g, b], -1)
    if mask is not None:
        img = img * (mask > 0.5)[..., None]
    return (img * 255).astype(np.uint8)


class ImageWriter:
    """One PNG per `write`, save_dir/images/{mode}_step{step:08d}.png: the
    panels depth_gt, depth_est (on the ground truth's range) and abs_error
    where a ground truth is given, else depth_est alone; then confidence
    on [0, 1] where given; side by side. Each panel also goes to `tb` (an
    EventWriter) where one is given."""

    def __init__(self, save_dir, tb: Optional[EventWriter] = None):
        self.dir = Path(save_dir) / "images"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.tb = tb

    def write(self, mode: str, step: int, depth_est: np.ndarray,
              depth_gt: Optional[np.ndarray] = None, confidence: Optional[np.ndarray] = None,
              mask: Optional[np.ndarray] = None):
        """All inputs [H, W] host arrays (the first sample of a batch)."""
        if not is_writer():  # across ranks only rank 0 writes
            return
        depth_est = np.asarray(depth_est, np.float32)
        m = None if mask is None else np.asarray(mask, np.float32)
        if depth_gt is not None:
            gt = np.asarray(depth_gt, np.float32)
            sel = gt > 0 if m is None else (m > 0.5)
            lo = float(np.percentile(gt[sel], 2)) if sel.any() else None
            hi = float(np.percentile(gt[sel], 98)) if sel.any() else None
            panels = [("depth_gt", _colorize(gt, lo, hi, m)),
                      ("depth_est", _colorize(depth_est, lo, hi)),
                      ("abs_error", _colorize(np.abs(depth_est - gt), 0.0, None, m))]
        else:
            panels = [("depth_est", _colorize(depth_est))]
        if confidence is not None:
            panels.append(("confidence", _colorize(np.asarray(confidence, np.float32), 0.0, 1.0)))
        write_png(self.dir / f"{mode}_step{step:08d}.png",
                  np.concatenate([p for _, p in panels], axis=1))
        if self.tb is not None:
            for name, img in panels:
                self.tb.add_image(f"{mode}/{name}", img, int(step))
