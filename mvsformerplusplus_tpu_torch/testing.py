"""Inputs for the checks that hold the port to a reference (the CPU parity
tests against the JAX package and chip_smoke.py's card-vs-CPU phases), kept
in one place so that both hold the same batch: numpy only."""
from __future__ import annotations

import numpy as np


def conditioned_train_batch(seed=0, b=1, v=3, h=64, w=64, dfull=48, near=4.0, far=5.0):
    """A train batch that two numerically different runs of the model can be
    compared on: images, in-view cameras (principal point at the centre,
    baselines of 0.4 along x, depth range 4-5), per-stage ground truth and
    80% masks. Every hypothesis stays positive and no CE stage hands on an
    argmax depth near a tie, so both runs take the same hypotheses at every
    stage."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(b, v, h, w, 3).astype(np.float32)
    cams = {}
    for s in range(4):
        scale = 0.125 * 2 ** s
        cam = np.zeros((b, v, 2, 4, 4), np.float32)
        for vi in range(v):
            c, sn = np.cos(0.02 * vi), np.sin(0.02 * vi)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
            ext[0, 3] = 0.4 * vi
            cam[:, vi, 0] = ext
            f = w * scale
            cam[:, vi, 1, :3, :3] = [[f, 0, w * scale / 2], [0, f, h * scale / 2], [0, 0, 1]]
        cams[f"stage{s + 1}"] = cam
    gt = {f"stage{i + 1}": rng.uniform(near, far, (b, h >> (3 - i), w >> (3 - i))).astype(
        np.float32) for i in range(4)}
    return {"imgs": imgs, "cams": cams,
            "depth_values": np.linspace(near, far, dfull, dtype=np.float32)[None].repeat(b, 0),
            "depth_gt": gt,
            "mask": {k: (rng.rand(*g.shape) > 0.2).astype(np.float32) for k, g in gt.items()}}


def well_conditioned(depth_values, far: float) -> np.ndarray:
    """[B, D, H, W] hypotheses -> [B, H, W] mask of the pixels whose
    hypotheses are all positive and below 4x the far depth. With random
    weights a later stage's inverse-depth band can cross zero inverse depth;
    there a hypothesis 1/inv is huge and the soft-argmax amplifies rounding
    by orders of magnitude, so depths are compared only where this holds."""
    dv = np.asarray(depth_values)
    return ((dv > 0) & (dv < 4 * far)).all(axis=1)
