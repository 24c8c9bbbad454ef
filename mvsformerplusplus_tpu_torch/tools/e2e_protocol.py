"""The end-to-end accuracy protocol on the port (counterpart of the repo's
tools/e2e_protocol.py): train from scratch on an analytic scene, then depth
inference, depth metrics against the exact ground truth and fusion with
each filter, the clouds scored against the scene's surface.

    python -m mvsformerplusplus_tpu_torch.tools.e2e_protocol [--root DIR] [--epochs 8]
        [--flagship-epochs 40] [--models casmvs,flagship] [--skip-train]
        [--out FILE] [--device cuda|cpu]

At the DTU evaluation protocol (5 views, 1152 x 1536, 192 depth
hypotheses) for both model families, with the JAX tool's architectures:
CASMVS_ARCH, the CNN cascade, and FLAGSHIP_ARCH, the full DINOv2MVSNet
composition with a tiny ViT trained from scratch (48 channels, 3 blocks,
heads of 24). Per model:
1. render the analytic scene (data/synthetic.GeometricScene, exact depth)
   as a DTU-format train set at the protocol's resolution, which the
   multi-scale loader crops at 512 x 640, 768 x 960 and 1024 x 1280, and
   an MVSNet-format eval scan;
2. train with the port's training command line
   (python -m mvsformerplusplus_tpu_torch.train, run in this process);
3. run the port's eval command line (python -m mvsformerplusplus_tpu_torch.eval)
   at the protocol: depth_metric.txt against the analytic depth;
4. fuse with each filter (pcd, dpcd, gipuma; depth inference once, the
   others with --skip_depth) and score each cloud: accuracy, each point's
   distance to the scene's surface; completeness, each back-projected
   ground-truth point's (every 29th pixel of the reference view) distance
   to its nearest fused point, found exactly in torch on the run's device
   (float64, centred, by differences: in float32 the points' distance from
   the origin, hundreds of mm, would swamp distances of 0.1 mm; pruned by
   x-sorted ranges, nearest_distance);
5. write the results to --out (default <root>/e2e_protocol_metrics.json)
   after each model, beside the other models an earlier run of the file
   holds.

The renders record their resolution (<root>/render.json): a train set or
eval scan of another resolution is rendered again. Each filter starts by
deleting the scan's cloud, so a filter that keeps no point scores none.
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.io import read_cam_file, read_pfm
from ..data.synthetic import GeometricScene, make_geometric_dtu, make_geometric_eval_scan
from ..eval import cli as eval_cli
from ..fusion.ply import read_ply
from ..train import cli as train_cli

H, W = 1152, 1536
TRAIN_H, TRAIN_W = 512, 640
DEPTHS = 192
# the train crops and the micro-batch of each crop height (scale_batch_map)
CROPS = ((TRAIN_H, TRAIN_W), (768, 960), (1024, 1280))
MICRO = {str(TRAIN_H): 2, "768": 1, "1024": 1}

CASMVS_ARCH = {
    "model_type": "casmvs",
    "feat_chs": [8, 16, 32, 64], "base_ch": [8, 8, 8, 8],
    "ndepths": [32, 16, 8, 4],
    "depth_interals_ratio": [4.0, 2.67, 1.5, 1.0],
    "depth_type": ["ce", "ce", "ce", "ce"],
    "inverse_depth": True,
    "cost_reg_type": ["Normal", "Normal", "Normal", "Normal"],
}

# configs/mvsformerplusplus.json's arguments with only the ViT scaled down
# (48 channels x 3 blocks, trained from scratch): the SVA decoder, FMT and
# its pathway, the CTA with its 3D position encoding all at their shapes
FLAGSHIP_ARCH = {
    "model_type": "DINOv2-tiny",
    "feat_chs": [8, 16, 32, 64], "base_ch": [8, 8, 8, 8],
    "ndepths": [32, 16, 8, 4],
    "depth_interals_ratio": [4.0, 2.67, 1.5, 1.0],
    "depth_type": ["ce", "ce", "ce", "ce"],
    "inverse_depth": True,
    "cost_reg_type": ["PureTransformerCostReg", "Normal", "Normal", "Normal"],
    "use_pe3d": True,
    "rescale": 0.4375,
    "freeze_vit": False,
    "vit_ch": 48, "vit_depth": 3, "vit_num_heads": 2, "out_ch": 64,
    "dino_cfg": {
        "cross_interval_layers": 3,
        "decoder_cfg": {
            "attention_type": "Linear", "d_model": 48, "nhead": 2,
            "ffn_type": "ffn", "init_values": 1.0, "prev_values": 0.5,
            "post_norm": False, "pre_norm_query": True,
            "no_combine_norm": False,
            "softmax_scale": "entropy_invariance", "train_avg_length": 762,
        },
    },
    "FMT_config": {
        "attention_type": "Linear", "base_channel": 8, "d_model": 64,
        "ffn_type": "ffn", "init_values": 1.0,
        "layer_names": ["self", "cross", "self", "cross"], "nhead": 4,
        "post_norm": False, "pre_norm_query": False,
        "softmax_scale": "entropy_invariance", "train_avg_length": 12185,
    },
    "transformer_config": [{
        "base_channel": 8, "down_rate": [2, 4, 4], "layer_num": 6,
        "mid_channel": 64, "mlp_ratio": 4, "num_heads": 4,
        "position_encoding": True, "softmax_scale": "entropy_invariance",
        "train_avg_length": 12185, "use_pe_proj": True,
        # trained from scratch: near-zero residual gammas keep the 6-layer
        # post-norm CTA near the identity at first, so the correlation
        # reaches the probability head from the first steps
        "init_values": 0.01,
    }],
}

ARCHS = {"casmvs": CASMVS_ARCH, "flagship": FLAGSHIP_ARCH}

# (name, eval CLI arguments) of the three fusion filters
FILTERS = (
    ("pcd", ["--filter_method", "pcd", "--conf", "0.3", "--fusion_view", "5"]),
    ("dpcd", ["--filter_method", "dpcd", "--conf", "0.3", "--fusion_view", "5"]),
    ("gipuma", ["--filter_method", "gipuma", "--prob_threshold", "0.3",
                "--disp_threshold", "1.0", "--num_consistent", "2", "--fusion_view", "5"]),
)


def render_key() -> dict:
    return {"h": H, "w": W, "depths": DEPTHS}


def build_data(root: Path, scene: Optional[GeometricScene] = None):
    """(scene, train_root, eval_root): the scene (built here unless given),
    the DTU-format train set (5 views x 7 lights at H x W, 32 hypotheses,
    val.txt naming its one scan) and the 5-view eval scan, both rendered
    again unless <root>/render.json records this resolution and DEPTHS."""
    root = Path(root)
    scene = scene or GeometricScene(0, tex_res=4096)
    tr, ev = root / "train_data", root / "eval_data"
    record = root / "render.json"
    key = render_key()
    fresh = (record.exists() and json.loads(record.read_text()) == key
             and (tr / "train.txt").exists() and (ev / "gt_depths").exists())
    if not fresh:
        for d in (tr, ev):
            shutil.rmtree(d, ignore_errors=True)
        record.unlink(missing_ok=True)
        print(f"rendering train set ({H}x{W})...", flush=True)
        make_geometric_dtu(tr, n_views=5, n_lights=7, h=H, w=W, ndepth=32, scene=scene)
        (tr / "val.txt").write_text("scan1\n")
        print(f"rendering eval scan ({H}x{W})...", flush=True)
        make_geometric_eval_scan(ev, n_views=5, h=H, w=W, ndepth=DEPTHS, scene=scene)
        root.mkdir(parents=True, exist_ok=True)
        record.write_text(json.dumps(key))
    return scene, tr, ev


def nearest_distance(query: np.ndarray, points: np.ndarray, device="cpu", q_chunk: int = 1024,
                     reach: float = 2.0, p_chunk: int = 1 << 15) -> np.ndarray:
    """Distance from each query [Q, 3] to its nearest point of [P, 3], exact,
    in torch on `device`: float64 coordinates centred on the points' mean,
    distances by differences (the matrix-product form cancels
    catastrophically where points lie hundreds of mm from the origin and
    apart by 0.1 mm). Points are sorted by x and queries taken in x order,
    `q_chunk` at a time, against the points within `reach` of the chunk in
    x; a query whose nearest point found lies farther than `reach` (or none
    lies within it) is searched again within its distance, which bounds
    its nearest point's |dx|."""
    dev = torch.device(device)
    centre = points.astype(np.float64).mean(0)
    pts = torch.from_numpy(points.astype(np.float64) - centre).to(dev)
    qs = torch.from_numpy(np.asarray(query, np.float64) - centre).to(dev)
    px, order = pts[:, 0].sort()
    pts = pts[order].contiguous()
    out = torch.full((len(qs),), float("inf"), dtype=torch.float64, device=dev)

    def search(idx, r):
        q = qs[idx]
        lo = int(torch.searchsorted(px, q[:, 0].min() - r))
        hi = int(torch.searchsorted(px, q[:, 0].max() + r, right=True))
        best = torch.full((len(idx),), float("inf"), dtype=torch.float64, device=dev)
        for j in range(lo, hi, p_chunk):
            d2 = ((q[:, None, :] - pts[None, j:min(j + p_chunk, hi), :]) ** 2).sum(-1)
            best = torch.minimum(best, d2.min(dim=1).values)
        return best.sqrt()

    by_x = qs[:, 0].argsort()
    for i in range(0, len(by_x), q_chunk):
        idx = by_x[i:i + q_chunk]
        out[idx] = search(idx, reach)
    far = by_x[out[by_x] > reach]  # still in x order
    for i in range(0, len(far), q_chunk):
        idx = far[i:i + q_chunk]
        out[idx] = search(idx, float(out[idx].max()))
    return out.cpu().numpy()


def gt_surface_points(eval_root: Path, step: int = 29) -> np.ndarray:
    """The reference view's ground-truth depth back-projected to world
    points, every `step`-th pixel."""
    gt, _ = read_pfm(eval_root / "gt_depths" / "scan1" / "depth_map_0000.pfm")
    K, E, _, _, _ = read_cam_file(eval_root / "scan1" / "cams" / "00000000_cam.txt")
    h, w = gt.shape
    yy, xx = np.mgrid[0:h, 0:w]
    rays = np.linalg.inv(K) @ np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)], 0)
    cam_pts = rays * gt.ravel()[None]
    return (E[:3, :3].T @ (cam_pts - E[:3, 3][:, None])).T[::step]


def cloud_metrics(scene: GeometricScene, ply_path: Path, eval_root: Path,
                  device="cpu") -> dict:
    """A fused cloud's point count, accuracy (distance to the scene's
    surface) and completeness (the ground truth's distance to the cloud),
    mean and median in mm; the count alone for an empty cloud."""
    pts, _ = read_ply(ply_path)
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    if not len(pts):
        return {"n_points": 0}
    acc = scene.point_to_surface_distance(pts)
    comp = nearest_distance(gt_surface_points(eval_root), pts, device)
    return {
        "n_points": int(len(pts)),
        "accuracy_mean_mm": round(float(np.mean(acc)), 4),
        "accuracy_median_mm": round(float(np.median(acc)), 4),
        "completeness_mean_mm": round(float(np.mean(comp)), 4),
        "completeness_median_mm": round(float(np.median(comp)), 4),
    }


def model_config(name: str, arch: dict, mroot: Path, tr: Path, epochs: int,
                 device: str = "cuda", tensorboard: bool = False) -> dict:
    """The JAX tool's training config for one model: DTULoader over the
    train set, three crop buckets (the reference's 25 reduced to its ends
    and middle), vit_lr = lr (the tiny ViT trains from scratch), remat of
    whole stages at the 1024-row crops; bf16 on the card, fp32 on the CPU
    (as every CPU path of the port trains)."""
    (h0, w0) = CROPS[0]
    return {
        "name": f"e2e_protocol_{name}",
        "arch": {"bf16": device != "cpu", "args": arch},
        "data_loader": [{"type": "DTULoader", "args": {
            "datapath": str(tr), "train_data_list": str(tr / "train.txt"),
            "mode": "train", "nviews": 5, "num_depths": 32,
            "interval_scale": 1.06, "batch_size": 2,
            "val_data_list": str(tr / "val.txt"),
            "height": h0, "width": w0,
            "random_crop": True, "augment": False, "num_workers": 4,
            "multi_scale_args": {"scales": [list(c) for c in CROPS],
                                 "resize_range": [1.0, 1.2],
                                 "scale_batch_map": dict(MICRO)},
        }}],
        "optimizer": {"args": {"lr": 3e-3, "vit_lr": 3e-3, "warmup_steps": 20,
                               "min_lr": 0.05, "weight_decay": 0.01}},
        "trainer": {"epochs": epochs, "save_dir": str(mroot / "saved"),
                    "logging_every": 10, "monitor": "min mean_error", "early_stop": 100,
                    "remat_map": {"1024": "stage"}, "tensorboard": tensorboard},
    }


def _depth_metrics(path: Path) -> dict:
    out = {}
    if path.exists():
        for line in path.read_text().splitlines():
            if ":" in line:
                k, v = line.split(":", 1)
                try:
                    out[k.strip()] = round(float(v.split()[0]), 6)
                except ValueError:
                    pass
    return out


def run_model(name: str, arch: dict, root: Path, scene: GeometricScene, tr: Path, ev: Path,
              epochs: int, skip_train: bool = False, device: str = "cuda",
              tensorboard: bool = False) -> dict:
    """Train one model (unless skip_train), evaluate and fuse with each
    filter; returns {"train_epochs", "train_seconds", filter: {depth
    metrics, eval_seconds, image_decodes (the eval CLI's), cloud
    metrics}}."""
    mroot = Path(root) / name
    mroot.mkdir(parents=True, exist_ok=True)
    cfg = model_config(name, arch, mroot, tr, epochs, device, tensorboard)
    (mroot / "cfg.json").write_text(json.dumps(cfg))
    t0 = time.time()
    if not skip_train:
        train_cli.main(["-c", str(mroot / "cfg.json"), "--save_dir", str(mroot / "saved"),
                        "--device", device])
        if device == "cuda":
            torch.cuda.empty_cache()
    results = {"train_epochs": epochs, "train_seconds": round(time.time() - t0, 1),
               "eval_resolution": f"{H}x{W}"}
    (Path(root) / "list.txt").write_text("scan1\n")
    out = mroot / "out"
    for i, (fname, extra) in enumerate(FILTERS):
        (out / "scan1.ply").unlink(missing_ok=True)
        t0 = time.time()
        stats = eval_cli.main(["--config", str(mroot / "cfg.json"),
                               "--ckpt", str(mroot / "saved" / "checkpoints"),
                               "--testpath", str(ev), "--testlist", str(Path(root) / "list.txt"),
                               "--outdir", str(out), "--gt_depth_path", str(ev / "gt_depths"),
                               "--num_view", "5", "--numdepth", str(DEPTHS),
                               "--max_h", str(H), "--max_w", str(W),
                               "--device", device] + extra + (["--skip_depth"] if i else []))
        entry = {"eval_seconds": round(time.time() - t0, 1),
                 "image_decodes": stats["decodes"] + stats["fusion_decodes"]}
        entry.update(_depth_metrics(out / "depth_metric.txt"))
        if (out / "scan1.ply").exists():
            entry.update(cloud_metrics(scene, out / "scan1.ply", ev, device))
        else:
            entry["n_points"] = 0
        results[fname] = entry
        print(name, fname, json.dumps(entry), flush=True)
    return results


def run(root: Path, models=("casmvs", "flagship"), epochs: int = 8, flagship_epochs: int = 40,
        skip_train: bool = False, device: str = "cuda", tensorboard: bool = False,
        out: Optional[Path] = None,
        scene: Optional[GeometricScene] = None) -> dict:
    """The whole protocol: render once, then each model; returns the results
    and writes them to `out` (default <root>/e2e_protocol_metrics.json)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    scene, tr, ev = build_data(root, scene)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    results = {"protocol": f"5 views, {H}x{W}, {DEPTHS} depths, "
                           f"{'fp32' if device == 'cpu' else 'bf16'}, {kind}",
               "note": "both models trained from scratch on the analytic scene; flagship = "
                       "the full DINOv2MVSNet composition with a tiny ViT (48ch x 3 blocks) "
                       "trained with it",
               "render": render_key()}
    out = Path(out) if out is not None else root / "e2e_protocol_metrics.json"
    if out.exists():
        try:
            earlier = json.loads(out.read_text())
        except json.JSONDecodeError:
            earlier = {}
        results.update({k: v for k, v in earlier.items() if k in ARCHS and k not in models})
    for name in models:
        ep = flagship_epochs if name == "flagship" else epochs
        results[name] = run_model(name, ARCHS[name], root, scene, tr, ev, ep, skip_train,
                                  device, tensorboard)
        out.write_text(json.dumps(results, indent=2) + "\n")  # after each model
        print("wrote", out, flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvsformerplusplus_tpu_torch.tools.e2e_protocol")
    ap.add_argument("--root", default="e2e_protocol")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--flagship-epochs", type=int, default=40,
                    help="the flagship's epochs (its transformer stack, trained from scratch, "
                         "converges far slower than the CNN cascade)")
    ap.add_argument("--models", default="casmvs,flagship")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse the checkpoints of an earlier run under --root")
    ap.add_argument("--out", default=None,
                    help="results file (default <root>/e2e_protocol_metrics.json)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the protocol runs on the card and CUDA is not available; pass "
                         "--device cpu to run it on the CPU")
    run(Path(args.root), tuple(args.models.split(",")), args.epochs, args.flagship_epochs,
        args.skip_train, args.device, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
