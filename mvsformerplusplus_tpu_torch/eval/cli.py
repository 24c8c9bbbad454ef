"""The evaluation command line (counterpart of the repo's test.py): depth
inference over MVSNet-format scans, then geometric fusion of each scan into
a point cloud.

    python -m mvsformerplusplus_tpu_torch.eval --config configs/mvsformerplusplus.json \\
        --testpath DIR --testlist LIST [--outdir outputs] [--ckpt DIR | --ckpt_npz FILE] \\
        [--filter_method dpcd|pcd|gipuma|none] [--gt_depth_path DIR] [--skip_depth] \\
        [--device cuda|cpu] [--rank R --world N | --schedule queue [--reclaim_stale S]] ...

Per reference view it writes, under --outdir/<scan>/, the depth map
(depth_est/<view>.pfm), the confidence as uint8 (confidence/<view>.npy,
clip(conf, 0, 1) * 255), the full-resolution camera (cams/<view>_cam.txt)
and the reference image (images/<view>.jpg, quality 95, 4:2:0); with
--gt_depth_path, the mean depth metrics in --outdir/depth_metric.txt. Then
one --outdir/<scan>.ply per scan, coloured from the written images.

Weights: --ckpt, a checkpoints directory of the training command line (its
best epoch, else its last); --ckpt_npz, a converted reference checkpoint
(convert.load_npz); with neither, weights drawn from a seed (a warning says
so) and the frozen ViT from arch.args.vit_path when that file exists, the
converted flax .npz or else the original DINOv2 torch .pth, chosen by
suffix as test.py's load_vit_tree does (convert.load_vit; CasMVSNet,
model_type "casmvs", has no ViT and loads nothing).

It runs on the card; without CUDA it raises unless --device cpu is given.

Workers: several processes of this command line share the scans, as
test.py's do. --rank/--world strides the scan list (all_scans[rank::world]);
--schedule queue claims scans from the file-system work queue under
--outdir (parallel/scheduler.py, the JAX package's claim files: workers of
either package can share one queue), heartbeating its claim after every
view and marking a scan done after its last view's files are written; with
--reclaim_stale S it also takes over claims whose owner has been silent
for S seconds. Each worker fuses the scans it did. With --world > 1 the
depth metrics go to depth_metric.rank{rank}.txt, under the queue to
depth_metric.pid{pid}.txt, and each worker then merges every such file into
depth_metric.txt (a mean weighted by views). On the card each worker takes
cuda:{rank % card count}, so several workers can share one card.
"""
from __future__ import annotations

import argparse
import functools
import logging
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import build_model, load_config
from ..convert import load_npz, load_vit
from ..data.eval_dataset import EvalDataset
from ..data.image import resize_linear, resize_nearest
from ..data.io import build_camera_stack, read_cam_file, read_image, read_pair_file, read_pfm
from ..data.io import save_cam_file, save_pfm
from ..data.jpeg import write_jpeg
from ..data.loader import EvalLoader
from ..fusion.fusion import dpcd_fuse, gipuma_fuse, pcd_fuse
from ..fusion.ply import write_ply
from ..parallel.scheduler import WorkQueue
from ..train.checkpoints import CheckpointManager
from ..train.metrics import depth_metrics

log = logging.getLogger("mvsformerplusplus_tpu_torch")



def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mvsformerplusplus_tpu_torch.eval",
                                description="Depth maps and point clouds of MVSNet-format scans "
                                            "on one card, by one worker of several.")
    p.add_argument("--config", required=True)
    p.add_argument("--dataset", default="dtu", choices=["dtu", "tt", "eth3d", "custom"])
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--outdir", default="outputs")
    p.add_argument("--ckpt", default=None, help="checkpoints directory of the training CLI")
    p.add_argument("--ckpt_npz", default=None,
                   help="converted reference checkpoint (tools/convert_reference.py)")
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--max_h", type=int, default=1152)
    p.add_argument("--max_w", type=int, default=1536)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--tmp", type=float, nargs=4, default=[5.0, 5.0, 5.0, 1.0])
    p.add_argument("--conf_choose", default="mean", choices=["mean", "stage4"])
    p.add_argument("--filter_method", default="dpcd", choices=["dpcd", "pcd", "gipuma", "none"])
    p.add_argument("--disp_threshold", type=float, default=0.1,
                   help="gipuma: absolute depth agreement threshold")
    p.add_argument("--num_consistent", type=int, default=2,
                   help="gipuma: least consistent source views")
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--prob_threshold", type=float, default=0.5, help="gipuma: confidence filter")
    p.add_argument("--thres_view", type=int, default=4)
    p.add_argument("--thres_disp", type=float, default=1.0)
    p.add_argument("--dist_base", type=float, default=4.0)
    p.add_argument("--rel_diff_base", type=float, default=1300.0)
    p.add_argument("--fusion_view", type=int, default=10)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--schedule", default="static", choices=["static", "queue"],
                   help="static: stride scans by --rank/--world; queue: claim them from the "
                        "work queue under --outdir")
    p.add_argument("--reclaim_stale", type=float, default=0.0,
                   help="queue: take over claims with no heartbeat for this many seconds")
    p.add_argument("--window_check", default="auto", choices=["auto", "off"])
    p.add_argument("--gt_depth_path", default=None,
                   help="DTU ground-truth depth directory -> depth_metric.txt")
    p.add_argument("--skip_depth", action="store_true", help="fusion only")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _scans(args):
    with open(args.testlist) as f:
        return [ln.strip() for ln in f if ln.strip()][args.rank::args.world]


def _metric_file(args) -> str:
    if args.world > 1:
        return f"depth_metric.rank{args.rank}.txt"
    if args.schedule == "queue":
        return f"depth_metric.pid{os.getpid()}.txt"
    return "depth_metric.txt"


def _merge_depth_metrics(outdir: Path) -> None:
    """depth_metric.txt from every worker's depth_metric.*.txt, each mean
    weighted by its n_views (test.py's merge: the last worker to finish
    leaves the whole result)."""
    sums: dict = {}
    n_total = 0
    for part in sorted(outdir.glob("depth_metric.*.txt")):
        kv = dict(line.split(": ") for line in part.read_text().strip().splitlines())
        n = int(float(kv.pop("n_views", 1)))
        n_total += n
        for k, v in kv.items():
            sums[k] = sums.get(k, 0.0) + float(v) * n
    if not n_total:
        return
    with open(outdir / "depth_metric.txt", "w") as f:
        f.write(f"n_views: {n_total}\n")
        for k in sorted(sums):
            f.write(f"{k}: {sums[k] / n_total:.6f}\n")


def _load_weights(model, cfg, args) -> None:
    if args.ckpt_npz:
        n = load_npz(args.ckpt_npz, model)
        log.info("loaded %d converted reference tensors from %s", n, args.ckpt_npz)
    elif args.ckpt:
        if not Path(args.ckpt).is_dir():
            raise SystemExit(f"--ckpt {args.ckpt}: not a checkpoints directory")
        mgr = CheckpointManager(args.ckpt)
        epoch = mgr.best_epoch()
        model.load_state_dict(mgr.load(epoch)["state_dict"])
        log.info("loaded %s epoch %s", args.ckpt, "last" if epoch is None else epoch)
    else:
        log.warning("no --ckpt given: using RANDOM weights (smoke mode)")
        vit_path = cfg.get_path("arch.args.vit_path")
        if vit_path and not hasattr(model, "vit"):
            log.info("%s has no ViT: nothing loaded from %s", type(model).__name__, vit_path)
        elif vit_path and Path(vit_path).exists():
            n = load_vit(vit_path, model)
            log.info("loaded %d pretrained ViT tensors from %s", n, vit_path)


class _Staged:
    """One view's outputs on their way to the host: copies into pinned
    buffers queued behind its forward, and an event after them."""

    def __init__(self, depth: torch.Tensor, conf: torch.Tensor, sample: dict, start, end):
        self.sample, self.start, self.end = sample, start, end
        if depth.is_cuda:
            self.depth = torch.empty(depth.shape, dtype=torch.float32, pin_memory=True)
            self.conf = torch.empty(conf.shape, dtype=torch.float32, pin_memory=True)
            self.depth.copy_(depth, non_blocking=True)
            self.conf.copy_(conf, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        else:
            self.depth, self.conf, self.copied = depth.float(), conf.float(), None

    def wait(self):
        if self.copied is not None:
            self.copied.synchronize()
        return self.depth[0].numpy(), self.conf[0].numpy()


def save_depths(args, cfg, device: torch.device, stats: dict):
    """Depth inference over the scans; returns the scans done."""
    model = build_model(cfg, dtype=torch.bfloat16, device=device)
    _load_weights(model, cfg, args)
    tmp = tuple(args.tmp)
    metric_sums = []
    done = []
    enc_s = dec_s = wait_s = 0.0
    decodes = 0
    fwd_ms, map_s = [], []
    t_start = time.perf_counter()
    queue = None
    if args.schedule == "queue":
        with open(args.testlist) as f:
            queue = WorkQueue(args.outdir, [ln.strip() for ln in f if ln.strip()],
                              reclaim_stale_s=args.reclaim_stale or None)

    def writeback(staged: _Staged):
        nonlocal enc_s
        depth, conf = staged.wait()
        if staged.start is not None:
            fwd_ms.append(staged.start.elapsed_time(staged.end))
        sample = staged.sample
        dv = sample["depth_values"]
        scan, ref = sample["scan"], sample["ref_view"]
        out_dir = Path(args.outdir) / scan
        for sub in ("depth_est", "confidence", "cams", "images"):
            (out_dir / sub).mkdir(parents=True, exist_ok=True)
        save_pfm(out_dir / "depth_est" / f"{ref:0>8}.pfm", depth)
        np.save(out_dir / "confidence" / f"{ref:0>8}.npy",
                (np.clip(conf, 0, 1) * 255).astype(np.uint8))
        cam = sample["cams"]["stage4"][0]  # full-resolution K, E
        save_cam_file(out_dir / "cams" / f"{ref:0>8}_cam.txt", cam[1, :3, :3], cam[0],
                      float(dv[0]), float(dv[1] - dv[0]))
        t0 = time.perf_counter()
        write_jpeg(out_dir / "images" / f"{ref:0>8}.jpg", sample["ref_img"])
        enc_s += time.perf_counter() - t0
        if "gt_depth" in sample:
            gt = sample["gt_depth"]
            if gt.shape != depth.shape:
                gt = resize_nearest(gt, depth.shape[0], depth.shape[1])
            g = torch.from_numpy(np.ascontiguousarray(gt))[None]
            m = depth_metrics(torch.from_numpy(depth)[None], g, g > 0)
            metric_sums.append({k: float(v) for k, v in m.items()})
        map_s.append(time.perf_counter() - t_start)
        log.info("%s view %d done", scan, ref)
        if queue is not None:
            queue.heartbeat(scan)

    window_logged = False
    with torch.inference_mode():
        for scan in queue if queue is not None else _scans(args):
            ds = EvalDataset(args.testpath, [scan], nviews=args.num_view,
                             ndepths=args.numdepth, interval_scale={scan: args.interval_scale},
                             max_h=args.max_h, max_w=args.max_w, dataset_name=args.dataset,
                             gt_depth_path=args.gt_depth_path)
            pending = None
            it = iter(EvalLoader(ds, num_workers=2))
            while True:
                t0 = time.perf_counter()
                sample = next(it, None)
                wait_s += time.perf_counter() - t0
                if sample is None:
                    break
                if args.window_check != "off" and not window_logged:
                    window_logged = True
                    log.info("--window_check: nothing to check, the port's warp is exact "
                             "(no sampling windows)")
                imgs = torch.from_numpy(sample["imgs"])[None].to(device)
                cams = {k: torch.from_numpy(v)[None].to(device) for k, v in sample["cams"].items()}
                dv = torch.from_numpy(sample["depth_values"])[None].to(device)
                start = end = None
                if device.type == "cuda":
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    start.record()
                out = model(imgs, cams, dv, tmp=tmp)
                conf = (out["stage4"]["photometric_confidence"] if args.conf_choose == "stage4"
                        else out["photometric_confidence"])
                if end is not None:
                    end.record()
                # one-deep pipeline: queue this view's copies to the host, then
                # write back the previous view while this one computes
                staged = _Staged(out["refined_depth"], conf, sample, start, end)
                del out
                if pending is not None:
                    writeback(pending)
                pending = staged
            if pending is not None:
                writeback(pending)
            done.append(scan)
            if queue is not None:  # after every file of the scan is written
                queue.mark_done(scan)
            dec_s += ds.views.decode_s
            decodes += ds.views.decodes
    if metric_sums:
        avg = {k: float(np.mean([m[k] for m in metric_sums])) for k in metric_sums[0]}
        out_path = Path(args.outdir) / _metric_file(args)
        with open(out_path, "w") as f:
            f.write(f"n_views: {len(metric_sums)}\n")
            for k, v in sorted(avg.items()):
                f.write(f"{k}: {v:.6f}\n")
        log.info("depth metrics -> %s: %s", out_path, {k: round(v, 4) for k, v in avg.items()})
        if out_path.name != "depth_metric.txt":
            _merge_depth_metrics(Path(args.outdir))
    stats.update(maps=len(map_s), depth_s=time.perf_counter() - t_start, map_done_s=map_s,
                 forward_ms=fwd_ms, loader_wait_s=wait_s, encode_s=enc_s, decode_s=dec_s,
                 decodes=decodes)
    return done


def fuse_scan(args, scan: str, device: torch.device) -> int:
    """Fuse one scan's written depth maps into --outdir/<scan>.ply; returns
    the number of points."""
    scan_dir = Path(args.outdir) / scan
    pair = read_pair_file(Path(args.testpath) / scan / "pair.txt")

    @functools.lru_cache(maxsize=None)
    def load_view(vid):
        depth = read_pfm(scan_dir / "depth_est" / f"{vid:0>8}.pfm")[0].astype(np.float32)
        conf = np.load(scan_dir / "confidence" / f"{vid:0>8}.npy")
        if conf.dtype == np.uint8 or conf.max() > 1.5:
            # before the float cast: uint8 maps of only 0 and 1 still take the /255
            conf = conf.astype(np.float32) / 255.0
        K, E, _, _, _ = read_cam_file(scan_dir / "cams" / f"{vid:0>8}_cam.txt")
        return depth, conf.astype(np.float32), build_camera_stack(K, E)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    all_pts, all_cols = [], []
    used: dict = {}  # gipuma: pixels that already gave a point, as ref or as support
    for ref, srcs in pair:
        srcs = srcs[: args.fusion_view]
        if not srcs:
            continue
        try:
            ref_depth, ref_conf, ref_cam = load_view(ref)
            views = [load_view(s) for s in srcs]
        except FileNotFoundError:
            continue
        src_depths = dev(np.stack([v[0] for v in views]))
        src_confs = dev(np.stack([v[1] for v in views]))
        src_cams = dev(np.stack([v[2] for v in views]))
        ref_depth_t, ref_conf_t, ref_cam_t = dev(ref_depth), dev(ref_conf), dev(ref_cam)
        if args.filter_method == "gipuma":
            pts, mask, consistent, src_px = gipuma_fuse(
                ref_depth_t, ref_conf_t, src_depths, src_confs, ref_cam_t, src_cams,
                prob_threshold=args.prob_threshold, disp_threshold=args.disp_threshold,
                num_consistent=args.num_consistent)
            mask = mask.cpu().numpy()
            if ref in used:
                mask &= ~used[ref]
            used.setdefault(ref, np.zeros_like(mask))
            used[ref] |= mask
            consistent, src_px = consistent.cpu().numpy(), src_px.cpu().numpy()
            for j, s in enumerate(srcs):
                px = src_px[j][consistent[j] & mask]
                used.setdefault(s, np.zeros_like(mask))
                used[s][px[:, 1], px[:, 0]] = True
        elif args.filter_method == "dpcd":
            pts, mask = dpcd_fuse(ref_depth_t, ref_conf_t, src_depths, ref_cam_t, src_cams,
                                  conf_thresh=args.conf, dist_base=args.dist_base,
                                  rel_diff_base=args.rel_diff_base)
            mask = mask.cpu().numpy()
        else:
            pts, mask = pcd_fuse(ref_depth_t, ref_conf_t, src_depths, src_confs, ref_cam_t,
                                 src_cams, conf_thresh=args.conf,
                                 img_dist_thresh=args.thres_disp, depth_thresh=0.01,
                                 vthresh=args.thres_view)
            mask = mask.cpu().numpy()
        pts = pts.cpu().numpy()[mask]
        all_pts.append(pts)
        img_path = scan_dir / "images" / f"{ref:0>8}.jpg"
        if not img_path.exists():
            img_path = Path(args.testpath) / scan / "images" / f"{ref:0>8}.jpg"
        if img_path.exists():
            img = resize_linear(read_image(img_path), mask.shape[0], mask.shape[1])
            all_cols.append((img[mask] * 255).astype(np.uint8))
        else:
            all_cols.append(np.full((len(pts), 3), 128, np.uint8))
        log.info("%s ref %d: %d pts (%.1f%% kept)", scan, ref, len(pts), 100 * mask.mean())
    if not all_pts:
        return 0
    pts = np.concatenate(all_pts)
    out = Path(args.outdir) / f"{scan}.ply"
    write_ply(out, pts, np.concatenate(all_cols))
    log.info("wrote %s (%d points)", out, len(pts))
    return len(pts)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the command line `argv` (default: sys.argv[1:]); returns the
    run's timings: maps, depth_s, map_done_s (seconds from the start at
    each map's write-back), forward_ms (device ms per forward on the card),
    loader_wait_s, encode_s, decode_s and decodes, and per scan fusion_s
    and points."""
    p = parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the eval CLI runs on the card and CUDA is not available; pass "
                           "--device cpu to run the plain PyTorch path on the CPU")
    if args.device == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    cfg = load_config(args.config)
    stats: dict = {"fusion_s": {}, "points": {}}
    scans = _scans(args) if args.skip_depth else save_depths(args, cfg, device, stats)
    if args.filter_method != "none":
        for scan in scans:
            t0 = time.perf_counter()
            stats["points"][scan] = fuse_scan(args, scan, device)
            stats["fusion_s"][scan] = time.perf_counter() - t0
    return stats
