"""The training command line (counterpart of the repo's train.py, for one
device):

    python -m mvsformerplusplus_tpu_torch.train -c configs/mvsformerplusplus.json \\
        [-r] [--finetune] [--dtu_model_path DIR] [--data_path DIR] [--save_dir DIR] \\
        [--epochs N] [--batch_size N] [-o 'a;b;c=value' ...] [--device cuda|cpu]

It reads a reference-format JSON config, trains build_model(train=True) on
the config's DTU-format data loaders (several entries train balanced),
validates each epoch on data_loader[0].args.val_data_list when that file
exists, and checkpoints under --save_dir (or trainer.save_dir)/checkpoints.
-r resumes the last checkpoint there; --finetune starts from the best
checkpoint of --dtu_model_path (or arch.dtu_model_path: a checkpoints
directory or one .pth), with a fresh optimizer and schedule when
arch.reset_sche is true (the default) and the checkpoint's otherwise. The
frozen ViT loads arch.args.vit_path (the converted flax .npz) when it
exists; otherwise a warning says the ViT is random.

It runs on the card; --device cpu runs the plain PyTorch path on the CPU.
What the JAX CLI does across devices (--mesh with more than one device,
--distributed, --coordinator, --num_processes, --process_id) and --debug
are not ported: each exits with an error naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..config import build_model, load_config, parse_override
from ..convert import load_vit_npz
from ..data.loader import BalancedSchedule, ConcatDataset, TrainLoader
from ..data.mvs_dataset import DTUTrainDataset, MultiScaleArgs
from .checkpoints import CheckpointManager, load_into
from .optim import make_optimizer, scale_vit_grads_by_layer
from .trainer import Trainer

log = logging.getLogger("mvsformerplusplus_tpu_torch")

MULTI_DEVICE = "is not ported: one device only (ROADMAP.md §1 item 9, the mesh and view sharding)"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mvsformerplusplus_tpu_torch.train",
                                description="Train the flagship on DTU-format data on one card.")
    p.add_argument("-c", "--config", required=True, help="JSON config path")
    p.add_argument("-r", "--resume", action="store_true",
                   help="continue from the last checkpoint under the save dir")
    p.add_argument("--finetune", action="store_true",
                   help="start from the best checkpoint of --dtu_model_path")
    p.add_argument("--dtu_model_path", default=None)
    p.add_argument("--data_path", default=None, help="replaces data_loader[0].args.datapath")
    p.add_argument("--save_dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("-o", "--override", action="append", default=[],
                   help="config override 'a;b;c=value' (the value as JSON where it parses)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag in ("--mesh", "--coordinator", "--num_processes", "--process_id"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    p.add_argument("--distributed", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--debug", action="store_true", help=argparse.SUPPRESS)
    return p


def _refuse_unported(p: argparse.ArgumentParser, args) -> None:
    if args.mesh is not None and [s.strip() for s in args.mesh.split(",")] not in (["1"],
                                                                                  ["1", "1"]):
        p.error(f"--mesh {args.mesh} {MULTI_DEVICE}")
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            p.error(f"--{flag} {MULTI_DEVICE}")
    if args.distributed:
        p.error(f"--distributed {MULTI_DEVICE}")
    if args.debug:
        p.error("--debug (per-module gradient norms, warp-window checks) is not ported "
                "(ROADMAP.md §1 item 8)")


def _train_dataset(entry: dict, msa: MultiScaleArgs, datapath: Optional[str]):
    if entry.get("type") != "DTULoader":
        raise SystemExit(f"data_loader type {entry.get('type')!r} is not ported: DTU-format "
                         "data only (BlendedMVS needs a JPEG decoder, ROADMAP.md §1 item 8)")
    a = entry["args"]
    return DTUTrainDataset(datapath or a["datapath"], a["train_data_list"], mode="train",
                           nviews=a.get("nviews", 5), ndepths=a.get("num_depths", 192),
                           interval_scale=a.get("interval_scale", 1.06),
                           random_crop=a.get("random_crop", True), augment=a.get("augment", True),
                           aug_args=a.get("aug_args"), resize_range=msa.resize_range)


def _finetune_source(cfg, args, trainer: Trainer) -> None:
    """Load the best checkpoint of the DTU run (a checkpoints directory or
    a .pth file): the weights, and with arch.reset_sche false also the
    optimizer's state and the schedule's step."""
    src = Path(args.dtu_model_path or cfg.get_path("arch.dtu_model_path") or "")
    if not str(src) or not src.exists():
        raise SystemExit(f"--finetune: no checkpoint at {str(src)!r} (give --dtu_model_path)")
    if src.is_file():
        payload = torch.load(src, map_location="cpu", weights_only=True)
    else:
        mgr = CheckpointManager(src)
        payload = mgr.load(mgr.best_epoch())  # the last epoch where none was best
    fresh = cfg.get_path("arch.reset_sche", True)
    opt, sched = (None, None) if fresh else (trainer.optimizer, trainer.scheduler)
    epoch, step = load_into(payload, trainer.model, opt, sched)
    if fresh:
        log.info("finetuning from %s (epoch %s), fresh schedule", src, epoch)
    else:
        log.info("finetuning from %s (epoch %s), schedule continued at step %s", src, epoch, step)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    """Run the command line `argv` (default: sys.argv[1:]); returns the
    Trainer, whose epoch_stats and val_stats hold the run's timings."""
    p = parser()
    args = p.parse_args(argv)
    _refuse_unported(p, args)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    cfg = load_config(args.config, dict(parse_override(o) for o in args.override))
    if args.epochs:
        cfg.set_path("trainer.epochs", args.epochs)
    if args.batch_size:
        cfg.set_path("data_loader.0.args.batch_size", args.batch_size)
    tcfg = cfg["trainer"]
    dl_cfg = cfg["data_loader"][0]["args"]
    datapath = args.data_path or dl_cfg["datapath"]
    ms = dl_cfg.get("multi_scale_args", {})
    msa = MultiScaleArgs(scales=tuple(map(tuple, ms.get("scales", MultiScaleArgs.scales))),
                         resize_range=tuple(ms.get("resize_range", (1.0, 1.2))),
                         scale_batch_map=ms.get("scale_batch_map", {}))

    order_fn = None
    if len(cfg["data_loader"]) > 1:
        children = [_train_dataset(e, msa, None) for e in cfg["data_loader"]]
        train_ds = ConcatDataset(children)
        order_fn = BalancedSchedule([len(c) for c in children]).epoch
    else:
        train_ds = _train_dataset(cfg["data_loader"][0], msa, args.data_path)
    loader = TrainLoader(train_ds, batch_size=dl_cfg.get("batch_size", 4), scales=msa.scales,
                         num_workers=dl_cfg.get("num_workers", 4), order_fn=order_fn)
    if loader.steps_per_epoch() < 1:
        raise SystemExit(f"the training data gives no batch of {loader.batch_size} samples")
    val_loader = None
    val_list = dl_cfg.get("val_data_list")
    if val_list and Path(val_list).exists():
        val_ds = DTUTrainDataset(datapath, val_list, mode="val", nviews=dl_cfg.get("nviews", 5),
                                 ndepths=dl_cfg.get("num_depths", 192),
                                 interval_scale=dl_cfg.get("interval_scale", 1.06))
        val_loader = TrainLoader(val_ds, batch_size=1, num_workers=2,
                                 scales=[(dl_cfg.get("height", 1152), dl_cfg.get("width", 1536))])

    dtype = torch.bfloat16 if cfg.get_path("arch.bf16", True) else torch.float32
    model = build_model(cfg, dtype=dtype, device=args.device, train=True)
    opt_cfg = cfg["optimizer"]["args"]
    epochs = tcfg["epochs"]
    optimizer, scheduler = make_optimizer(
        model, lr=opt_cfg.get("lr", 1e-3), vit_lr=opt_cfg.get("vit_lr", 3e-5),
        weight_decay=opt_cfg.get("weight_decay", 0.01), min_lr_frac=opt_cfg.get("min_lr", 0.01),
        warmup_steps=opt_cfg.get("warmup_steps", 500),
        total_steps=epochs * loader.steps_per_epoch(),
        freeze_vit=cfg.get_path("arch.args.freeze_vit", True))
    layer_decay = opt_cfg.get("layer_decay")
    if layer_decay and layer_decay < 1.0:
        scale_vit_grads_by_layer(model, layer_decay, depth=cfg.get_path("arch.args.vit_depth", 12))
    loss_cfg = cfg.get_path("arch.loss", {}) or {}
    trainer = Trainer(
        model, loader, optimizer, scheduler, val_loader=val_loader,
        loss_kwargs=dict(depth_types=tuple(cfg.get_path("arch.args.depth_type", ("ce",) * 4)),
                         dlossw=tuple(loss_cfg.get("dlossw", (1.0,) * 4)),
                         inverse_depth=cfg.get_path("arch.args.inverse_depth", True),
                         clip_func=loss_cfg.get("clip_func", "dynamic")),
        scale_batch_map=msa.scale_batch_map, remat_map=tcfg.get("remat_map", {}),
        logging_every=tcfg.get("logging_every", 100), grad_clip=tcfg.get("grad_norm"),
        save_dir=args.save_dir or tcfg.get("save_dir", "saved"), config=dict(cfg),
        monitor=tcfg.get("monitor", "min mean_error"), early_stop=tcfg.get("early_stop", 10),
        # BlendedMVS scenes have no metric scale (the JAX CLI picks "blended"
        # for them); the DTU-format loaders this CLI takes are in mm
        interval_norm="dtu")
    if tcfg.get("log_images", True) or tcfg.get("tensorboard", False):
        log.info("image panels and TensorBoard are not ported (ROADMAP.md §1 item 8): "
                 "scalars go to this log only")

    vit_path = cfg.get_path("arch.args.vit_path")
    if vit_path and not (args.resume or args.finetune):
        if not Path(vit_path).exists():
            log.warning("!!!No weight in %s: the frozen ViT is RANDOM; only smoke runs should "
                        "proceed", vit_path)
        elif not str(vit_path).endswith(".npz"):
            raise SystemExit(f"{vit_path}: the ViT loads from the converted flax .npz only "
                             "(tools/convert_dinov2.py writes it from the torch .pth)")
        else:
            n = load_vit_npz(vit_path, model)
            log.info("loaded %d pretrained ViT tensors from %s", n, vit_path)
    start_epoch = 0
    if args.finetune:
        _finetune_source(cfg, args, trainer)
    elif args.resume:
        start_epoch = trainer.resume()
    trainer.train(epochs, start_epoch=start_epoch)
    return trainer
