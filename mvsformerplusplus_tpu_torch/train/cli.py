"""The training command line (counterpart of the repo's train.py):

    python -m mvsformerplusplus_tpu_torch.train -c configs/mvsformerplusplus.json \\
        [-r] [--finetune] [--dtu_model_path DIR] [--data_path DIR] [--save_dir DIR] \\
        [--epochs N] [--batch_size N] [-o 'a;b;c=value' ...] [--device cuda|cpu] \\
        [--mesh N_DATA,N_CV] [--distributed --coordinator HOST:PORT \\
         --num_processes P --process_id I]

It reads a reference-format JSON config, trains build_model(train=True)
(the flagship, or CasMVSNet for model_type "casmvs") on the config's data
loaders, DTULoader or BlendedLoader entries (several entries train
balanced), validates each epoch on data_loader[0].args.val_data_list when
that file exists (with the dataset class of the first entry; BlendedMVS
metrics on the "blended" interval scale), and checkpoints under --save_dir
(or trainer.save_dir)/checkpoints, with scalars.jsonl and, unless
trainer.log_images is false, the depth panels in images/ beside them.
-r resumes the last checkpoint there; --finetune starts from the best
checkpoint of --dtu_model_path (or arch.dtu_model_path: a checkpoints
directory or one .pth), with a fresh optimizer and schedule when
arch.reset_sche is true (the default) and the checkpoint's otherwise. The
frozen ViT loads arch.args.vit_path when it exists, by suffix as the JAX
CLI's load_vit_tree: the converted flax .npz, or else the original DINOv2
torch .pth (convert.load_vit); otherwise a warning says the ViT is random
(a model without a ViT loads nothing). --debug adds each top-level
module's gradient norm and non-finite count to every logged step.
trainer.tensorboard mirrors the scalars and panels into a TensorBoard
event file under <save_dir>/tb (utils/tfevents.py).

It runs on the card; --device cpu runs the plain PyTorch path on the CPU.

Across devices it takes the JAX CLI's flags with their meaning. --mesh
n_data,n_cv lays n_data * n_cv ranks out as parallel.dist does: the batch
over the data ranks (global BatchNorm moments, loss and gradient), the
cost volume's source views over the cv ranks (StageNet shard_views,
whenever n_cv > 1). Without --mesh every local card trains data-parallel,
clamped to the largest divisor of the global batch (with the JAX CLI's
warning). The config's batch_size is per process, as in the JAX CLI: each
data rank of a process loads its part of the process's batch. --distributed
runs one process per host, rendezvousing at --coordinator with
--num_processes and --process_id (or JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID); rank = process_id * local ranks +
local rank. A process starts its ranks with torch.multiprocessing (spawn)
after building the kernels once; a rank takes
cuda:{local rank % card count} (ranks that share a card talk over gloo,
ranks with a card each over NCCL) or the CPU with --device cpu. A layout
that cannot split the batch or the source views exits with a message.
"""
from __future__ import annotations

import argparse
import hashlib
import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..config import build_model, load_config, parse_override
from ..convert import load_vit
from ..data.loader import BalancedSchedule, ConcatDataset, TrainLoader
from ..data.mvs_dataset import BlendedTrainDataset, DTUTrainDataset, MultiScaleArgs
from ..parallel.dist import Layout, launch, make_layout
from .checkpoints import CheckpointManager, load_into
from .optim import make_optimizer, scale_vit_grads_by_layer
from .trainer import Trainer

log = logging.getLogger("mvsformerplusplus_tpu_torch")

DATASETS = {"DTULoader": DTUTrainDataset, "BlendedLoader": BlendedTrainDataset}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m mvsformerplusplus_tpu_torch.train",
                                description="Train the flagship or CasMVSNet on DTU or "
                                            "BlendedMVS data on one card or across ranks.")
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
    p.add_argument("--mesh", default=None,
                   help="data,cv layout sizes, e.g. 2,1 (default: every local card "
                        "data-parallel)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per host, rendezvousing at --coordinator")
    p.add_argument("--coordinator", default=None,
                   help="host:port where process 0 listens (also JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--debug", action="store_true",
                   help="log each top-level module's gradient norm and non-finite count at "
                        "every logged step (scalars.jsonl 'debug'); the JAX CLI's warp-window "
                        "check has no counterpart: the port's warp is exact")
    return p


@dataclass
class Plan:
    """The run's layout: n_data x n_cv ranks over num_processes processes,
    local_ranks of them in this one, data_per_process data ranks each."""
    n_data: int = 1
    n_cv: int = 1
    num_processes: int = 1
    process_id: int = 0
    coordinator: Optional[str] = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_cv

    @property
    def local_ranks(self) -> int:
        return self.world // self.num_processes

    @property
    def data_per_process(self) -> int:
        return self.local_ranks // self.n_cv


def _plan(p: argparse.ArgumentParser, args, cfg) -> Plan:
    """The layout the JAX CLI would take (train.py's --distributed and
    --mesh handling), with its checks as command-line errors."""
    plan = Plan()
    if args.distributed:
        coord = args.coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
        nproc = args.num_processes or os.environ.get("JAX_NUM_PROCESSES")
        pid = args.process_id if args.process_id is not None else os.environ.get(
            "JAX_PROCESS_ID")
        if not (coord and nproc is not None and pid is not None):
            p.error("--distributed needs --coordinator, --num_processes and --process_id (or "
                    "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID)")
        plan.num_processes, plan.process_id, plan.coordinator = int(nproc), int(pid), coord
    dl_cfg = cfg["data_loader"][0]["args"]
    batch = dl_cfg.get("batch_size", 4)  # per process, as the JAX loader's
    if args.mesh:
        try:
            plan.n_data, plan.n_cv = (int(x) for x in args.mesh.split(","))
        except ValueError:
            p.error(f"--mesh {args.mesh}: give the two sizes n_data,n_cv")
    else:
        local = torch.cuda.device_count() if args.device == "cuda" else 1
        n_dev = max(1, local) * plan.num_processes
        global_batch = batch * plan.num_processes
        plan.n_data = max(d for d in range(1, n_dev + 1)
                          if global_batch % d == 0 and n_dev % d == 0)
        if plan.n_data < n_dev:
            log.warning("global batch %d not divisible by %d devices: using %d-way data "
                        "parallelism (pass --mesh to override)", global_batch, n_dev,
                        plan.n_data)
    mesh = f"--mesh {plan.n_data},{plan.n_cv}"
    if min(plan.n_data, plan.n_cv) < 1 or plan.world % plan.num_processes:
        p.error(f"{mesh}: {plan.world} ranks cannot split over {plan.num_processes} processes")
    if plan.local_ranks % plan.n_cv:
        p.error(f"{mesh}: the {plan.local_ranks} ranks of a process do not hold whole cv "
                f"groups of {plan.n_cv}")
    if batch % plan.data_per_process:
        p.error(f"{mesh}: the batch of {batch} per process does not split over "
                f"{plan.data_per_process} data ranks")
    nsrc = dl_cfg.get("nviews", 5) - 1
    if nsrc % plan.n_cv:
        p.error(f"{mesh}: {nsrc} source views do not split over {plan.n_cv} cv ranks")
    return plan


def _dataset_class(entry: dict):
    if entry.get("type") not in DATASETS:
        raise SystemExit(f"data_loader type {entry.get('type')!r}: not one of {sorted(DATASETS)}")
    return DATASETS[entry["type"]]


def _train_dataset(entry: dict, msa: MultiScaleArgs, datapath: Optional[str]):
    a = entry["args"]
    return _dataset_class(entry)(
        datapath or a["datapath"], a["train_data_list"], mode="train",
        nviews=a.get("nviews", 5), ndepths=a.get("num_depths", 192),
        interval_scale=a.get("interval_scale", 1.06), random_crop=a.get("random_crop", True),
        augment=a.get("augment", True), aug_args=a.get("aug_args"),
        resize_range=msa.resize_range)


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


def load_pretrained_vit(model, vit_path) -> int:
    """arch.args.vit_path into the model's ViT, the converted .npz or the
    torch .pth by suffix (convert.load_vit): a model without a ViT loads
    nothing, a missing file leaves the ViT random (with a warning). Returns
    the number of tensors loaded."""
    if not hasattr(model, "vit"):
        log.info("%s has no ViT: nothing loaded from %s", type(model).__name__, vit_path)
        return 0
    if not Path(vit_path).exists():
        log.warning("!!!No weight in %s: the frozen ViT is RANDOM; only smoke runs should "
                    "proceed", vit_path)
        return 0
    n = load_vit(vit_path, model)
    log.info("loaded %d pretrained ViT tensors from %s", n, vit_path)
    return n


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line `argv` (default: sys.argv[1:]). With one rank it
    trains in this process and returns the Trainer, whose epoch_stats and
    val_stats hold the run's timings; with several, it starts this
    process's ranks and returns their summaries in rank order (`_rank`)."""
    p = parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = load_config(args.config, dict(parse_override(o) for o in args.override))
    if args.epochs:
        cfg.set_path("trainer.epochs", args.epochs)
    if args.batch_size:
        cfg.set_path("data_loader.0.args.batch_size", args.batch_size)
    plan = _plan(p, args, cfg)
    if plan.world == 1:
        return _train(args, cfg, plan, Layout(), torch.device(args.device))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the training CLI runs on the card and CUDA is not available; pass "
                           "--device cpu to run the plain PyTorch path on the CPU")
    return launch(_rank, plan.local_ranks, (args, cfg, plan), device=args.device,
                  num_processes=plan.num_processes, process_id=plan.process_id,
                  coordinator=plan.coordinator,
                  threads=max(1, torch.get_num_threads() // plan.local_ranks))


def _rank(ctx, args, cfg, plan: Plan) -> dict:
    """One rank of a run: its summary (rank, the logged entries,
    epoch_stats, val_stats, the step count, a SHA-1 of its final model
    state and its kernel launches)."""
    from ..ops.cuda import launch_counts

    logging.basicConfig(level=logging.INFO if ctx.rank == 0 else logging.WARNING,
                        format=f"%(asctime)s rank{ctx.rank} %(levelname)s %(message)s")
    layout = make_layout(plan.n_data, plan.n_cv, plan.data_per_process)
    t = _train(args, cfg, plan, layout, ctx.device)
    digest = hashlib.sha1()
    for v in t.model.state_dict().values():
        digest.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy())
    return {"rank": ctx.rank, "logged": t.logged, "epoch_stats": t.epoch_stats,
            "val_stats": t.val_stats, "global_step": t.global_step,
            "state_sha1": digest.hexdigest(), "launches": launch_counts()}


def _train(args, cfg, plan: Plan, layout: Layout, device: torch.device) -> Trainer:
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
    part = (layout.local_data_index, layout.data_per_process)
    loader = TrainLoader(train_ds, batch_size=dl_cfg.get("batch_size", 4), scales=msa.scales,
                         scale_batch_map=msa.scale_batch_map, rank=plan.process_id,
                         world=plan.num_processes, num_workers=dl_cfg.get("num_workers", 4),
                         order_fn=order_fn, shard=part)
    if loader.steps_per_epoch() < 1:
        raise SystemExit(f"the training data gives no batch of "
                         f"{loader.batch_size * plan.num_processes} samples")
    val_loader = None
    val_list = dl_cfg.get("val_data_list")
    first = cfg["data_loader"][0]
    if val_list and Path(val_list).exists():
        val_ds = _dataset_class(first)(datapath, val_list, mode="val",
                                       nviews=dl_cfg.get("nviews", 5),
                                       ndepths=dl_cfg.get("num_depths", 192),
                                       interval_scale=dl_cfg.get("interval_scale", 1.06))
        val_loader = TrainLoader(val_ds, batch_size=1, num_workers=2,
                                 scales=[(dl_cfg.get("height", 1152), dl_cfg.get("width", 1536))],
                                 rank=plan.process_id, world=plan.num_processes, stride=part)

    dtype = torch.bfloat16 if cfg.get_path("arch.bf16", True) else torch.float32
    model = build_model(cfg, dtype=dtype, device=device, train=True,
                        shard_views=layout.n_cv > 1)
    layout.attach(model)
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
        # BlendedMVS scenes have no metric scale: thresholds follow the
        # per-sample depth interval there; DTU's are in mm
        interval_norm="blended" if first["type"] == "BlendedLoader" else "dtu",
        log_images=tcfg.get("log_images", True), debug=args.debug, layout=layout,
        tensorboard=tcfg.get("tensorboard", False))
    if args.debug:
        log.info("--debug: per-module gradient norms at every logged step; no warp-window "
                 "check, the port's warp is exact (no sampling windows)")
    if tcfg.get("tensorboard", False):
        log.info("trainer.tensorboard: the scalars and panels are mirrored to %s",
                 Path(trainer.writer.path).parent / "tb")

    vit_path = cfg.get_path("arch.args.vit_path")
    if vit_path and not (args.resume or args.finetune):
        load_pretrained_vit(model, vit_path)
    start_epoch = 0
    if args.finetune:
        _finetune_source(cfg, args, trainer)
    elif args.resume:
        start_epoch = trainer.resume()
    trainer.train(epochs, start_epoch=start_epoch)
    return trainer
