"""Checkpoints of a training run (counterpart of
mvsformerplusplus_tpu/train/checkpoints.py), written with torch.save.

A directory holds
- checkpoint-epoch{N}.pth, one per epoch, the newest `max_to_keep` kept;
- model_best.pth, the best epoch by the monitored value, outside that
  rotation; model_last.pth, the newest epoch;
- meta.json (last_epoch, best_epoch, monitor_best, mode, interrupted) and
  config.json (the run's config).
Each .pth holds {arch, epoch, step, state_dict, optimizer, scheduler,
monitor_best, config}: the reference's keys plus the scheduler and the
step count. A file is written under a temporary name and renamed into
place; model_best.pth and model_last.pth are hard links to the epoch's file
(copies where the file system has no links).
"""
from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from .optim import refresh_lr


def _link(src: Path, dst: Path) -> None:
    tmp = dst.with_suffix(".tmp")
    tmp.unlink(missing_ok=True)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3, mode: str = "min"):
        """directory=None tracks the best value and writes nothing."""
        if mode not in ("min", "max"):
            raise ValueError(f"mode is 'min' or 'max', got {mode!r}")
        self.directory = None if directory is None else Path(directory).absolute()
        if self.directory is not None:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mode = mode
        meta = self.meta()
        self.monitor_best = meta.get("monitor_best",
                                     float("inf") if mode == "min" else float("-inf"))
        self.best = meta.get("best_epoch")

    def epoch_path(self, epoch: int) -> Path:
        return self.directory / f"checkpoint-epoch{epoch}.pth"

    def meta(self) -> dict:
        if self.directory is None or not (self.directory / "meta.json").exists():
            return {}
        return json.loads((self.directory / "meta.json").read_text())

    def improved(self, value: Optional[float]) -> bool:
        """Whether the monitored `value` beats the best so far (per `mode`)."""
        if value is None or math.isnan(value):
            return False
        return value < self.monitor_best if self.mode == "min" else value > self.monitor_best

    def save(self, epoch: int, model, optimizer, scheduler, step: int,
             config: Optional[dict] = None, monitor_value: Optional[float] = None,
             interrupted: bool = False) -> bool:
        """Write epoch `epoch`'s checkpoint (replacing one of the same
        epoch, as an interrupted epoch's save is replaced by its re-run's)
        and model_last.pth; when `monitor_value` improves on the best, also
        model_best.pth. interrupted=True marks a save taken mid-epoch:
        resume runs that epoch again. Returns whether this epoch is the new
        best."""
        is_best = self.improved(monitor_value)
        if is_best:
            self.monitor_best, self.best = float(monitor_value), epoch
        if self.directory is None:
            return is_best
        payload = {"arch": type(model).__name__, "epoch": epoch, "step": step,
                   "state_dict": model.state_dict(), "optimizer": optimizer.state_dict(),
                   "scheduler": scheduler.state_dict(), "monitor_best": self.monitor_best,
                   "config": config}
        path = self.epoch_path(epoch)
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        _link(path, self.directory / "model_last.pth")
        if is_best:
            _link(path, self.directory / "model_best.pth")
        kept = sorted(self.epochs())
        for old in kept[:-self.max_to_keep] if self.max_to_keep else []:
            self.epoch_path(old).unlink()
        if config is not None:
            (self.directory / "config.json").write_text(json.dumps(config, indent=2))
        (self.directory / "meta.json").write_text(json.dumps(
            {"last_epoch": epoch, "best_epoch": self.best, "monitor_best": self.monitor_best,
             "mode": self.mode, "interrupted": interrupted}))
        return is_best

    def epochs(self):
        return [int(p.stem[len("checkpoint-epoch"):])
                for p in self.directory.glob("checkpoint-epoch*.pth")]

    def was_interrupted(self) -> bool:
        return bool(self.meta().get("interrupted", False))

    def latest_epoch(self) -> Optional[int]:
        return self.meta().get("last_epoch")

    def best_epoch(self) -> Optional[int]:
        return self.best

    def load(self, epoch: Optional[int] = None) -> dict:
        """The payload of `epoch` (default: the last), served from
        model_best.pth when the rotation removed it and it is the best."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.epoch_path(epoch)
        if not path.exists():
            if epoch == self.best and (self.directory / "model_best.pth").exists():
                path = self.directory / "model_best.pth"
            else:
                raise FileNotFoundError(f"epoch {epoch} not in {self.directory} (epochs "
                                        f"{sorted(self.epochs())}, best {self.best})")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, model, optimizer=None, scheduler=None, epoch: Optional[int] = None):
        """load_into of epoch `epoch` (default: the last). Returns (epoch,
        step)."""
        return load_into(self.load(epoch), model, optimizer, scheduler)


def load_into(payload: dict, model, optimizer=None, scheduler=None):
    """Load a checkpoint payload into the model and, when given, the
    optimizer's state (Adam moments, step counts) and the scheduler's step.
    The hyperparameters and the schedule stay the caller's, as the JAX
    package restores an optimizer state into the optimizer of the current
    config: the learning rates become the current schedule's at the restored
    step (a run resumed with more epochs continues the longer run's
    schedule). Returns (epoch, step)."""
    model.load_state_dict(payload["state_dict"])
    if optimizer is not None:
        hyper = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
        optimizer.load_state_dict(payload["optimizer"])
        for g, h in zip(optimizer.param_groups, hyper):
            g.update(h)
    if scheduler is not None:
        base = list(scheduler.base_lrs)
        scheduler.load_state_dict(payload["scheduler"])
        scheduler.base_lrs = base
        refresh_lr(scheduler)
    return payload["epoch"], payload["step"]
