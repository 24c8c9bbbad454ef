"""The training loop (counterpart of mvsformerplusplus_tpu/train/trainer.py).

Each loader step gives (batch, crop_hw). The crop height selects a
micro-batch size from `scale_batch_map` (a batch larger than it is split
into equal micro-batches whose mean gradient makes one update,
train_step_accum) and a remat granularity from `remat_map` (crop-height
classes whose steps checkpoint whole StageNets or only their regularizers).
Every `logging_every` steps the loss, the per-stage losses, the gradient
norm and the learning rate are logged (with `debug`, also each top-level
module's gradient norm and non-finite count); `train` returns those
entries.

With a validation loader, each epoch ends with `validate` (metric means over
the validation batches, eval_step with its thresholds scaled by
`interval_norm`); `monitor` ("min mean_error") picks the
best epoch and drives the early stop. With a `save_dir`, each epoch is
checkpointed (train/checkpoints.py), and the scalars go to
save_dir/scalars.jsonl as the JAX Trainer writes them (utils/logging.py):
each logged step's loss, gradient norm and per-stage losses ("train"), each
validation's metrics ("val") and, with `debug`, each logged step's
per-module gradient norms ("debug"; train_step's debug_logs, with a warning
naming the modules that have non-finite gradients); with `log_images`,
the depth panels of sample 0 of each logged step's (last micro-)batch and
of the first validation batch go to save_dir/images/ (a panel that fails
is logged and never stops the run). `resume` continues from the last one,
running an interrupted epoch again. SIGTERM and SIGINT during `train` set a
flag: the step in flight finishes, an interrupted=True checkpoint is saved
and `train` returns.

Each epoch's steps are summarised per crop bucket in `epoch_stats` (and the
log): steps, the host's wait on the loader, the host's time per step and,
on the card, the device time per step between CUDA events recorded around
each step; `val_stats` holds each validation's metrics and its device (or host) ms per map.

The loader interface is the JAX package's TrainLoader: `epoch(e)` yields
(batch dict of numpy arrays, crop_hw) and `steps_per_epoch()`.

Across ranks (`layout`, parallel.dist.Layout; one Trainer per rank, each
fed its part of every host batch by its loader): `train` first gives every
rank rank 0's weights; each step's losses and gradients are the global
batch's (train/step.py); the micro-batch count is the JAX Trainer's for the
host batch, clamped to the process's data shards. Validation follows the
JAX Trainer's: each data index runs its own validation batches (the cv
ranks of one data index the same ones, since view sharding reduces across
them), with no collective across data indices until the end, where one
all-reduce of every rank's (metric sums, batch count) gives the global
means; every rank must have run at least one batch. Only rank 0 writes
checkpoints, scalars and panels, and every rank waits for its checkpoint
before going on; every rank restores from it on resume. Each rank reads its
own preemption flag, as each JAX process does.
"""
from __future__ import annotations

import logging
import math
import signal
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.loader import micro_count
from ..parallel.dist import Layout
from ..utils.logging import ImageWriter, ScalarWriter
from .checkpoints import CheckpointManager
from .step import eval_step, train_step_accum

log = logging.getLogger("mvsformerplusplus_tpu_torch")


def to_device(batch, device):
    """Numpy arrays or tensors (nested in dicts) -> f32 tensors on `device`;
    strings and lists (file names, scan ids) are dropped."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()
                if not isinstance(v, (str, list))}
    if isinstance(batch, torch.Tensor):
        return batch.to(device, torch.float32)
    return torch.as_tensor(np.asarray(batch, dtype=np.float32)).to(device)


def split_micro(batch, n_micro: int) -> List[dict]:
    """A batch of tensors [B, ...] -> n_micro batches [B // n_micro, ...]."""
    def part(x, i):
        if isinstance(x, dict):
            return {k: part(v, i) for k, v in x.items()}
        m = x.shape[0] // n_micro
        return x[i * m:(i + 1) * m]

    return [part(batch, i) for i in range(n_micro)]


def _timed(iterable):
    """Yield (item, host time before asking for it, host time it came)."""
    it = iter(iterable)
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        yield item, t, time.perf_counter()


class _Clock:
    """Device time between marks on the card (CUDA events, read once at
    the end), host time elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Trainer:
    def __init__(self, model, train_loader, optimizer, scheduler, *, val_loader=None,
                 loss_kwargs: Optional[dict] = None,
                 scale_batch_map: Optional[Dict[str, int]] = None,
                 remat_map: Optional[Dict[str, str]] = None,
                 logging_every: int = 100, grad_clip: Optional[float] = None,
                 save_dir=None, config: Optional[dict] = None, monitor: str = "min mean_error",
                 early_stop: int = 10, interval_norm: str = "dtu", log_images: bool = True,
                 debug: bool = False, layout: Optional[Layout] = None):
        self.model = model
        self.layout = layout or Layout()
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_kwargs = dict(loss_kwargs or {})
        self.scale_batch_map = scale_batch_map or {}
        self.remat_map = remat_map or {}
        self.logging_every = logging_every
        self.grad_clip = grad_clip
        self.config = config
        self.monitor_mode, self.monitor_key = monitor.split()
        self.early_stop = early_stop
        self.interval_norm = interval_norm
        self.device = next(model.parameters()).device
        cascade = getattr(model, "cascade", None)
        self.remat_default = getattr(cascade, "remat_granularity", None)
        # without a save_dir the manager writes nothing and only tracks the best
        self.ckpt = CheckpointManager(None if save_dir is None else Path(save_dir) / "checkpoints",
                                      mode=self.monitor_mode)
        self.writer = None if save_dir is None else ScalarWriter(save_dir)
        self.images = ImageWriter(save_dir) if save_dir is not None and log_images else None
        self.debug = debug
        self.global_step = 0
        self.logged: List[dict] = []  # the entries the last `train` call logged
        self.epoch_stats: List[dict] = []
        self.val_stats: List[dict] = []
        self._preempted = False

    def _micro_count(self, crop_hw, batch_size: int) -> int:
        """Micro-batches per step of this rank's `batch_size` samples: the
        JAX Trainer's count for the host batch they are part of
        (data.loader.micro_count)."""
        ld = self.layout.data_per_process
        return micro_count(self.scale_batch_map, crop_hw, batch_size * ld, ld)

    def _set_remat(self, crop_h) -> None:
        gran = self.remat_map.get(str(crop_h), self.remat_default)
        cascade = getattr(self.model, "cascade", None)
        if gran is not None and cascade.remat_granularity != gran:
            cascade.set_remat_granularity(gran)

    def resume(self) -> int:
        """Restore the last checkpoint (model, optimizer, scheduler, step
        count); returns the epoch to start from: the interrupted epoch again,
        else the one after the checkpoint's. 0 when there is none."""
        if self.ckpt.latest_epoch() is None:
            return 0
        epoch, step = self.ckpt.restore(self.model, self.optimizer, self.scheduler)
        self.global_step = step
        if self.ckpt.was_interrupted():
            log.info("resumed from the interrupt checkpoint of epoch %d (step %d)", epoch, step)
            return epoch
        log.info("resumed from epoch %d (step %d)", epoch, step)
        return epoch + 1

    def _install_preemption_handler(self):
        """SIGTERM and SIGINT set a flag the step loop reads. Returns the
        previous handlers (none off the main thread, where signals cannot be
        caught)."""
        if threading.current_thread() is not threading.main_thread():
            return {}

        def flag(signum, frame):
            log.warning("signal %d: checkpointing at the next step boundary", signum)
            self._preempted = True

        return {sig: signal.signal(sig, flag) for sig in (signal.SIGTERM, signal.SIGINT)}

    def _save(self, epoch, **kw) -> bool:
        """Rank 0 writes; every rank waits for it."""
        best = self.ckpt.save(epoch, self.model, self.optimizer, self.scheduler,
                              self.global_step, config=self.config, **kw)
        self.layout.world.barrier()
        return best

    def train(self, epochs: int, max_steps: Optional[int] = None,
              start_epoch: int = 0) -> List[dict]:
        """Run epochs start_epoch .. epochs - 1, or stop after `max_steps`
        steps of this call. Returns the logged entries of this call."""
        self.logged = logged = []
        steps, not_improved = 0, 0
        self._preempted = False
        previous = self._install_preemption_handler()
        clock = _Clock(self.device)
        self.layout.world.broadcast_(list(self.model.state_dict().values()))
        try:
            for epoch in range(start_epoch, epochs):
                t0, records = time.perf_counter(), []
                for i, ((batch, crop_hw), t_fetch, t_got) in enumerate(
                        _timed(self.train_loader.epoch(epoch))):
                    if max_steps is not None and steps >= max_steps:
                        return logged
                    batch = to_device(batch, self.device)
                    n_micro = self._micro_count(crop_hw, batch["imgs"].shape[0])
                    self._set_remat(crop_hw[0])
                    lr = self.optimizer.param_groups[0]["lr"]
                    before = clock.mark()
                    micro_batches = split_micro(batch, n_micro)
                    logs = train_step_accum(self.model, self.optimizer, self.scheduler,
                                            micro_batches, grad_clip=self.grad_clip,
                                            debug=self.debug, layout=self.layout,
                                            **self.loss_kwargs)
                    after = clock.mark()
                    steps += 1
                    self.global_step += 1
                    if i % self.logging_every == 0:
                        entry = {"epoch": epoch, "step": self.global_step, "crop": list(crop_hw),
                                 "micro": n_micro, "lr": lr,
                                 **{k: float(v) for k, v in logs.items()
                                    if k == "loss" or k == "grad_norm" or k.startswith("stage")
                                    or k.startswith(("gnorm/", "nonfinite/"))}}
                        log.info("epoch %d step %d crop %s micro %d lr %.3g loss %.4f "
                                 "gnorm %.3f %s", epoch, i, crop_hw, n_micro, lr, entry["loss"],
                                 entry["grad_norm"],
                                 {k: round(v, 3) for k, v in entry.items()
                                  if k.startswith("stage")})
                        logged.append(entry)
                        if self.writer is not None:
                            self.writer.write("train", {k: v for k, v in entry.items()
                                                        if k == "loss" or k == "grad_norm"
                                                        or k.startswith("stage")},
                                              self.global_step)
                        if self.debug:
                            self._report_debug(entry, epoch, i)
                        if self.images is not None and "depth_est" in logs:
                            self._write_panels("train", logs["depth_est"], micro_batches[-1],
                                               logs.get("conf_est"))
                    records.append((tuple(crop_hw), t_got - t_fetch,
                                    time.perf_counter() - t_fetch, before, after))
                    if self._preempted:
                        self._summarise(epoch, records, clock, time.perf_counter() - t0)
                        self._save(epoch, interrupted=True)
                        log.info("interrupt checkpoint saved at epoch %d step %d", epoch, i)
                        return logged
                self._summarise(epoch, records, clock, time.perf_counter() - t0)

                metrics = self.validate(epoch) if self.val_loader is not None else {}
                monitor = metrics.get(self.monitor_key, math.nan)
                is_best = self._save(epoch, monitor_value=None if math.isnan(monitor) else monitor)
                log.info("epoch %d done: best=%s", epoch, is_best)
                if not math.isnan(monitor):
                    not_improved = 0 if is_best else not_improved + 1
                    if not_improved >= self.early_stop:
                        log.info("early stop at epoch %d", epoch)
                        break
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        return logged

    def _report_debug(self, entry: dict, epoch: int, i: int) -> None:
        """Per-module gradient norms to the log and to scalars.jsonl
        ("debug"); a warning names the modules with non-finite gradients."""
        gnorms = {k.split("/", 1)[1]: v for k, v in entry.items() if k.startswith("gnorm/")}
        bad = {k.split("/", 1)[1]: int(v) for k, v in entry.items()
               if k.startswith("nonfinite/") and v > 0}
        log.info("debug epoch %d step %d per-module gnorm %s", epoch, i,
                 {k: round(v, 4) for k, v in gnorms.items()})
        if self.writer is not None:
            self.writer.write("debug", gnorms, self.global_step)
        if bad:
            log.warning("NON-FINITE gradients at epoch %d step %d: %s (module -> count)",
                        epoch, i, bad)

    def _write_panels(self, mode: str, depth, batch, conf=None) -> None:
        """The panel of sample 0: depth, the last stage's ground truth and
        mask where the batch has them, and the confidence where given."""
        try:
            key = f"stage{len(batch['depth_gt'])}" if "depth_gt" in batch else None

            def first(x):
                return None if x is None else x[0].float().cpu().numpy()

            self.images.write(mode, self.global_step, first(depth),
                              first(batch["depth_gt"][key]) if key else None, first(conf),
                              first(batch["mask"][key]) if key else None)
        except Exception as e:  # a panel must never stop a training run
            log.warning("%s panel write failed: %s", mode, e)

    def _summarise(self, epoch: int, records, clock: _Clock, wall_s: float) -> None:
        """Per crop bucket: steps, ms per step (device between the events
        around each step on the card; host elsewhere), the host's time per
        step and the share of it spent waiting on the loader."""
        clock.sync()
        buckets: Dict[tuple, dict] = {}
        for crop_hw, wait_s, host_s, before, after in records:
            b = buckets.setdefault(crop_hw, {"steps": 0, "ms": 0.0, "wait_s": 0.0, "host_s": 0.0})
            b["steps"] += 1
            b["ms"] += clock.ms(before, after)
            b["wait_s"] += wait_s
            b["host_s"] += host_s
        stats = {"epoch": epoch, "wall_s": wall_s, "device": "cuda" if clock.cuda else "host",
                 "buckets": {f"{h}x{w}": {"steps": b["steps"], "ms_per_step": b["ms"] / b["steps"],
                                          "host_ms_per_step": 1e3 * b["host_s"] / b["steps"],
                                          "loader_wait_share": b["wait_s"] / b["host_s"]}
                             for (h, w), b in buckets.items()}}
        self.epoch_stats.append(stats)
        log.info("epoch %d: %d steps in %.1f s %s", epoch, len(records), wall_s, stats["buckets"])

    def validate(self, epoch: int = -1) -> Dict[str, float]:
        """Means over the validation batches of eval_step's metrics (across
        ranks: over every data index's batches); they and this rank's time
        per map are appended to `val_stats`."""
        sums: Dict[str, float] = {}
        clock, times, n = _Clock(self.device), [], 0
        for batch, _ in self.val_loader.epoch(0):
            batch = to_device(batch, self.device)
            start = clock.mark()
            m = eval_step(self.model, batch, interval_norm=self.interval_norm)
            times.append((start, clock.mark(), batch["imgs"].shape[0]))
            if self.images is not None and n == 0:
                self._write_panels("val", m["depth"], batch, m["confidence"])
            for k, v in m.items():
                if k not in ("depth", "confidence"):
                    sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        clock.sync()
        maps = sum(b for _, _, b in times)
        ms = sum(clock.ms(a, b) for a, b, _ in times)
        total = n
        if self.layout.world.active:
            sums, total = self._merge(sums, n)
        metrics = {k: v / max(1, total) for k, v in sums.items()}
        self.val_stats.append({"epoch": epoch, "metrics": metrics, "batches": n, "maps": maps,
                               "ms_per_map": ms / max(maps, 1)})
        log.info("epoch %d val %s", epoch, {k: round(v, 4) for k, v in metrics.items()})
        if self.writer is not None:
            self.writer.write("val", metrics, self.global_step)
        return metrics

    def _merge(self, sums: Dict[str, float], n: int):
        """The (metric sums, batch count) of every data index: one all-reduce
        over the data group, the division left to the caller (a mean of the
        ranks' means would weigh a rank with fewer batches more)."""
        empty = self.layout.world.sum(torch.tensor([float(n == 0)], device=self.device))
        if empty.item():
            raise RuntimeError(
                "multi-rank validation requires >= 1 val batch per data index (the "
                "metric-key vector must agree across ranks for the all-reduce); give the "
                "val loader at least n_data samples per process")
        keys = sorted(sums)
        vec = self.layout.data.sum(torch.tensor([sums[k] for k in keys] + [float(n)],
                                                dtype=torch.float64, device=self.device))
        vec = vec.tolist()
        return dict(zip(keys, vec[:-1])), vec[-1]
