"""The training loop (counterpart of the epoch loop of
mvsformerplusplus_tpu/train/trainer.py, on one device).

Each loader step gives (batch, crop_hw). The crop height selects a
micro-batch size from `scale_batch_map` (the reference's per-scale memory
knob): a batch larger than it is split into equal micro-batches whose mean
gradient makes one update (train_step_accum; one micro-batch when the
batch fits). Every `logging_every` steps the loss, the per-stage losses and
the gradient norm are logged, and `train` returns those entries.

The loader interface is the JAX package's TrainLoader: `epoch(e)` yields
(batch dict of numpy arrays, crop_hw) and `steps_per_epoch()`. Checkpoints,
validation, preemption handling, image panels and multi-host runs are not
ported yet.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .step import train_step_accum

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


class Trainer:
    def __init__(self, model, train_loader, optimizer, scheduler, *,
                 loss_kwargs: Optional[dict] = None,
                 scale_batch_map: Optional[Dict[str, int]] = None,
                 logging_every: int = 100, grad_clip: Optional[float] = None):
        self.model = model
        self.train_loader = train_loader
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_kwargs = dict(loss_kwargs or {})
        self.scale_batch_map = scale_batch_map or {}
        self.logging_every = logging_every
        self.grad_clip = grad_clip
        self.device = next(model.parameters()).device
        self.global_step = 0

    def _micro_count(self, crop_hw, batch_size: int) -> int:
        """Micro-batches per step: batch_size // micro for the largest
        micro <= scale_batch_map[crop height] that divides the batch, or 1."""
        micro = self.scale_batch_map.get(str(crop_hw[0]))
        if not micro or micro >= batch_size:
            return 1
        while batch_size % micro:
            micro -= 1
        return batch_size // micro

    def train(self, epochs: int, max_steps: Optional[int] = None) -> List[dict]:
        """Run `epochs` epochs, or stop after `max_steps` steps of this call.
        Returns the logged entries of this call."""
        logged, steps = [], 0
        for epoch in range(epochs):
            t0, n_steps = time.perf_counter(), 0
            for i, (batch, crop_hw) in enumerate(self.train_loader.epoch(epoch)):
                if max_steps is not None and steps >= max_steps:
                    return logged
                batch = to_device(batch, self.device)
                n_micro = self._micro_count(crop_hw, batch["imgs"].shape[0])
                logs = train_step_accum(self.model, self.optimizer, self.scheduler,
                                        split_micro(batch, n_micro), grad_clip=self.grad_clip,
                                        **self.loss_kwargs)
                steps += 1
                n_steps += 1
                self.global_step += 1
                if i % self.logging_every == 0:
                    entry = {"epoch": epoch, "step": self.global_step, "crop": list(crop_hw),
                             "micro": n_micro,
                             **{k: float(v) for k, v in logs.items()
                                if k == "loss" or k == "grad_norm" or k.startswith("stage")}}
                    log.info("epoch %d step %d crop %s micro %d loss %.4f gnorm %.3f %s",
                             epoch, i, crop_hw, n_micro, entry["loss"], entry["grad_norm"],
                             {k: round(v, 3) for k, v in entry.items() if k.startswith("stage")})
                    logged.append(entry)
            dt = time.perf_counter() - t0
            log.info("epoch %d done: %d steps in %.1fs", epoch, n_steps, dt)
        return logged
