"""One optimizer step and one validation step (counterpart of
mvsformerplusplus_tpu/train/step.py's make_train_step, make_accum_train_step
and make_eval_step).

The model runs in train mode (batch-statistic BatchNorms whose running
statistics move in place, argmax depth for CE stages), the multi-stage loss
is backpropagated, the global gradient norm is taken before the optional
clip, and AdamW and its schedule step once. One code path serves both JAX
functions: train_step_accum runs the micro-batches one after another, each
backward adding loss / n_micro into the gradients, so one update applies
their mean; the BatchNorm running statistics carry from micro-batch to
micro-batch, as the JAX scan carries them. train_step is its one-micro-batch
case.

batch: {imgs [B, V, H, W, 3], cams {stageN: [B, V, 2, 4, 4]}, depth_values
[B, D], depth_gt {stageN: [B, h, w]}, mask {stageN: [B, h, w]}} as tensors
on the model's device. logs: loss, the per-stage losses, grad_norm and the
stage-4 depth (`depth_est`), as device tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..losses import multi_stage_loss
from .metrics import depth_metrics
from .optim import clip_by_global_norm, global_norm

Tensor = torch.Tensor


def _loss(model, batch, depth_types, dlossw, inverse_depth, clip_func):
    outputs = model(batch["imgs"], batch["cams"], batch["depth_values"])
    dv = batch["depth_values"]
    total, loss_dict = multi_stage_loss(
        outputs, batch["depth_gt"], batch["mask"], dv[:, 1] - dv[:, 0],
        depth_types=depth_types, dlossw=dlossw, inverse_depth=inverse_depth,
        clip_func=clip_func)
    return total, loss_dict, outputs["refined_depth"].detach()


def _update(optimizer, scheduler, grad_clip) -> Tensor:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    norm = global_norm(params)
    if grad_clip is not None:
        clip_by_global_norm(params, grad_clip, norm)
    optimizer.step()
    scheduler.step()
    return norm


def train_step(model, optimizer, scheduler, batch: dict, **kwargs) -> Dict[str, Tensor]:
    """One forward, backward and AdamW update on `batch`: train_step_accum
    with one micro-batch."""
    return train_step_accum(model, optimizer, scheduler, [batch], **kwargs)


def train_step_accum(model, optimizer, scheduler, micro_batches: Sequence[dict],
                     depth_types: Sequence[str] = ("ce", "ce", "ce", "ce"),
                     dlossw: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                     inverse_depth: bool = True, clip_func: Optional[str] = "dynamic",
                     grad_clip: Optional[float] = None) -> Dict[str, Tensor]:
    """One AdamW update on the mean gradient of `micro_batches`; the logged
    losses are their means and depth_est is the last micro-batch's."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    n = len(micro_batches)
    sums: Dict[str, Tensor] = {}
    for mb in micro_batches:
        total, loss_dict, depth = _loss(model, mb, depth_types, dlossw, inverse_depth,
                                        clip_func)
        (total / n).backward()
        for k, v in {"loss": total, **loss_dict}.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    norm = _update(optimizer, scheduler, grad_clip)
    return {**{k: v / n for k, v in sums.items()}, "grad_norm": norm, "depth_est": depth}


def eval_step(model, batch: dict, tmp: Sequence[float] = (5.0, 5.0, 5.0, 1.0),
              thresholds: Sequence[float] = (2.0, 4.0, 8.0, 14.0, 20.0),
              interval_norm: str = "dtu") -> Dict[str, Tensor]:
    """Validation metrics of one batch (make_eval_step of the JAX package):
    the eval-mode forward at temperatures `tmp`, its refined depth against
    the last stage's ground truth where mask > 0.5, the nominal thresholds
    scaled per sample by the depth interval di ('dtu': di / 2.65, 'blended':
    di). Also returns the depth and the confidence. The model is in eval mode
    during the call and back in its mode after."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            out = model(batch["imgs"], batch["cams"], batch["depth_values"], tmp=tuple(tmp))
    finally:
        model.train(was_training)
    key = f"stage{len(tmp)}"
    dv = batch["depth_values"]
    di = (dv[:, 1] - dv[:, 0]).float()
    scale = di if interval_norm == "blended" else di / 2.65
    depth = out["refined_depth"].float()
    m = depth_metrics(depth, batch["depth_gt"][key], batch["mask"][key] > 0.5, thresholds,
                      scale=scale)
    m["depth"] = depth
    m["confidence"] = out["photometric_confidence"]
    return m
