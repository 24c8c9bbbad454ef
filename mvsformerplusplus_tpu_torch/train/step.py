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
refined depth (`depth_est`; with one micro-batch also the confidence,
`conf_est`, as the JAX make_train_step logs them), as device tensors; with
`debug`, also each top-level module's gradient norm and count of non-finite
gradient entries (`gnorm/<module>`, `nonfinite/<module>`, debug_logs).

Across ranks (`layout`, parallel.dist.Layout): the losses divide by the
valid counts of the global batch (the data group's), and after the
backward of the last micro-batch one coalesced all-reduce makes every
gradient its sum over the data axis and its mean over the cv axis, before
the global norm and the clip (the JAX step clips the global gradient); the
logged losses are summed over the data group, so every rank logs the
global ones, and debug_logs reads the reduced gradients.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..losses import multi_stage_loss
from ..parallel.dist import Layout
from .metrics import depth_metrics
from .optim import clip_by_global_norm, global_norm

Tensor = torch.Tensor


def _loss(model, batch, depth_types, dlossw, inverse_depth, clip_func, group=None):
    outputs = model(batch["imgs"], batch["cams"], batch["depth_values"])
    dv = batch["depth_values"]
    total, loss_dict = multi_stage_loss(
        outputs, batch["depth_gt"], batch["mask"], dv[:, 1] - dv[:, 0],
        depth_types=depth_types, dlossw=dlossw, inverse_depth=inverse_depth,
        clip_func=clip_func, group=group)
    return (total, loss_dict, outputs["refined_depth"].detach(),
            outputs["photometric_confidence"].detach())


def debug_logs(model) -> Dict[str, Tensor]:
    """Per top-level module of `model`: the global norm of its gradients
    (fp32) and the count of their inf and NaN entries, as device tensors
    (the JAX package's _debug_logs, with its keys). A module whose
    parameters took no gradient (the frozen ViT) reports 0 and 0, as the
    JAX package's zero gradients of a stopped branch do."""
    out: Dict[str, Tensor] = {}
    for name, mod in model.named_children():
        params = list(mod.parameters())
        if not params:
            continue
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            out[f"gnorm/{name}"] = global_norm(params)
            out[f"nonfinite/{name}"] = sum((~torch.isfinite(g)).sum() for g in grads)
        else:
            out[f"gnorm/{name}"] = torch.zeros((), device=params[0].device)
            out[f"nonfinite/{name}"] = torch.zeros((), dtype=torch.int64,
                                                   device=params[0].device)
    return out


def _update(optimizer, scheduler, grad_clip, params) -> Tensor:
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
                     grad_clip: Optional[float] = None, debug: bool = False,
                     layout: Optional[Layout] = None) -> Dict[str, Tensor]:
    """One AdamW update on the mean gradient of `micro_batches`; the logged
    losses are their means and depth_est is the last micro-batch's. With
    `debug`, debug_logs of the mean gradient before the clip. With
    `layout`, the global batch's losses and gradients (module docstring)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    n = len(micro_batches)
    group = None if layout is None else layout.data
    sums: Dict[str, Tensor] = {}
    for mb in micro_batches:
        total, loss_dict, depth, conf = _loss(model, mb, depth_types, dlossw, inverse_depth,
                                              clip_func, group)
        (total / n).backward()
        for k, v in {"loss": total, **loss_dict}.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    logs = {k: v / n for k, v in sums.items()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if layout is not None:
        layout.reduce_grads(params)
        layout.data.sum_(list(logs.values()))
    logs["depth_est"] = depth
    if n == 1:
        logs["conf_est"] = conf
    if debug:
        logs.update(debug_logs(model))
    logs["grad_norm"] = _update(optimizer, scheduler, grad_clip, params)
    return logs


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
