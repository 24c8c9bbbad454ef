"""Optimizer and LR schedule (counterpart of
mvsformerplusplus_tpu/train/optim.py): AdamW in two parameter groups with a
warmup-cosine schedule.

- warmup: linear 0 -> 1 over `warmup_steps`; then cosine from 1 down to the
  fractional floor `min_lr_frac`;
- groups: every trainable parameter outside the ViT at `lr` with weight
  decay 0.0; the ViT at `vit_lr` with `weight_decay`, or, when it is frozen,
  in no group at all (its parameters take no gradient and never move);
- the schedule is a LambdaLR read at the optimizer's step count before the
  step, as optax reads its count: the first step runs at schedule(0), which
  is 0 during warmup;
- `clip_by_global_norm` is optax.clip_by_global_norm: scale every gradient
  by max_norm / norm when the global norm exceeds max_norm.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch
import torch.nn as nn


def warmup_cosine(step: int, warmup_steps: int, total_steps: int, min_lr_frac: float) -> float:
    """The schedule's factor of the base learning rate at `step`."""
    if step < warmup_steps:
        return step / max(1.0, warmup_steps)
    denom = max(1, total_steps - warmup_steps)
    return min_lr_frac + (1.0 - min_lr_frac) * 0.5 * (
        1.0 + math.cos(math.pi * (step - warmup_steps) / denom))


def _is_vit(name: str) -> bool:
    return name.split(".", 1)[0] == "vit"


def make_optimizer(model: nn.Module, lr: float = 1e-3, vit_lr: float = 3e-5,
                   weight_decay: float = 0.01, min_lr_frac: float = 0.01,
                   warmup_steps: int = 500, total_steps: int = 100_000,
                   freeze_vit: bool = True):
    """(AdamW, LambdaLR) over the model's trainable parameters, grouped by
    the top-level module name 'vit'."""
    main, vit = [], []
    for name, p in model.named_parameters():
        if not _is_vit(name):
            main.append(p)
        elif not freeze_vit:
            vit.append(p)
    groups = [{"params": [p for p in main if p.requires_grad], "lr": lr, "weight_decay": 0.0}]
    if vit:
        groups.append({"params": vit, "lr": vit_lr, "weight_decay": weight_decay})
    opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: warmup_cosine(step, warmup_steps, total_steps, min_lr_frac))
    return opt, sched


def refresh_lr(scheduler) -> None:
    """Set each group's learning rate to the LambdaLR's schedule at its
    current step (after its state or its base rates were replaced)."""
    for group, base, fn in zip(scheduler.optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(scheduler.last_epoch)
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]


def scale_vit_grads_by_layer(model: nn.Module, layer_decay: float, depth: int = 12) -> int:
    """Multiply the gradient of every trainable ViT parameter by its layer's
    scale from vit_layer_decay_scales (as scale_vit_grads_by_layer of the
    JAX package scales the gradients before the clip and the update), with a
    gradient hook on each. Returns the number of parameters hooked: none when
    the ViT is frozen."""
    scales = vit_layer_decay_scales(layer_decay, depth)
    n = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        if _is_vit(name) and p.requires_grad and len(parts) > 1:
            s = scales.get(parts[1], 1.0)
            p.register_hook(lambda g, s=s: g * s)
            n += 1
    return n


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over the gradients of `params`, fp32."""
    grads = [p.grad.float() for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(params, max_norm: float, norm: Optional[torch.Tensor] = None):
    """Where the global norm exceeds max_norm, replace every gradient g by
    g / norm * max_norm (optax's order of operations). Returns the norm."""
    params = [p for p in params if p.grad is not None]
    norm = global_norm(params) if norm is None else norm
    if norm >= max_norm:
        for p in params:
            p.grad.div_(norm.to(p.grad.dtype)).mul_(max_norm)
    return norm


def vit_layer_decay_scales(layer_decay: float = 0.75, depth: int = 12) -> dict:
    """BEiT-style layer-wise LR scale per ViT sub-tree, keyed by the ViT's
    submodule names (patch_embed, cls_token, pos_embed, blocks_i, norm);
    unused by the default configs, for unfrozen-ViT fine-tuning."""
    num_layers = depth + 1
    scales = [layer_decay ** (num_layers - i) for i in range(num_layers + 1)]
    mapping = {"patch_embed": scales[0], "cls_token": scales[0],
               "pos_embed": scales[0], "norm": scales[num_layers]}
    for i in range(depth):
        mapping[f"blocks_{i}"] = scales[i + 1]
    return mapping
