"""Multi-stage depth losses: binned cross-entropy and smooth-L1 regression
(counterpart of mvsformerplusplus_tpu/losses.py), in masked-weighted form:
`mean over selected` is `sum(x * mask) / (sum(mask) + 1e-6)`.

CE: the ground-truth depth maps to a bin index through half-interval bin
edges. Under inverse_depth the hypotheses descend in depth, so they are
flipped before binning and the index is flipped back (log_softmax is
flip-equivariant, so the logits are not flipped). Ground truth outside
[min_edge, max_edge] is masked out with the invalid pixels.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

Tensor = torch.Tensor


def _masked_mean(x: Tensor, mask: Tensor) -> Tensor:
    m = mask.float()
    return torch.sum(x * m) / (torch.sum(m) + 1e-6)


def ce_depth_loss(prob_volume_pre: Tensor, depth_values: Tensor, depth_gt: Tensor,
                  mask: Tensor, inverse_depth: bool = True) -> Tensor:
    """Binned cross-entropy for one stage. prob_volume_pre [B, D, H, W]
    logits; depth_values [B, D, H, W] hypotheses; depth_gt / mask [B, H, W]."""
    logits = prob_volume_pre.float()
    dv = depth_values.float().detach()
    gt = depth_gt.float()[:, None]  # [B, 1, H, W]
    valid = mask.float() > 0.5
    ndepth = dv.shape[1]
    if inverse_depth:
        dv = torch.flip(dv, dims=(1,))
    intervals = (dv[:, 1:] - dv[:, :-1]).abs() / 2
    intervals = torch.cat([intervals, intervals[:, -1:]], dim=1)
    min_edge = dv[:, :1] - intervals[:, :1]
    max_edge = dv[:, -1:] + intervals[:, -1:]
    right_edges = dv + intervals
    final_mask = ((gt >= min_edge) & (gt <= max_edge))[:, 0] & valid
    gt_index = (right_edges <= gt).sum(dim=1).clamp(0, ndepth - 1)  # [B, H, W]
    if inverse_depth:
        gt_index = ndepth - 1 - gt_index
    log_probs = torch.log_softmax(logits, dim=1)
    nll = -torch.gather(log_probs, 1, gt_index[:, None])[:, 0]
    return _masked_mean(nll, final_mask)


def smooth_l1(x: Tensor, y: Tensor) -> Tensor:
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def reg_depth_loss(depth_est: Tensor, depth_gt: Tensor, mask: Tensor, depth_interval: Tensor,
                   depth_values: Optional[Tensor] = None, inverse_depth: bool = True,
                   clip_func: Optional[str] = None, log_var: Optional[Tensor] = None,
                   logvar_weight: float = 0.1):
    """Interval-normalized smooth-L1 with optional dynamic clipping (at the
    hypothesis range over the interval) and log-variance uncertainty.
    Returns (loss, extras)."""
    di = depth_interval.float()[:, None, None]
    est = depth_est.float() / di
    gt = depth_gt.float() / di
    valid = mask.float() > 0.5
    clip_max = None
    if clip_func == "dynamic" and depth_values is not None:
        dv = depth_values.float()
        lo, hi = (dv[:, -1], dv[:, 0]) if inverse_depth else (dv[:, 0], dv[:, -1])
        clip_max = (hi - lo) / di  # [B, H, W]
    extras = {}
    if log_var is None:
        err = smooth_l1(est, gt)
        if clip_max is not None:
            err = torch.minimum(err, clip_max)
        loss = _masked_mean(err, valid)
    else:
        l1 = (est - gt).abs()
        if clip_max is not None:
            l1 = torch.minimum(l1, clip_max)
        lv = log_var.float()
        uncert = l1 * torch.exp(-lv) + lv * logvar_weight
        finite = torch.isfinite(uncert) & valid
        uncert_loss = _masked_mean(torch.where(finite, uncert, 0.0), finite)
        loss = _masked_mean(l1, valid) + uncert_loss
        extras["uncertainty"] = uncert_loss
    return loss, extras


def multi_stage_loss(outputs: Dict[str, dict], depth_gt_ms: Dict[str, Tensor],
                     mask_ms: Dict[str, Tensor], depth_interval: Tensor,
                     depth_types: Sequence[str] = ("ce", "ce", "ce", "ce"),
                     dlossw: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                     inverse_depth: bool = True, clip_func: Optional[str] = "dynamic",
                     logvar_weight: float = 0.1):
    """Total weighted loss and the per-stage dict."""
    loss_dict = {}
    total = 0.0
    for idx, dt in enumerate(depth_types):
        key = f"stage{idx + 1}"
        if key not in outputs:
            continue
        stage = outputs[key]
        if dt == "ce":
            loss = ce_depth_loss(stage["prob_volume_pre"], stage["depth_values"],
                                 depth_gt_ms[key], mask_ms[key], inverse_depth)
        else:
            loss, extras = reg_depth_loss(
                stage["depth"], depth_gt_ms[key], mask_ms[key], depth_interval,
                depth_values=stage["depth_values"], inverse_depth=inverse_depth,
                clip_func=clip_func, log_var=stage.get("log_var"), logvar_weight=logvar_weight)
            for k, v in extras.items():
                loss_dict[f"{key}_{k}"] = dlossw[idx] * v
        loss_dict[key] = dlossw[idx] * loss
        total = total + dlossw[idx] * loss
    return total, loss_dict
