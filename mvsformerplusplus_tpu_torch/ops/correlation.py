"""Group-wise correlation and entropy-based view weighting for cost volumes
(counterpart of mvsformerplusplus_tpu/ops/correlation.py), as plain
functions on channel-last fp32 tensors. StageNet.build_volume runs the same
arithmetic inline (the full-C product weighted over views, the group mean
last); these are the per-view building blocks:

  warp src features over D hypotheses -> groupwise_correlation with the
  reference -> correlation_entropy -> a visibility weight per view ->
  accumulate_weighted_volume over views.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

Tensor = torch.Tensor


def groupwise_correlation(warped: Tensor, ref_feat: Tensor, groups: int) -> Tensor:
    """warped [B, D, H, W, C], ref_feat [B, H, W, C] -> [B, D, H, W, G] fp32:
    the mean over each group's C / G channels of warped * ref (G == C: the
    elementwise product)."""
    b, d, h, w, c = warped.shape
    if c % groups:
        raise ValueError(f"C={c} not divisible by G={groups}")
    ref = ref_feat.float()
    warped = warped.float()
    if groups == c:
        return warped * ref[:, None]
    sub = c // groups
    return (warped.reshape(b, d, h, w, groups, sub)
            * ref.reshape(b, 1, h, w, groups, sub)).mean(dim=-1)


def correlation_entropy(corr: Tensor) -> Tensor:
    """corr [B, D, H, W, G] -> [B, H, W, 1]: the entropy of the softmax over
    D of the group-summed correlation, -Σ p log(p + 1e-7), with no gradient
    into corr."""
    sim = corr.detach().sum(dim=-1)
    p = torch.softmax(sim, dim=1)
    return -(p * torch.log(p + 1e-7)).sum(dim=1)[..., None]


def accumulate_weighted_volume(volumes_and_weights: Iterable[Tuple[Tensor, Tensor]]) -> Tensor:
    """[(corr [B, D, H, W, G], vis [B, H, W, 1]), ...] over views ->
    Σ corr·vis / (Σ vis + 1e-6), [B, D, H, W, G]."""
    volume_sum, vis_sum = 0.0, 0.0
    for corr, vis in volumes_and_weights:
        volume_sum = volume_sum + corr * vis[:, None]
        vis_sum = vis_sum + vis
    return volume_sum / (vis_sum[:, None] + 1e-6)
