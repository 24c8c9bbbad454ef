"""One cascade stage: plane-sweep cost volume + regularization + depth and
confidence heads (counterpart of mvsformerplusplus_tpu/models/stagenet.py on
its exact `folded` warp path).

The source views are folded into the batch for one warp launch per stage:
warp -> full-C product with the reference features -> entropy of the depth
softmax -> visibility weight; the volume is the visibility-weighted mean
over views, reduced to G correlation groups at the end (the group mean
commutes with the weighted sum).

In train mode (`self.training`), as the JAX StageNet with train=True: a CE
stage's depth is the hypothesis at the argmax of the probabilities (which
moves the next stage's hypotheses), and with `remat_cost_reg` the
regularizer is checkpointed (recomputed in the backward, with the running
BatchNorm statistics left alone on the replay). The similarity that feeds
the entropy and the confidence carry no gradient in either mode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.geometry import compose_projection
from ..ops.grid_sample import homography_warp
from ..ops.sampling import conf_regression, depth_regression
from .cost_reg import CostRegNet, CostRegNet3D, PureTransformerCostReg
from .layers import ConvBnReLU, MMConv, remat

Tensor = torch.Tensor


class VisibilityNet(nn.Module):
    """Entropy -> per-view visibility weight in (0, 1)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.ConvBnReLU_0 = ConvBnReLU(1, 16, dtype=dtype)
        self.ConvBnReLU_1 = ConvBnReLU(16, 16, dtype=dtype)
        self.ConvBnReLU_2 = ConvBnReLU(16, 8, dtype=dtype)
        self.Conv_0 = MMConv(8, 1, (1, 1), dtype=dtype)
        self.dtype = dtype

    def forward(self, entropy: Tensor) -> Tensor:
        x = self.ConvBnReLU_2(self.ConvBnReLU_1(self.ConvBnReLU_0(entropy.to(self.dtype))))
        return torch.sigmoid(self.Conv_0(x).float())


class StageNet(nn.Module):
    """One coarse-to-fine stage. cost_reg_type 'PureTransformerCostReg' or
    'Normal' (CostRegNet3D when ndepth <= model_th, else CostRegNet)."""

    def __init__(self, ndepth: int, groups: int = 8, cost_reg_type: str = "Normal",
                 depth_type: str = "ce", transformer_config: Optional[dict] = None,
                 model_th: int = 8, remat_cost_reg: bool = False, dtype=torch.float32):
        super().__init__()
        self.vis = VisibilityNet(dtype)
        if cost_reg_type == "PureTransformerCostReg":
            cfg = dict(transformer_config or {})
            for k in ("base_channel", "attention_type", "drop", "attn_drop"):
                cfg.pop(k, None)
            self.cost_reg = PureTransformerCostReg(base_channel=groups, dtype=dtype, **cfg)
        elif ndepth <= model_th:
            self.cost_reg = CostRegNet3D(groups, groups, dtype=dtype)
        else:
            self.cost_reg = CostRegNet(groups, groups, dtype=dtype)
        self.ndepth, self.groups = ndepth, groups
        self.cost_reg_type, self.depth_type = cost_reg_type, depth_type
        self.remat_cost_reg = remat_cost_reg
        self.dtype = dtype

    def build_volume(self, features: Tensor, cams: Tensor, depth_values: Tensor) -> Tensor:
        """features [B, V, H, W, C] (view 0 = reference), cams [B, V, 2, 4, 4],
        depth_values [B, D, H, W] -> volume [B, D, H, W, G] f32."""
        b, v, h, w, c = features.shape
        nsrc = v - 1
        d = depth_values.shape[1]
        sub = c // self.groups
        ref_feat = features[:, 0].float()
        projs = compose_projection(cams)
        # views folded into the batch, view-major: row i*B + j is view i+1 of batch j
        src = features[:, 1:].transpose(0, 1).reshape(nsrc * b, h, w, c)
        src_projs = projs[:, 1:].transpose(0, 1).reshape(nsrc * b, 4, 4)
        ref_proj = projs[:, 0].repeat(nsrc, 1, 1)
        dv = depth_values.repeat(nsrc, *([1] * (depth_values.ndim - 1)))
        warped, _ = homography_warp(src, src_projs, ref_proj, dv)  # [nsrc*B, D, H, W, C]
        prod = warped.reshape(nsrc, b, d, h, w, c) * ref_feat[None, :, None]
        del warped
        sim = prod.detach().sum(dim=-1) / sub
        p = torch.softmax(sim, dim=2)
        entropy = -torch.sum(p * torch.log(p + 1e-7), dim=2)  # [nsrc, B, H, W]
        vis = self.vis(entropy.reshape(nsrc * b, h, w, 1)).reshape(nsrc, b, 1, h, w, 1)
        volume = (prod * vis).sum(dim=0) / (vis.sum(dim=0) + 1e-6)  # [B, D, H, W, C]
        return volume.reshape(b, d, h, w, self.groups, sub).mean(dim=-1)

    def forward(self, features: Tensor, cams: Tensor, depth_values: Tensor, tmp: float = 1.0,
                position3d: Optional[Tensor] = None) -> dict:
        volume = self.build_volume(features, cams, depth_values).to(self.dtype)
        args = (volume, position3d) if self.cost_reg_type == "PureTransformerCostReg" else (volume,)
        if self.remat_cost_reg:
            reg = remat(self.cost_reg, *args)
        else:
            reg = self.cost_reg(*args)
        prob_pre = reg[..., 0].float()  # [B, D, H, W]
        prob_volume = torch.softmax(prob_pre, dim=1)
        if self.depth_type == "ce":
            if self.training:
                idx = prob_volume.argmax(dim=1, keepdim=True)  # [B, 1, H, W]
                dv4 = depth_values if depth_values.ndim == 4 else depth_values[:, :, None, None]
                depth = torch.gather(dv4.expand_as(prob_volume), 1, idx)[:, 0]
            else:
                depth = depth_regression(torch.softmax(prob_pre * tmp, dim=1), depth_values)
            confidence = prob_volume.max(dim=1).values
        else:
            depth = depth_regression(prob_volume, depth_values)
            n = 4 if self.ndepth >= 32 else {16: 3, 8: 2}.get(self.ndepth)
            confidence = (conf_regression(prob_volume, n) if n is not None
                          else prob_volume.max(dim=1).values)
        return {"depth": depth, "prob_volume": prob_volume,
                "photometric_confidence": confidence.detach(),
                "depth_values": depth_values, "prob_volume_pre": prob_pre}
