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
the entropy and the confidence carry no gradient in either mode. Spans
(utils.profiler.annotate): `volume` (build_volume), `cost_reg` and `heads`
(the softmax, the depth and the confidence).

With `shard_views` (the JAX StageNet's, on a mesh with cv > 1) each rank of
the cv group `self.cv` (parallel.dist.Layout.attach) warps its own
nsrc / n_cv source views, and Σ_v prod·vis and Σ_v vis are summed over the
group before the division: every cv rank then holds the whole volume and
computes the same loss. The backward of that sum carries n_cv times the
volume's gradient into the layers before it, and the volume's gradient
once into those after it; the train step's mean of the gradients over cv
makes both right (parallel.dist.Layout.reduce_grads).

With `shard_depth` (the JAX StageNet's; not with shard_views) each cv rank
warps and correlates all source views over its own D / n_cv hypotheses. The
entropy's softmax over D becomes a distributed one: a MAX all-reduce of the
ranks' maxima, a SUM all-reduce of Σ exp, then each rank's part of
-Σ p log(p + 1e-7) summed over the group (no gradient: the similarity is
detached). Every rank then holds the same entropy, so the visibility net
needs no group beyond the data group's. The finished slices
[B, D / n_cv, H, W, G] are zero-padded to D and summed over the group, which
gathers the whole volume on every rank (gloo runs no all-gather on CUDA
tensors); each rank regularizes it and computes the same loss. The sum's
backward hands each rank n_cv times the volume gradient of its own slice:
the gradients of the layers before the gather (the FPN, the ViT decoder and
FMT, the visibility nets) are then n_cv times their share of the slices,
which summed over cv is n_cv times the true gradient, and those after it
(the regularizer) the true gradient on every rank. The train step's one
rule, a sum over data and a mean over cv, makes both right.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import compose_projection
from ..ops.grid_sample import homography_warp
from ..ops.sampling import conf_regression, depth_regression
from ..parallel.dist import Group
from ..utils.profiler import annotate
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
    'Normal' (CostRegNet3D when ndepth <= model_th, else CostRegNet).
    `log_var` gives the CostRegNet3D its uncertainty channel and the output
    its "log_var" map (other regularizers raise, as in the JAX StageNet)."""

    def __init__(self, ndepth: int, groups: int = 8, cost_reg_type: str = "Normal",
                 depth_type: str = "ce", transformer_config: Optional[dict] = None,
                 model_th: int = 8, remat_cost_reg: bool = False, shard_views: bool = False,
                 shard_depth: bool = False, log_var: bool = False, dtype=torch.float32):
        super().__init__()
        if shard_views and shard_depth:
            raise ValueError("shard_views and shard_depth both split over the cv ranks: "
                             "choose one")
        if log_var and (cost_reg_type == "PureTransformerCostReg" or ndepth > model_th):
            raise ValueError(f"log_var=True requires the CostRegNet3D regularizer "
                             f"(cost_reg_type 'Normal' with ndepth <= {model_th}); "
                             f"stage has {cost_reg_type} ndepth={ndepth}")
        self.vis = VisibilityNet(dtype)
        if cost_reg_type == "PureTransformerCostReg":
            cfg = dict(transformer_config or {})
            for k in ("base_channel", "attention_type", "drop", "attn_drop"):
                cfg.pop(k, None)
            self.cost_reg = PureTransformerCostReg(base_channel=groups, dtype=dtype, **cfg)
        elif ndepth <= model_th:
            self.cost_reg = CostRegNet3D(groups, groups, log_var, dtype=dtype)
        else:
            self.cost_reg = CostRegNet(groups, groups, dtype=dtype)
        self.ndepth, self.groups = ndepth, groups
        self.cost_reg_type, self.depth_type = cost_reg_type, depth_type
        self.remat_cost_reg = remat_cost_reg
        self.shard_views, self.shard_depth = shard_views, shard_depth
        self.log_var = log_var
        self.cv = Group()
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
        views = slice(1, v)
        if self.shard_views:
            if nsrc % self.cv.size:
                raise ValueError(f"shard_views: {nsrc} source views do not split over "
                                 f"{self.cv.size} cv ranks")
            nsrc //= self.cv.size
            views = slice(1 + self.cv.index * nsrc, 1 + (self.cv.index + 1) * nsrc)
        depths = slice(0, d)
        if self.shard_depth:
            if d % self.cv.size:
                raise ValueError(f"shard_depth: {d} hypotheses do not split over "
                                 f"{self.cv.size} cv ranks")
            dl = d // self.cv.size
            depths = slice(self.cv.index * dl, (self.cv.index + 1) * dl)
        dl = depths.stop - depths.start
        # views folded into the batch, view-major: row i*B + j is view `views`[i] of batch j
        src = features[:, views].transpose(0, 1).reshape(nsrc * b, h, w, c)
        src_projs = projs[:, views].transpose(0, 1).reshape(nsrc * b, 4, 4)
        ref_proj = projs[:, 0].repeat(nsrc, 1, 1)
        dv = depth_values[:, depths].repeat(nsrc, *([1] * (depth_values.ndim - 1)))
        warped, _ = homography_warp(src, src_projs, ref_proj, dv)  # [nsrc*B, D, H, W, C]
        prod = warped.reshape(nsrc, b, dl, h, w, c) * ref_feat[None, :, None]
        del warped
        entropy = self.entropy(prod.detach().sum(dim=-1) / sub)  # [nsrc, B, H, W]
        vis = self.vis(entropy.reshape(nsrc * b, h, w, 1)).reshape(nsrc, b, 1, h, w, 1)
        volume_sum, vis_sum = (prod * vis).sum(dim=0), vis.sum(dim=0)
        if self.shard_views:
            volume_sum, vis_sum = self.cv.sum(volume_sum), self.cv.sum(vis_sum)
        volume = volume_sum / (vis_sum + 1e-6)  # [B, D, H, W, C]
        volume = volume.reshape(b, dl, h, w, self.groups, sub).mean(dim=-1)
        if self.shard_depth:  # the zero-padded slices summed: the whole volume
            volume = self.cv.sum(F.pad(volume, (0, 0) * 3 + (depths.start, d - depths.stop)))
        return volume

    def entropy(self, sim: Tensor) -> Tensor:
        """[nsrc, B, D, H, W] similarity (no gradient) -> [nsrc, B, H, W]:
        -Σ p log(p + 1e-7) of p = softmax over D; under shard_depth over the
        D slices of the cv group."""
        if not self.shard_depth:
            p = torch.softmax(sim, dim=2)
            return -torch.sum(p * torch.log(p + 1e-7), dim=2)
        e = torch.exp(sim - self.cv.max(sim.amax(dim=2, keepdim=True)))
        p = e / self.cv.sum(e.sum(dim=2, keepdim=True))
        return self.cv.sum(-torch.sum(p * torch.log(p + 1e-7), dim=2))

    def forward(self, features: Tensor, cams: Tensor, depth_values: Tensor, tmp: float = 1.0,
                position3d: Optional[Tensor] = None) -> dict:
        with annotate("volume"):
            volume = self.build_volume(features, cams, depth_values).to(self.dtype)
        args = (volume, position3d) if self.cost_reg_type == "PureTransformerCostReg" else (volume,)
        with annotate("cost_reg"):
            if self.remat_cost_reg:
                reg = remat(self.cost_reg, *args)
            else:
                reg = self.cost_reg(*args)
        with annotate("heads"):
            prob_pre = reg[..., 0].float()  # [B, D, H, W]
            prob_volume = torch.softmax(prob_pre, dim=1)
            if self.depth_type == "ce":
                if self.training:
                    idx = prob_volume.argmax(dim=1, keepdim=True)  # [B, 1, H, W]
                    dv4 = (depth_values if depth_values.ndim == 4
                           else depth_values[:, :, None, None])
                    depth = torch.gather(dv4.expand_as(prob_volume), 1, idx)[:, 0]
                else:
                    depth = depth_regression(torch.softmax(prob_pre * tmp, dim=1), depth_values)
                confidence = prob_volume.max(dim=1).values
            else:
                depth = depth_regression(prob_volume, depth_values)
                n = 4 if self.ndepth >= 32 else {16: 3, 8: 2}.get(self.ndepth)
                confidence = (conf_regression(prob_volume, n) if n is not None
                              else prob_volume.max(dim=1).values)
            out = {"depth": depth, "prob_volume": prob_volume,
                   "photometric_confidence": confidence.detach(),
                   "depth_values": depth_values, "prob_volume_pre": prob_pre}
            if self.log_var:  # the log-variance's expectation under the depth distribution
                out["log_var"] = torch.sum(prob_volume * reg[..., 1].float(), dim=1)
        return out
