"""CasMVSNet, the CNN-only cascade baseline (counterpart of
mvsformerplusplus_tpu/models/casmvs.py): FPN encoder and decoder features
of each view, the views folded into the batch, then the shared 4-stage
cascade. No ViT, no FMT, and by default a 3D U-Net regularizer at every
stage. The class keeps the JAX class's defaults (whole-stage remat, fp32);
`config.build_model` passes the configs' "cost_reg" remat and the caller's
dtype, as the JAX build_model does."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..utils.profiler import annotate
from .cascade import CascadeDepth
from .layers import FPNDecoder, FPNEncoder

Tensor = torch.Tensor


class CasMVSNet(nn.Module):
    def __init__(self, feat_chs: Sequence[int] = (8, 16, 32, 64),
                 ndepths: Sequence[int] = (32, 16, 8, 4),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.67, 1.5, 1.0),
                 inverse_depth: bool = True, depth_type: Sequence[str] = ("ce",) * 4,
                 groups: Sequence[int] = (8, 8, 8, 8),
                 cost_reg_type: Sequence[str] = ("Normal",) * 4,
                 transformer_config: Optional[Sequence[dict]] = None, use_pe3d: bool = False,
                 remat_stages: bool = True, remat_granularity: str = "stage",
                 shard_views: bool = False, shard_depth: bool = False,
                 log_var: Union[bool, Sequence[bool]] = False, dtype=torch.float32):
        super().__init__()
        self.encoder = FPNEncoder(feat_chs, dtype)
        self.decoder = FPNDecoder(feat_chs, dtype)
        self.cascade = CascadeDepth(ndepths, depth_intervals_ratio, inverse_depth, cost_reg_type,
                                    depth_type, groups, use_pe3d, transformer_config,
                                    remat_stages, remat_granularity, shard_views,
                                    shard_depth, log_var, dtype)
        self.dtype = dtype

    def forward(self, imgs: Tensor, cams: Dict[str, Tensor], depth_values: Tensor,
                tmp: Sequence[float] = (5.0, 5.0, 5.0, 1.0)) -> dict:
        """imgs [B, V, H, W, 3]; cams {'stage1'..'stage4': [B, V, 2, 4, 4]};
        depth_values [B, Dfull]. Spans (utils.profiler.annotate): `forward`
        around `encoder`, `decoder` and the cascade's."""
        with annotate("forward"):
            b, v, h, w, _ = imgs.shape
            with annotate("encoder"):
                c = self.encoder(imgs.reshape(b * v, h, w, 3).to(self.dtype))
            with annotate("decoder"):
                f = self.decoder(*c)
            features = {f"stage{i + 1}": x.reshape(b, v, *x.shape[1:]) for i, x in enumerate(f)}
            return self.cascade(features, cams, depth_values, tmp)
