"""DINOv2MVSNet, the flagship model (counterpart of
mvsformerplusplus_tpu/models/mvsformer.py): frozen DINOv2 features + SVA
cross-view decoder + FPN + FMT + 4-stage cascade. Views are folded into the
batch for all per-view compute. With `freeze_vit` (the default, as in the
JAX package) the ViT's parameters take no gradient and it runs under
torch.no_grad(), so none of its activations are kept for a backward."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..ops.resize import resize2d
from ..utils.profiler import annotate
from .cascade import CascadeDepth
from .cross_vit import CrossVITDecoder
from .dino import DinoVisionTransformer
from .fmt import _VARIANTS, FMTWithPathway
from .layers import FPNDecoder, FPNEncoder

Tensor = torch.Tensor


class DINOv2MVSNet(nn.Module):
    def __init__(self, feat_chs: Sequence[int] = (8, 16, 32, 64), rescale: float = 0.4375,
                 vit_ch: int = 768, out_ch: int = 64, vit_patch: int = 14, vit_depth: int = 12,
                 vit_num_heads: int = 12, cross_interval_layers: int = 3,
                 decoder_cfg: Optional[dict] = None, fmt_config: Optional[dict] = None,
                 ndepths: Sequence[int] = (32, 16, 8, 4),
                 depth_intervals_ratio: Sequence[float] = (4.0, 2.67, 1.5, 1.0),
                 inverse_depth: bool = True, depth_type: Sequence[str] = ("ce",) * 4,
                 groups: Sequence[int] = (8, 8, 8, 8),
                 cost_reg_type: Sequence[str] = ("PureTransformerCostReg", "Normal", "Normal",
                                                 "Normal"),
                 transformer_config: Optional[Sequence[dict]] = None, use_pe3d: bool = True,
                 freeze_vit: bool = True, remat_stages: bool = True,
                 remat_granularity: str = "cost_reg", shard_views: bool = False,
                 shard_depth: bool = False, log_var: Union[bool, Sequence[bool]] = False,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = FPNEncoder(feat_chs, dtype)
        self.decoder = FPNDecoder(feat_chs, dtype)
        self.vit = DinoVisionTransformer(embed_dim=vit_ch, depth=vit_depth,
                                         num_heads=vit_num_heads, patch_size=vit_patch,
                                         cross_interval_layers=cross_interval_layers,
                                         dtype=dtype)
        self.freeze_vit = freeze_vit
        if freeze_vit:
            self.vit.requires_grad_(False)
        dec = dict(decoder_cfg or {})
        self.decoder_vit = CrossVITDecoder(
            d_model=dec.get("d_model", vit_ch), nhead=dec.get("nhead", 12),
            cross_interval_layers=cross_interval_layers,
            variant=_VARIANTS.get(dec.get("attention_type", "Linear"), "linear"),
            ffn_type=dec.get("ffn_type", "ffn"), init_values=dec.get("init_values", 1.0),
            prev_values=dec.get("prev_values", 0.5),
            softmax_scale=dec.get("softmax_scale", "entropy_invariance"),
            train_avg_length=dec.get("train_avg_length", 762),
            post_norm=dec.get("post_norm", False), pre_norm_query=dec.get("pre_norm_query", True),
            no_combine_norm=dec.get("no_combine_norm", False), out_ch=out_ch, dtype=dtype)
        self.fmt = FMTWithPathway(groups[0], fmt_config, dtype)
        self.cascade = CascadeDepth(ndepths, depth_intervals_ratio, inverse_depth, cost_reg_type,
                                    depth_type, groups, use_pe3d, transformer_config,
                                    remat_stages, remat_granularity, shard_views,
                                    shard_depth, log_var, dtype)
        self.rescale, self.vit_patch, self.vit_ch = rescale, vit_patch, vit_ch
        self.dtype = dtype

    def vit_features(self, imgs_flat: Tensor, b: int, v: int) -> Tensor:
        """[B·V, H, W, 3] full-res -> [B, V, H/8, W/8, out_ch]."""
        _, h, w, _ = imgs_flat.shape
        p = self.vit_patch
        vit_h = int(h * self.rescale // p * p)
        vit_w = int(w * self.rescale // p * p)
        with annotate("vit"):
            vit_imgs = resize2d(imgs_flat, vit_h, vit_w, method="cubic", align_corners=False)
            with torch.no_grad() if self.freeze_vit else contextlib.nullcontext():
                levels = self.vit(vit_imgs)
            levels = [f.reshape(b, v, -1, self.vit_ch) for f in levels]
        with annotate("decoder_vit"):
            return self.decoder_vit(levels, (b, v, vit_h // p, vit_w // p, self.vit_ch))

    def forward(self, imgs: Tensor, cams: Dict[str, Tensor], depth_values: Tensor,
                tmp: Sequence[float] = (5.0, 5.0, 5.0, 1.0)) -> dict:
        """imgs [B, V, H, W, 3]; cams {'stage1'..'stage4': [B, V, 2, 4, 4]};
        depth_values [B, Dfull]. Spans (utils.profiler.annotate): `forward`
        around `encoder`, `vit`, `decoder_vit`, `decoder` (with the ViT
        features' resize and add), `fmt` and the cascade's."""
        with annotate("forward"):
            b, v, h, w, _ = imgs.shape
            flat = imgs.reshape(b * v, h, w, 3).to(self.dtype)
            with annotate("encoder"):
                c01, c11, c21, c31 = self.encoder(flat)
            vit_feat = self.vit_features(flat, b, v)
            with annotate("decoder"):
                vit_flat = vit_feat.reshape(b * v, vit_feat.shape[2], vit_feat.shape[3], -1)
                if vit_flat.shape[1:3] != c31.shape[1:3]:
                    vit_flat = resize2d(vit_flat, c31.shape[1], c31.shape[2], method="linear",
                                        align_corners=False)
                c31 = c31 + vit_flat.to(self.dtype)
                f = self.decoder(c01, c11, c21, c31)
            features = {f"stage{i + 1}": x.reshape(b, v, *x.shape[1:]) for i, x in enumerate(f)}
            with annotate("fmt"):
                features = self.fmt(features)
            return self.cascade(features, cams, depth_values, tmp)
