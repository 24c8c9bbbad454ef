"""FMT, the feature matching transformer with its multi-scale pathway
(counterpart of mvsformerplusplus_tpu/models/fmt.py). The reference view runs
the 'self' layers first (caching each output); every source view then runs
the whole stack, attending against the cached reference features. The
pathway carries the stage-1 result down to stages 2-4 by 1x1 reduction,
bilinear upsample-add and 3x3 smoothing."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.pe import sine_pe_2d
from ..ops.resize import resize2d
from .blocks import CrossBlock
from .layers import MMConv

Tensor = torch.Tensor

_VARIANTS = {"Linear": "linear", "FLASH2": "softmax", "XFormers": "softmax"}


class FMT(nn.Module):
    def __init__(self, d_model: int = 64, nhead: int = 4,
                 layer_names: Sequence[str] = ("self", "cross", "self", "cross"),
                 variant: str = "linear", ffn_type: str = "ffn",
                 init_values: Optional[float] = 1.0,
                 softmax_scale: Optional[str] = "entropy_invariance",
                 train_avg_length: Optional[int] = 12185, post_norm: bool = False,
                 pre_norm_query: bool = False, dtype=torch.float32):
        super().__init__()
        self.layer_names = tuple(layer_names)
        for i in range(len(self.layer_names)):
            setattr(self, f"layer{i}", CrossBlock(
                d_model, nhead, variant=variant, ffn_type=ffn_type, init_values=init_values,
                softmax_scale=softmax_scale, train_avg_length=train_avg_length,
                post_norm=post_norm, pre_norm_query=pre_norm_query, dtype=dtype))

    @staticmethod
    def _tokens(feat: Tensor) -> Tensor:
        b, h, w, c = feat.shape
        pe = sine_pe_2d(c, h, w, device=feat.device).to(feat.dtype)
        return (feat + pe).reshape(b, h * w, c)

    def forward_ref(self, ref_feature: Tensor):
        """[B, H, W, C] -> outputs of the 'self' layers, in order."""
        x = self._tokens(ref_feature)
        outs = []
        for i, name in enumerate(self.layer_names):
            if name == "self":
                x = getattr(self, f"layer{i}")(x)
                outs.append(x)
        return outs

    def forward_src(self, ref_feature_list, src_feature: Tensor) -> Tensor:
        b, h, w, c = src_feature.shape
        x = self._tokens(src_feature)
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer{i}")
            if name == "self":
                x = layer(x)
            else:
                ref_idx = i if len(ref_feature_list) == len(self.layer_names) else i // 2
                ref = ref_feature_list[ref_idx]
                x = layer(x, key=ref, value=ref)
        return x.reshape(b, h, w, c)


class FMTWithPathway(nn.Module):
    def __init__(self, base_channel: int = 8, fmt_config: Optional[dict] = None,
                 dtype=torch.float32):
        super().__init__()
        cfg = dict(fmt_config or {})
        for k in ("base_channel", "attn_backend", "self_cross_types"):
            cfg.pop(k, None)
        variant = _VARIANTS.get(cfg.pop("attention_type", "Linear"), "linear")
        d_model = cfg.get("d_model", 64)
        self.fmt = FMT(
            d_model=d_model, nhead=cfg.get("nhead", 4),
            layer_names=tuple(cfg.get("layer_names", ("self", "cross", "self", "cross"))),
            variant=variant, ffn_type=cfg.get("ffn_type", "ffn"),
            init_values=cfg.get("init_values", 1.0),
            softmax_scale=cfg.get("softmax_scale", "entropy_invariance"),
            train_avg_length=cfg.get("train_avg_length", 12185),
            post_norm=cfg.get("post_norm", False),
            pre_norm_query=cfg.get("pre_norm_query", False), dtype=dtype)
        bc = base_channel
        self.dim_reduction_1 = MMConv(d_model, bc * 4, (1, 1), use_bias=False, dtype=dtype)
        self.dim_reduction_2 = MMConv(bc * 4, bc * 2, (1, 1), use_bias=False, dtype=dtype)
        self.dim_reduction_3 = MMConv(bc * 2, bc, (1, 1), use_bias=False, dtype=dtype)
        self.smooth_1 = MMConv(bc * 4, bc * 4, (3, 3), use_bias=False, dtype=dtype)
        self.smooth_2 = MMConv(bc * 2, bc * 2, (3, 3), use_bias=False, dtype=dtype)
        self.smooth_3 = MMConv(bc, bc, (3, 3), use_bias=False, dtype=dtype)
        self.dtype = dtype

    def _upsample_add(self, x: Tensor, y: Tensor) -> Tensor:
        up = resize2d(x, y.shape[1], y.shape[2], method="linear", align_corners=False)
        return (up.float() + y.float()).to(self.dtype)

    def forward(self, features: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """{'stage1'..'stage4': [B, V, H, W, C]} -> the same keys; view 0
        (the reference) runs first."""
        b, v = features["stage1"].shape[:2]
        outs = {k: [] for k in ("stage1", "stage2", "stage3", "stage4")}
        ref_list = None
        for vi in range(v):
            if vi == 0:
                ref_list = self.fmt.forward_ref(features["stage1"][:, 0])
                _, h, w, c = features["stage1"][:, 0].shape
                f1 = ref_list[-1].reshape(b, h, w, c)
            else:
                f1 = self.fmt.forward_src(ref_list, features["stage1"][:, vi])
            f2 = self.smooth_1(self._upsample_add(self.dim_reduction_1(f1),
                                                  features["stage2"][:, vi]))
            f3 = self.smooth_2(self._upsample_add(self.dim_reduction_2(f2),
                                                  features["stage3"][:, vi]))
            f4 = self.smooth_3(self._upsample_add(self.dim_reduction_3(f3),
                                                  features["stage4"][:, vi]))
            for k, f in zip(outs, (f1, f2, f3, f4)):
                outs[k].append(f)
        return {k: torch.stack(fs, dim=1) for k, fs in outs.items()}
