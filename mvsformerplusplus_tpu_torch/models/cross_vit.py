"""CrossVITDecoder, side-view attention over multi-level ViT tokens
(counterpart of mvsformerplusplus_tpu/models/cross_vit.py): a self-attention
chain on the reference view with learnable prev_value blending, cross
attention of each source view against it, then a 3x3 projection and two x2
transposed-conv upsamplers."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import CrossBlock, norm_fp32
from .layers import Conv, ConvTranspose, batch_norm, bn_layer

Tensor = torch.Tensor


class CrossVITDecoder(nn.Module):
    def __init__(self, d_model: int = 768, nhead: int = 12, cross_interval_layers: int = 3,
                 variant: str = "linear", ffn_type: str = "ffn",
                 init_values: Optional[float] = 1.0, prev_values: float = 0.5,
                 softmax_scale: Optional[str] = "entropy_invariance",
                 train_avg_length: Optional[int] = 762, post_norm: bool = False,
                 pre_norm_query: bool = True, no_combine_norm: bool = False, out_ch: int = 64,
                 dtype=torch.float32):
        super().__init__()
        n_self = cross_interval_layers - 1

        def blk():
            return CrossBlock(d_model, nhead, variant=variant, ffn_type=ffn_type,
                              init_values=init_values, softmax_scale=softmax_scale,
                              train_avg_length=train_avg_length, post_norm=post_norm,
                              pre_norm_query=pre_norm_query, dtype=dtype)

        for i in range(n_self):
            setattr(self, f"self_attn_{i}", blk())
            if not no_combine_norm:
                setattr(self, f"combine_norm_{i}", nn.LayerNorm(d_model, eps=1e-6))
            setattr(self, f"prev_value_{i}", nn.Parameter(torch.tensor(float(prev_values))))
        for i in range(cross_interval_layers):
            setattr(self, f"cross_attn_{i}", blk())
        ch = out_ch
        self.proj = Conv(d_model, ch * 4, (3, 3), 1, 1, dtype=dtype)
        self.proj_bn = bn_layer(ch * 4)
        # torch ConvTranspose2d(4, stride=2, padding=1) semantics
        self.up0 = ConvTranspose(ch * 4, ch * 2, (4, 4), 2, 1, 0, dtype=dtype)
        self.up0_bn = bn_layer(ch * 2)
        self.up1 = ConvTranspose(ch * 2, ch, (4, 4), 2, 1, 0, dtype=dtype)
        self.up1_bn = bn_layer(ch)
        self.n_self, self.n_cross = n_self, cross_interval_layers
        self.no_combine_norm, self.out_ch, self.dtype = no_combine_norm, out_ch, dtype

    def _combine(self, i: int, prev_feat: Tensor, level_tokens: Tensor) -> Tensor:
        x = getattr(self, f"prev_value_{i}").to(self.dtype) * prev_feat + level_tokens
        if not self.no_combine_norm:
            x = norm_fp32(getattr(self, f"combine_norm_{i}"), x, self.dtype)
        return x

    def forward(self, levels: Sequence[Tensor], vit_shape) -> Tensor:
        """levels: [B, V, HW, C] tokens per tapped level; vit_shape (B, V, h, w,
        C) -> [B, V, 4h, 4w, out_ch]."""
        b, v, h, w, c = vit_shape
        dt = self.dtype
        ref_feats = [levels[0][:, 0].to(dt)]
        for i in range(self.n_self):
            pre = getattr(self, f"self_attn_{i}")(ref_feats[-1])
            ref_feats.append(self._combine(i, pre, levels[i + 1][:, 0].to(dt)))
        src_outs = []
        for vi in range(1, v):
            src = None
            for i in range(self.n_cross):
                query = (levels[0][:, vi].to(dt) if i == 0
                         else self._combine(i - 1, src, levels[i][:, vi].to(dt)))
                src = getattr(self, f"cross_attn_{i}")(query, key=ref_feats[i], value=ref_feats[i])
            src_outs.append(src)
        x = torch.stack([ref_feats[-1]] + src_outs, dim=1).reshape(b * v, h, w, c)
        for conv, bn in ((self.proj, self.proj_bn), (self.up0, self.up0_bn),
                         (self.up1, self.up1_bn)):
            x = F.silu(batch_norm(bn, conv(x))).to(dt)
        return x.reshape(b, v, 4 * h, 4 * w, self.out_ch)
