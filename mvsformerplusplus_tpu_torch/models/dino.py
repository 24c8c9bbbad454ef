"""DINOv2 ViT backbone with interval feature taps (counterpart of
mvsformerplusplus_tpu/models/dino.py): patch embed, pre-norm blocks with
LayerScale, bicubic pos-embed interpolation with torch's "+0.1" scale."""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import softmax_attention
from ..ops.resize import resize2d
from .blocks import Dense, norm_fp32
from .layers import Conv

Tensor = torch.Tensor


class DinoAttention(nn.Module):
    """Fused-qkv multi-head self attention with the plain d^-0.5 scale."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, True, dtype)
        self.proj = Dense(dim, dim, True, dtype)
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype

    def forward(self, x: Tensor) -> Tensor:
        b, n, c = x.shape
        dh = self.dim // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, dh).unbind(dim=2)
        out = softmax_attention(q, k, v, dh ** -0.5)
        return self.proj(out.reshape(b, n, c).to(self.dtype))


class DinoBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 init_values: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.ls1_gamma = nn.Parameter(torch.full((dim,), float(init_values)))
        self.ls2_gamma = nn.Parameter(torch.full((dim,), float(init_values)))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hid = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hid, True, dtype)
        self.mlp_fc2 = Dense(hid, dim, True, dtype)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        x = x + self.attn(norm_fp32(self.norm1, x, dt)) * self.ls1_gamma.to(dt)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(norm_fp32(self.norm2, x, dt))))
        return x + h * self.ls2_gamma.to(dt)


class DinoVisionTransformer(nn.Module):
    """imgs [B, H, W, 3] -> `cross_interval_layers` patch-token tensors
    [B, h0*w0, C]: taps every depth/cross_interval_layers blocks plus the
    final normed tokens."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 14, mlp_ratio: float = 4.0, init_values: float = 1.0,
                 pretrain_grid: int = 37, cross_interval_layers: int = 3, dtype=torch.float32):
        super().__init__()
        p = patch_size
        self.patch_embed = Conv(3, embed_dim, (p, p), p, 0, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, pretrain_grid * pretrain_grid + 1, embed_dim))
        for i in range(depth):
            setattr(self, f"blocks_{i}",
                    DinoBlock(embed_dim, num_heads, mlp_ratio, init_values, dtype))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.embed_dim, self.depth, self.patch_size = embed_dim, depth, patch_size
        self.grid, self.interval = pretrain_grid, depth // cross_interval_layers
        self.dtype = dtype

    def forward(self, imgs: Tensor) -> List[Tensor]:
        b, h, w, _ = imgs.shape
        h0, w0 = h // self.patch_size, w // self.patch_size
        c, g, dt = self.embed_dim, self.grid, self.dtype
        x = self.patch_embed(imgs).reshape(b, h0 * w0, c)
        patch_pe = self.pos_embed[:, 1:]
        if (h0, w0) != (g, g):
            patch_pe = resize2d(patch_pe.reshape(1, g, g, c), h0, w0, method="cubic",
                                align_corners=False, scale_h=(h0 + 0.1) / g,
                                scale_w=(w0 + 0.1) / g).reshape(1, h0 * w0, c)
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, c), x], dim=1)
        x = x + torch.cat([self.pos_embed[:, :1], patch_pe], dim=1).to(dt)
        feats = []
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
            if (i + 1) % self.interval == 0 and i != self.depth - 1:
                feats.append(x[:, 1:])
        feats.append(norm_fp32(self.norm, x, dt)[:, 1:])
        return feats
