"""Transformer blocks (counterpart of mvsformerplusplus_tpu/models/blocks.py):
attention wrapper, FFN, LayerScale, CrossBlock and FlashAttnBlock over
[B, L, C] token streams."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import entropy_inv_scale, linear_attention, softmax_attention

Tensor = torch.Tensor


class Dense(nn.Module):
    """flax nn.Dense: weight [out, in]; computes in `dtype`."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f)) if bias else None
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


def norm_fp32(norm: nn.LayerNorm, x: Tensor, dtype) -> Tensor:
    return norm(x.float()).to(dtype)


class MultiHeadAttention(nn.Module):
    """q/k/v projections + 'linear' (fp32 elu+1) or 'softmax' attention."""

    def __init__(self, dim: int, num_heads: int, variant: str = "softmax",
                 qkv_bias: bool = False, proj_bias: bool = True,
                 softmax_scale: Optional[str] = None, train_avg_length: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        if variant not in ("linear", "softmax"):
            raise ValueError(f"unknown attention variant {variant}")
        self.q_proj = Dense(dim, dim, qkv_bias, dtype)
        self.k_proj = Dense(dim, dim, qkv_bias, dtype)
        self.v_proj = Dense(dim, dim, qkv_bias, dtype)
        self.proj = Dense(dim, dim, proj_bias, dtype)
        self.dim, self.num_heads, self.variant = dim, num_heads, variant
        self.avg = train_avg_length if softmax_scale == "entropy_invariance" else None
        self.dtype = dtype

    def forward(self, x: Tensor, key: Optional[Tensor] = None,
                value: Optional[Tensor] = None) -> Tensor:
        b, n, _ = x.shape
        key = x if key is None else key
        value = key if value is None else value
        dh = self.dim // self.num_heads
        q = self.q_proj(x).reshape(b, n, self.num_heads, dh)
        k = self.k_proj(key).reshape(b, key.shape[1], self.num_heads, dh)
        v = self.v_proj(value).reshape(b, value.shape[1], self.num_heads, dh)
        if self.variant == "linear":
            out = linear_attention(q, k, v)
        else:
            out = softmax_attention(q, k, v, entropy_inv_scale(dh, n, self.avg))
        return self.proj(out.reshape(b, n, self.dim).to(self.dtype))


class Mlp(nn.Module):
    """Dense-GELU-Dense FFN."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, bias, dtype)
        self.Dense_1 = Dense(hidden, out or dim, bias, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class SwiGLU(nn.Module):
    """SwiGLU FFN: Dense to 2h, split, silu(x1) * x2, Dense back, with the
    hidden width h = 2/3 of `hidden` rounded up to a multiple of 8."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        h = (int(hidden * 2 / 3) + 7) // 8 * 8
        self.Dense_0 = Dense(dim, 2 * h, bias, dtype)
        self.Dense_1 = Dense(h, out or dim, bias, dtype)

    def forward(self, x: Tensor) -> Tensor:
        x1, x2 = self.Dense_0(x).chunk(2, dim=-1)
        return self.Dense_1(F.silu(x1) * x2)


class LayerScale(nn.Module):
    """Per-channel residual scale, applied in fp32."""

    def __init__(self, dim: int, init_value: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return (x.float() * self.gamma).to(self.dtype)


class CrossBlock(nn.Module):
    """Pre/post-norm transformer block with optional cross-attention;
    pre_norm_query=False also norms key/value with norm1. `ffn_type` "ffn"
    is the GELU Mlp, any other value SwiGLU, as in the JAX CrossBlock."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 variant: str = "softmax", qkv_bias: bool = False, ffn_type: str = "ffn",
                 init_values: Optional[float] = 1.0, softmax_scale: Optional[str] = None,
                 train_avg_length: Optional[int] = None, post_norm: bool = False,
                 pre_norm_query: bool = True, dtype=torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads, variant, qkv_bias,
                                       softmax_scale=softmax_scale,
                                       train_avg_length=train_avg_length, dtype=dtype)
        ffn = Mlp if ffn_type == "ffn" else SwiGLU
        self.mlp = ffn(dim, int(dim * mlp_ratio), dtype=dtype)
        self.has_ls = init_values is not None
        if self.has_ls:
            self.ls1 = LayerScale(dim, init_values, dtype)
            self.ls2 = LayerScale(dim, init_values, dtype)
        self.post_norm, self.pre_norm_query = post_norm, pre_norm_query
        self.dtype = dtype

    def _ls(self, i: int, x: Tensor) -> Tensor:
        return getattr(self, f"ls{i}")(x) if self.has_ls else x

    def forward(self, x: Tensor, key: Optional[Tensor] = None,
                value: Optional[Tensor] = None) -> Tensor:
        dt = self.dtype
        x = x.to(dt)
        if self.post_norm:
            x = norm_fp32(self.norm1, x + self._ls(1, self.attn(x, key, value)), dt)
            return norm_fp32(self.norm2, x + self._ls(2, self.mlp(x)), dt)
        if not self.pre_norm_query:
            key = norm_fp32(self.norm1, key, dt) if key is not None else None
            value = norm_fp32(self.norm1, value, dt) if value is not None else None
        x = x + self._ls(1, self.attn(norm_fp32(self.norm1, x, dt), key, value))
        return x + self._ls(2, self.mlp(norm_fp32(self.norm2, x, dt)))


class FlashAttnBlock(nn.Module):
    """Cost-volume transformer block with scalar residual gammas, post-norm
    by default."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 variant: str = "softmax", init_values: float = 1.0,
                 softmax_scale: Optional[str] = None, train_avg_length: Optional[int] = None,
                 post_norm: bool = True, dtype=torch.float32):
        super().__init__()
        self.attn = MultiHeadAttention(dim, num_heads, variant, softmax_scale=softmax_scale,
                                       train_avg_length=train_avg_length, dtype=dtype)
        self.ffn = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.gamma1 = nn.Parameter(torch.tensor(float(init_values)))
        self.gamma2 = nn.Parameter(torch.tensor(float(init_values)))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.post_norm = post_norm
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        x = x.to(dt)
        g1, g2 = self.gamma1.to(dt), self.gamma2.to(dt)
        if self.post_norm:
            x = norm_fp32(self.norm1, x + g1 * self.attn(x), dt)
            return norm_fp32(self.norm2, x + g2 * self.ffn(x), dt)
        x = x + g1 * self.attn(norm_fp32(self.norm1, x, dt))
        return x + g2 * self.ffn(norm_fp32(self.norm2, x, dt))
