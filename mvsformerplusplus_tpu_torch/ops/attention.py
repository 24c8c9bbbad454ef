"""Attention primitives (counterpart of mvsformerplusplus_tpu/ops/attention.py):
entropy-invariant softmax scale, fp32 linear attention, and softmax
attention, which on CUDA tensors always runs the flash kernels (forward, and
in a backward the dK/dV and dQ kernels)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda.flash_attention import FlashAttention

Tensor = torch.Tensor


def entropy_inv_scale(head_dim: int, seq_len: int, train_avg_length: Optional[int]) -> float:
    """d^-0.5 · log_{train_avg_length}(seq_len) when configured, else d^-0.5."""
    scale = head_dim ** -0.5
    if train_avg_length is not None and seq_len > 1:
        scale *= math.log(seq_len, train_avg_length)
    return scale


def linear_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """elu(+1) linear attention in fp32. q/k/v [B, N, H, Dh] -> [B, N, H, Dh] f32."""
    q = F.elu(q.float()) + 1
    k = F.elu(k.float()) + 1
    v = v.float()
    kv = torch.einsum("bshd,bshm->bhmd", k, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(dim=1)) + 1e-6)
    return torch.einsum("blhd,bhmd,blh->blhm", q, kv, z)


def softmax_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """Softmax attention, q [B, N, H, Dh], k/v [B, M, H, Dh], fp32 logits;
    differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, scale)
