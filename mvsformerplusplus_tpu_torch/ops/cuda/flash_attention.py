"""Non-causal flash attention forward (csrc/flash_attention.cu).

Replaces the Pallas kernel mvsformerplusplus_tpu/ops/pallas/flash_attention.py
`_flash_fwd` (`_fwd_kernel` / `_fwd_kernel_nolse`, reached from
`flash_attention`): online-softmax attention with fp32 logits, the softmax
scale folded into q, and an optional row logsumexp for a later backward.

Bound on the H100: at head_dim 64 (the ViT) the Q·Kᵀ and P·V products; at
head_dim 16 (the CTA cost regularizer, ~27.6k tokens) the N·M exponentials,
which run on the SFUs, not the tensor cores. This first kernel computes both
products with fp32 FMAs: one thread owns one query row (q and the output
accumulator in registers), the block's 128 rows share each key/value tile
staged in shared memory (read as broadcasts), and keys are folded into the
running max/normalizer 16 at a time so the rescale exp runs once per chunk.
"""
from __future__ import annotations

import ctypes

import torch

from . import check, dtype_code, load, ptr, stream

Tensor = torch.Tensor

HEAD_DIMS = (16, 64)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float,
                          return_lse: bool = False, chunk: int = 4096):
    """q [B, N, H, Dh], k/v [B, M, H, Dh] -> out [B, N, H, Dh] in q's dtype
    (and lse [B, H, N] f32). fp32 logits and softmax; queries are processed
    `chunk` rows at a time so the [N, M] scores never materialize whole."""
    qf = q.float().transpose(1, 2) * scale  # [B, H, N, Dh]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    outs, lses = [], []
    for s in range(0, qf.shape[2], chunk):
        logits = qf[:, :, s:s + chunk] @ kf.transpose(-1, -2)
        lse = torch.logsumexp(logits, dim=-1)
        outs.append(torch.exp(logits - lse[..., None]) @ vf)
        lses.append(lse)
    out = torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float,
                        return_lse: bool = False):
    """Flash attention forward. q [B, N, H, Dh], k/v [B, M, H, Dh] (bf16|f32,
    Dh in {16, 64}) -> out [B, N, H, Dh] in q's dtype (and lse [B, H, N]
    f32). CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale, return_lse)
    b, n, h, dh = q.shape
    m = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {dh}")
    if k.shape != (b, m, h, dh) or v.shape != k.shape or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v mismatch: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device) if return_lse else None
    lib = load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p])
    fn.restype = ctypes.c_int
    check(fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse) if lse is not None else None,
             b, n, m, h, dh, float(scale), dtype_code(q), stream()), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
