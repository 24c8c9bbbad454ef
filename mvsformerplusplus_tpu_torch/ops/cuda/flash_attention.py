"""Non-causal flash attention forward (csrc/flash_attention.cu) and backward
(csrc/flash_attention_bwd.cu).

Replaces the Pallas kernels mvsformerplusplus_tpu/ops/pallas/flash_attention.py
`_flash_fwd` (`_fwd_kernel` / `_fwd_kernel_nolse`, reached from
`flash_attention`): online-softmax attention with fp32 logits, the softmax
scale folded into q, and an optional row logsumexp for a later backward; and
`_flash_bwd` (`_bwd_dkv_kernel`, `_bwd_dq_kernel`): the FA2 backward from the
saved logsumexp, with delta = rowsum(dO * O) computed outside the kernels.

Bound on the H100: at head_dim 64 (the ViT) the Q·Kᵀ and P·V products; at
head_dim 16 (the CTA cost regularizer, ~27.6k tokens) the N·M exponentials,
which run on the SFUs, not the tensor cores. This first kernel computes both
products with fp32 FMAs: one thread owns one query row (q and the output
accumulator in registers), the block's 128 rows share each key/value tile
staged in shared memory (read as broadcasts), and keys are folded into the
running max/normalizer 16 at a time so the rescale exp runs once per chunk.
The backward splits as the TPU's does: a dK/dV kernel with one key row per
thread streaming query tiles, and a dQ kernel with one query row per thread
streaming key tiles; each rebuilds the probabilities from the logsumexp.
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


def _bwd_plain(q, k, v, dout, lse, delta, scale, want_dq, want_dkv, chunk=4096):
    """The FA2 backward in fp32, `chunk` query rows at a time, probabilities
    rebuilt from lse: returns dq (or None) and dk, dv (or None) in [B, ., H,
    Dh] and the input dtype."""
    qf = q.float().transpose(1, 2) * scale  # [B, H, N, Dh]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    dqs, dk, dv = [], torch.zeros_like(kf), torch.zeros_like(vf)
    for s in range(0, qf.shape[2], chunk):
        qs, do = qf[:, :, s:s + chunk], dof[:, :, s:s + chunk]
        p = torch.exp(qs @ kf.transpose(-1, -2) - lse[:, :, s:s + chunk, None])
        ds = p * (do @ vf.transpose(-1, -2) - delta[:, :, s:s + chunk, None])
        if want_dq:
            dqs.append(ds @ kf * scale)
        if want_dkv:
            dv += p.transpose(-1, -2) @ do
            dk += ds.transpose(-1, -2) @ qs
    dq = torch.cat(dqs, dim=2).transpose(1, 2).to(q.dtype) if want_dq else None
    dkv = ((dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)) if want_dkv
           else None)
    return dq, dkv


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale):
    """Plain version of the dK/dV kernel: (dk, dv) [B, M, H, Dh]."""
    return _bwd_plain(q, k, v, dout, lse, delta, scale, False, True)[1]


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale):
    """Plain version of the dQ kernel: dq [B, N, H, Dh] (w.r.t. unscaled q)."""
    return _bwd_plain(q, k, v, dout, lse, delta, scale, True, False)[0]


def attention_delta(out: Tensor, dout: Tensor) -> Tensor:
    """delta = rowsum(dO * O) in fp32, [B, N, H, Dh] -> [B, H, N]."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale):
    """The whole backward in plain PyTorch: (dq, dk, dv) in the input dtype,
    dq with respect to the unscaled q."""
    dq, (dk, dv) = _bwd_plain(q, k, v, dout, lse, attention_delta(out, dout), scale, True, True)
    return dq, dk, dv


def _check_qkv(q: Tensor, k: Tensor, v: Tensor) -> None:
    b, n, h, dh = q.shape
    m = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {dh}")
    if k.shape != (b, m, h, dh) or v.shape != k.shape or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v mismatch: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float,
                        return_lse: bool = False):
    """Flash attention forward. q [B, N, H, Dh], k/v [B, M, H, Dh] (bf16|f32,
    Dh in {16, 64}) -> out [B, N, H, Dh] in q's dtype (and lse [B, H, N]
    f32). CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale, return_lse)
    _check_qkv(q, k, v)
    b, n, h, dh = q.shape
    m = k.shape[1]
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


def _bwd_args(q, k, v, dout, lse, delta):
    _check_qkv(q, k, v)
    b, n, h, dh = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, n) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{b}, {h}, {n}], got {tuple(t.shape)} {t.dtype}")
    return [x.contiguous() for x in (q, k, v, dout, lse, delta)]


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale):
    """dK/dV kernel: q/dout [B, N, H, Dh], k/v [B, M, H, Dh] (bf16|f32), lse
    and delta [B, H, N] f32 -> (dk, dv) in the input dtype. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale)
    q, k, v, dout, lse, delta = _bwd_args(q, k, v, dout, lse, delta)
    b, n, h, dh = q.shape
    m = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = load("flash_attention_bwd").flash_attention_bwd_dkv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta), ptr(dk), ptr(dv),
             b, n, m, h, dh, float(scale), dtype_code(q), stream()), "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale):
    """dQ kernel (gradient with respect to the unscaled q): arguments as
    flash_attention_bwd_dkv -> dq [B, N, H, Dh] in the input dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    q, k, v, dout, lse, delta = _bwd_args(q, k, v, dout, lse, delta)
    b, n, h, dh = q.shape
    m = k.shape[1]
    dq = torch.empty_like(q)
    fn = load("flash_attention_bwd").flash_attention_bwd_dq
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta), ptr(dq),
             b, n, m, h, dh, float(scale), dtype_code(q), stream()), "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention. The forward keeps the logsumexp only
    when an input needs a gradient; the backward computes delta in fp32 and
    runs the dK/dV and dQ kernels (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
        ctx.scale = scale
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_fwd(q, k, v, scale)
        out, lse = flash_attention_fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout: Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = attention_delta(out, dout)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None
