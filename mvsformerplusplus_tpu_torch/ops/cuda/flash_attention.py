"""Non-causal flash attention forward (csrc/flash_attention.cu) and backward
(csrc/flash_attention_bwd.cu).

Replaces the Pallas kernels mvsformerplusplus_tpu/ops/pallas/flash_attention.py
`_flash_fwd` (`_fwd_kernel` / `_fwd_kernel_nolse`, reached from
`flash_attention`): online-softmax attention with fp32 logits and an
optional row logsumexp for a later backward; and `_flash_bwd`
(`_bwd_dkv_kernel`, `_bwd_dq_kernel`): the FA2 backward from the saved
logsumexp, with delta = rowsum(dO * O) computed outside the kernels.

Bound on the H100: at head_dim 64 (the ViT) the Q·Kᵀ and P·V products; at
head_dim 16 (the CTA cost regularizer, ~5-28k tokens) the N·M exponentials,
which run on the SFUs, not the tensor cores. The wrappers dispatch by dtype:

- bf16 runs the tensor-core kernels (`flash_fwd_mma_kernel`,
  `flash_bwd_mma_kernel`: mma.sync m16n8k16, FA2's online softmax in
  registers, P packed to bf16 as the A operand of P·V; the fused backward
  computes the exponentials once and adds dQ with f32 atomics);
- f32, which the fp32 model takes, runs both on the tf32 tensor cores at
  fp32 accuracy: each operand split into two tf32 parts and each product
  taken as three, small·big + big·small + big·big (3xTF32, mma.sync
  m16n8k8; P and dS are split too, never rounded to tf32 alone). The
  forward `flash_fwd_3xtf32_kernel` has the bf16 kernel's blocks and
  staging; the backward `flash_bwd_3xtf32_kernel` is the bf16 one's fused
  FA2 design, its dQ added with float2 atomics into an f32 output zeroed
  here and already scaled by the kernel.

The bf16 kernels round P (and in the backward dS) to bf16 before a product,
as the TPU kernel does (`p.astype(v.dtype)`), so they are held to their fp32
plain versions within a rounding budget (`budget_tolerance`), not within one
ulp of the output.

The kernels are instantiated at head dims 16, 32, 64 and 128 (`HEAD_DIMS`).
The wrappers take any head dim up to 128: they zero-pad q, k, v (and dout)
to the next instantiated width (`padded_head_dim`, `pad_head_dim`) and slice
the outputs and gradients back. Zero channels leave every q.k, so P and lse,
unchanged and give zero output and gradient columns; the scale stays the
caller's, computed from the true head dim. So padding adds no rounding. The
TPU kernel pads the head dim to its 128 lanes the same way.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import check, flops, load, ptr, stream

Tensor = torch.Tensor

HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are instantiated at
U_BF16 = 2.0 ** -8  # bf16's unit roundoff


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float,
                          return_lse: bool = False, chunk: int = 4096,
                          with_budget: bool = False):
    """q [B, N, H, Dh], k/v [B, M, H, Dh] -> out [B, N, H, Dh] in q's dtype
    (and lse [B, H, N] f32). fp32 logits and softmax; queries are processed
    `chunk` rows at a time so the [N, M] scores never materialize whole.

    with_budget: also return u·(softmax(S)·|V|) [B, N, H, Dh] f32, u = 2^-8:
    the most that rounding each probability to bf16 before P·V can move the
    output (the forward's term of `budget_tolerance`)."""
    qf = q.float().transpose(1, 2) * scale  # [B, H, N, Dh]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    outs, lses, budgets = [], [], []
    for s in range(0, qf.shape[2], chunk):
        logits = qf[:, :, s:s + chunk] @ kf.transpose(-1, -2)
        lse = torch.logsumexp(logits, dim=-1)
        p = torch.exp(logits - lse[..., None])
        outs.append(p @ vf)
        lses.append(lse)
        if with_budget:
            budgets.append(p @ vf.abs())
    out = (torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype),)
    if return_lse:
        out += (torch.cat(lses, dim=2),)
    if with_budget:
        out += (U_BF16 * torch.cat(budgets, dim=2).transpose(1, 2),)
    return out if len(out) > 1 else out[0]


def _bwd_plain(q, k, v, dout, lse, delta, scale, want_dq, want_dkv, chunk=4096,
               with_budget=False):
    """The FA2 backward in fp32, `chunk` query rows at a time, probabilities
    rebuilt from lse: returns dq (or None) and dk, dv (or None) in [B, ., H,
    Dh] and the input dtype. with_budget: also the rounding budgets (bq, bk,
    bv) in f32, computed in the same chunks: u·scale·(|dS|·|K|),
    u·scale·(|dS|ᵀ·|Q|) and u·(Pᵀ·|dO|), what rounding dS and P to bf16
    before the products can move dq, dk and dv."""
    qf = q.float().transpose(1, 2) * scale  # [B, H, N, Dh]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    dqs, dk, dv = [], torch.zeros_like(kf), torch.zeros_like(vf)
    bqs, bk, bv = [], torch.zeros_like(kf), torch.zeros_like(vf)
    for s in range(0, qf.shape[2], chunk):
        qs, do = qf[:, :, s:s + chunk], dof[:, :, s:s + chunk]
        p = torch.exp(qs @ kf.transpose(-1, -2) - lse[:, :, s:s + chunk, None])
        ds = p * (do @ vf.transpose(-1, -2) - delta[:, :, s:s + chunk, None])
        if want_dq:
            dqs.append(ds @ kf * scale)
        if want_dkv:
            dv += p.transpose(-1, -2) @ do
            dk += ds.transpose(-1, -2) @ qs
        if with_budget:
            bqs.append(ds.abs() @ kf.abs() * scale)
            bk += ds.abs().transpose(-1, -2) @ qs.abs()
            bv += p.transpose(-1, -2) @ do.abs()
    dq = torch.cat(dqs, dim=2).transpose(1, 2).to(q.dtype) if want_dq else None
    dkv = ((dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)) if want_dkv
           else None)
    if not with_budget:
        return dq, dkv
    budget = tuple(U_BF16 * x.transpose(1, 2) for x in (torch.cat(bqs, dim=2), bk, bv))
    return dq, dkv, budget


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale):
    """The plain backward's dK and dV alone (the TPU's dK/dV kernel's
    share): (dk, dv) [B, M, H, Dh]."""
    return _bwd_plain(q, k, v, dout, lse, delta, scale, False, True)[1]


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale):
    """The plain backward's dQ alone (the TPU's dQ kernel's share): dq [B, N,
    H, Dh] (w.r.t. unscaled q)."""
    return _bwd_plain(q, k, v, dout, lse, delta, scale, True, False)[0]


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, scale):
    """The whole backward in plain PyTorch: (dq, dk, dv) in the input dtype,
    dq with respect to the unscaled q."""
    dq, (dk, dv) = _bwd_plain(q, k, v, dout, lse, delta, scale, True, True)
    return dq, dk, dv


def flash_fwd_budget(q, k, v, scale) -> Tensor:
    """The forward's rounding budget u·(softmax(S)·|V|): f32, out's shape."""
    return flash_attention_plain(q, k, v, scale, with_budget=True)[1]


def flash_bwd_budget(q, k, v, dout, lse, delta, scale) -> tuple:
    """The backward's rounding budgets of (dq, dk, dv): f32, their shapes."""
    return _bwd_plain(q, k, v, dout, lse, delta, scale, False, False, with_budget=True)[2]


def budget_tolerance(want: Tensor, budget: Tensor) -> Tensor:
    """Element by element, how far a bf16 flash kernel's output may lie from
    its fp32 plain version's `want`: 2^-7|want| + 1e-5·max|want| (the output
    rounded once on each side, fp32 summation order: `ops.cuda.tolerance`)
    plus `budget`, the rounding of P (and dS) to bf16 before the products
    that the TPU kernel does too (flash_fwd_budget, flash_bwd_budget)."""
    w = want.float().abs()
    return 2 ** -7 * w + 1e-5 * w.max() + budget


def attention_delta(out: Tensor, dout: Tensor) -> Tensor:
    """delta = rowsum(dO * O) in fp32, [B, N, H, Dh] -> [B, H, N]."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def padded_head_dim(dh: int) -> int:
    """The kernel width a head dim runs at: the least of HEAD_DIMS >= dh."""
    for width in HEAD_DIMS:
        if dh <= width:
            return width
    raise ValueError(f"flash kernels take head dims up to {HEAD_DIMS[-1]}, got {dh}")


def pad_head_dim(x: Tensor, width: int) -> Tensor:
    """x [..., Dh] zero-padded to [..., width] (x itself when Dh == width)."""
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


def _check_qkv(q: Tensor, k: Tensor, v: Tensor) -> None:
    b, n, h, dh = q.shape
    m = k.shape[1]
    padded_head_dim(dh)  # raises above the widest kernel
    if k.shape != (b, m, h, dh) or v.shape != k.shape or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v mismatch: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if m < 1:
        raise ValueError("flash attention needs at least one key")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernels take bfloat16 or float32, got {q.dtype}")


def _aligned(x: Tensor, width: Optional[int] = None) -> Tensor:
    """x (padded to `width` channels where given) contiguous, starting on a
    16-byte boundary (the kernels' cp.async and vector loads need it)."""
    x = (x if width is None else pad_head_dim(x, width)).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _unpad(x: Tensor, dh: int) -> Tensor:
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


def _c_fn(lib: str, name: str, n_ptrs: int):
    """A C entry point (ptrs..., b, n, m, h, dh, scale, stream) -> cudaError."""
    fn = getattr(load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fwd_launch(entry: str, q: Tensor, k: Tensor, v: Tensor, scale: float, return_lse: bool):
    """One launch of the C entry point `entry` of csrc/flash_attention.cu on
    CUDA tensors at the padded head dim: out (and lse)."""
    _check_qkv(q, k, v)
    b, n, h, dh = q.shape
    m = k.shape[1]
    width = padded_head_dim(dh)
    q, k, v = (_aligned(x, width) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device) if return_lse else None
    fn = _c_fn("flash_attention", entry, 5)
    check(fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse) if lse is not None else None,
             b, n, m, h, width, float(scale), stream()), entry)
    out = _unpad(out, dh)
    return (out, lse) if return_lse else out


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float,
                        return_lse: bool = False):
    """Flash attention forward. q [B, N, H, Dh], k/v [B, M, H, Dh] (bf16|f32,
    Dh <= 128) -> out [B, N, H, Dh] in q's dtype (and lse [B, H, N] f32).
    CPU tensors take the plain version; CUDA tensors launch the bf16
    tensor-core kernel or the f32 3xTF32 one at the padded head dim."""
    with flops.kernel_call("flash_attention_fwd", flops.flash_fwd_products(q, k)):
        if not q.is_cuda:
            return flash_attention_plain(q, k, v, scale, return_lse)
        mma = q.dtype == torch.bfloat16
        res = _fwd_launch("flash_attention_fwd_mma" if mma else "flash_attention_fwd_f32",
                          q, k, v, scale, return_lse)
    if mma:
        flash_attention_fwd.launches_mma += 1
    else:
        flash_attention_fwd.launches_f32 += 1
    return res


def _bwd_args(q, k, v, dout, lse, delta):
    _check_qkv(q, k, v)
    b, n, h, dh = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, n) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{b}, {h}, {n}], got {tuple(t.shape)} {t.dtype}")
    width = padded_head_dim(dh)
    return [_aligned(x, width) for x in (q, k, v, dout)] + [_aligned(lse), _aligned(delta)]


def flash_attention_bwd(q, k, v, dout, lse, delta, scale):
    """The flash backward: q/dout [B, N, H, Dh], k/v [B, M, H, Dh] (bf16|f32,
    Dh <= 128), lse and delta [B, H, N] f32 -> (dq, dk, dv) in the input
    dtype, dq with respect to the unscaled q. CPU tensors take the plain
    version; on CUDA bf16 launches the fused tensor-core kernel (dQ summed in
    an f32 scratch, scaled and cast here) and f32 the fused 3xTF32 kernel
    (dQ summed and scaled in its f32 output)."""
    with flops.kernel_call("flash_attention_bwd", flops.flash_bwd_products(q, k)):
        if not q.is_cuda:
            return flash_attention_bwd_plain(q, k, v, dout, lse, delta, scale)
        return _bwd_launch(q, k, v, dout, lse, delta, scale)


def _bwd_launch(q, k, v, dout, lse, delta, scale):
    """flash_attention_bwd on CUDA tensors: one launch of the fused kernel
    for the dtype."""
    dh = q.shape[-1]
    q, k, v, dout, lse, delta = _bwd_args(q, k, v, dout, lse, delta)
    b, n, h, width = q.shape
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    mma = q.dtype == torch.bfloat16
    entry = "flash_attention_bwd_mma" if mma else "flash_attention_bwd_f32"
    fn = _c_fn("flash_attention_bwd", entry, 9)
    check(fn(ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta), ptr(dq_acc), ptr(dk),
             ptr(dv), b, n, k.shape[1], h, width, float(scale), stream()), entry)
    if not mma:
        flash_attention_bwd.launches_f32 += 1
        return _unpad(dq_acc, dh), _unpad(dk, dh), _unpad(dv, dh)
    flash_attention_bwd.launches_mma += 1
    # dq_acc's padded columns are the atomics' too: sliced off before the cast
    return (dq_acc[..., :dh] * scale).to(q.dtype), _unpad(dk, dh), _unpad(dv, dh)


flash_attention_fwd.launches_mma = 0
flash_attention_fwd.launches_f32 = 0
flash_attention_bwd.launches_mma = 0
flash_attention_bwd.launches_f32 = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention. The forward keeps the logsumexp only
    when an input needs a gradient; the backward computes delta in fp32 and
    runs flash_attention_bwd (its plain version on CPU tensors), returning
    gradients only for the inputs that need one."""

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
        grads = flash_attention_bwd(q, k, v, dout, lse, attention_delta(out, dout), ctx.scale)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad)) + (None,)
