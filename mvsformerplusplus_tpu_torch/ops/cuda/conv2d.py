"""Stride-1 "same" zero-padded odd-k 2D conv, NHWC (csrc/conv2d.cu), and its
gradients.

Replaces the Pallas kernel mvsformerplusplus_tpu/ops/pallas/conv2d.py
`_conv2d_fwd_impl` (`_kernel`, reached from `conv2d_p`): k in {3, 5, 7}, fp32
accumulation, output in the input dtype, no bias (MMConv adds it outside);
and `_conv2d_bwd`, whose input gradient is the same kernel applied to the
cotangent with the weights flipped in space and ci/co swapped
(`conv2d_same_dx`), and whose weight gradient is a per-tap fp32 reduction
that the JAX package leaves to XLA (here torch matmuls).

Bound on the H100: memory for the narrow-channel full-resolution convs of
the FPN, the visibility heads and the FMT smoothing (the decoder's 64->8 head
at 5x1152x1536 moves ~1.3 GB), arithmetic only for the widest 3x3s. Design:
a block computes an 8x32 tile of output pixels for up to 32 output channels;
it stages the input halo tile for 8 input channels at a time ([ci][y][x]
in shared memory, so neighbouring threads read neighbouring words) and the
matching weights (read as broadcasts), and each thread accumulates its
pixel's outputs in registers. The TPU kernel's W-folding and VMEM-driven
channel split answer TPU limits and are not carried over.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import check, dtype_code, load, ptr, stream

Tensor = torch.Tensor

KERNEL_SIZES = (3, 5, 7)


def conv2d_same_plain(x: Tensor, kernel: Tensor) -> Tensor:
    """x [B, H, W, Ci], kernel [ky, kx, Ci, Co] -> [B, H, W, Co] in x's dtype,
    as ky*kx shifted matmuls with fp32 accumulation."""
    ky, kx, ci, co = kernel.shape
    b, h, w, _ = x.shape
    py, px = (ky - 1) // 2, (kx - 1) // 2
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    kf = kernel.float()
    out = torch.zeros(b, h, w, co, dtype=torch.float32, device=x.device)
    for dy in range(ky):
        for dx in range(kx):
            out += xp[:, dy:dy + h, dx:dx + w] @ kf[dy, dx]
    return out.to(x.dtype)


def dx_kernel(kernel: Tensor) -> Tensor:
    """The weights of the input gradient: flipped in space, ci/co swapped."""
    return kernel.flip(0, 1).transpose(2, 3)


def conv2d_same_dx_plain(g: Tensor, kernel: Tensor) -> Tensor:
    """Input gradient of conv2d_same: g [B, H, W, Co] -> [B, H, W, Ci] in g's
    dtype."""
    return conv2d_same_plain(g, dx_kernel(kernel))


def conv2d_same_dk(x: Tensor, g: Tensor, ky: int, kx: int) -> Tensor:
    """Weight gradient [ky, kx, Ci, Co] f32: per tap, the fp32 product of the
    shifted input and the cotangent summed over batch and pixels (the JAX
    package's XLA einsum, here torch matmuls)."""
    b, h, w, ci = x.shape
    co = g.shape[-1]
    py, px = (ky - 1) // 2, (kx - 1) // 2
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    gf = g.float().reshape(-1, co)
    taps = [[xp[:, dy:dy + h, dx:dx + w].reshape(-1, ci).t() @ gf for dx in range(kx)]
            for dy in range(ky)]
    return torch.stack([torch.stack(row) for row in taps])


def _check_conv(x: Tensor, kernel: Tensor) -> None:
    ky, kx, ci, _ = kernel.shape
    if ky != kx or ky not in KERNEL_SIZES or x.shape[-1] != ci:
        raise ValueError(f"conv kernel takes square k in {KERNEL_SIZES} with matching Ci, "
                         f"got x {tuple(x.shape)} kernel {tuple(kernel.shape)}")


def _launch(x: Tensor, kernel: Tensor, what: str) -> Tensor:
    ky, _, ci, co = kernel.shape
    x = x.contiguous()
    kernel = kernel.to(x.dtype).contiguous()
    b, h, w, _ = x.shape
    out = torch.empty(b, h, w, co, dtype=x.dtype, device=x.device)
    fn = load("conv2d").conv2d_same
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ptr(x), ptr(kernel), ptr(out), b, h, w, ci, co, ky, dtype_code(x), stream()), what)
    return out


def conv2d_same(x: Tensor, kernel: Tensor) -> Tensor:
    """Odd-k stride-1 'same' conv. x [B, H, W, Ci] bf16|f32, kernel
    [k, k, Ci, Co] (cast to x's dtype) -> [B, H, W, Co]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return conv2d_same_plain(x, kernel)
    _check_conv(x, kernel)
    out = _launch(x, kernel, "conv2d_same")
    conv2d_same.launches += 1
    return out


def conv2d_same_dx(g: Tensor, kernel: Tensor) -> Tensor:
    """Input gradient of conv2d_same, g [B, H, W, Co] -> [B, H, W, Ci] in g's
    dtype: the same conv kernel launched with dx_kernel(kernel). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    kt = dx_kernel(kernel)
    if not g.is_cuda:
        return conv2d_same_plain(g, kt)
    _check_conv(g, kt)
    out = _launch(g, kt, "conv2d_same_dx")
    conv2d_same_dx.launches += 1
    return out


conv2d_same.launches = 0
conv2d_same_dx.launches = 0


class Conv2dSame(torch.autograd.Function):
    """Differentiable conv2d_same. dx (conv2d_same_dx) only when the input
    needs a gradient: the encoder's 7x7 conv on the images and each stage's
    first visibility conv on the detached entropy do not. dK in the kernel's
    dtype, as the JAX package returns it."""

    @staticmethod
    def forward(ctx, x: Tensor, kernel: Tensor) -> Tensor:
        ctx.save_for_backward(x, kernel)
        return conv2d_same(x, kernel)

    @staticmethod
    def backward(ctx, g: Tensor):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = conv2d_same_dx(g, kernel) if ctx.needs_input_grad[0] else None
        dk = None
        if ctx.needs_input_grad[1]:
            dk = conv2d_same_dk(x, g, kernel.shape[0], kernel.shape[1]).to(kernel.dtype)
        return dx, dk
