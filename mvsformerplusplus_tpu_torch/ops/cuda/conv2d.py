"""Stride-1 "same" zero-padded odd-k 2D conv, NHWC (csrc/conv2d.cu).

Replaces the Pallas kernel mvsformerplusplus_tpu/ops/pallas/conv2d.py
`_conv2d_fwd_impl` (`_kernel`, reached from `conv2d_p`): k in {3, 5, 7}, fp32
accumulation, output in the input dtype, no bias (MMConv adds it outside).

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


def conv2d_same(x: Tensor, kernel: Tensor) -> Tensor:
    """Odd-k stride-1 'same' conv. x [B, H, W, Ci] bf16|f32, kernel
    [k, k, Ci, Co] (cast to x's dtype) -> [B, H, W, Co]. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return conv2d_same_plain(x, kernel)
    ky, kx, ci, co = kernel.shape
    if ky != kx or ky not in KERNEL_SIZES or x.shape[-1] != ci:
        raise ValueError(f"conv kernel takes square k in {KERNEL_SIZES} with matching Ci, "
                         f"got x {tuple(x.shape)} kernel {tuple(kernel.shape)}")
    x = x.contiguous()
    kernel = kernel.to(x.dtype).contiguous()
    b, h, w, _ = x.shape
    out = torch.empty(b, h, w, co, dtype=x.dtype, device=x.device)
    lib = load("conv2d")
    fn = lib.conv2d_same
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(fn(ptr(x), ptr(kernel), ptr(out), b, h, w, ci, co, ky, dtype_code(x), stream()),
          "conv2d_same")
    conv2d_same.launches += 1
    return out


conv2d_same.launches = 0
