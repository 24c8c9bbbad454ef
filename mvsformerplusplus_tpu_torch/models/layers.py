"""Conv/norm building blocks and the FPN pyramid over channel-last tensors
(counterpart of mvsformerplusplus_tpu/models/layers.py).

Submodules carry the flax module names (Conv_0, BatchNorm_0, ConvBlock_3,
...) so `convert.from_jax_variables` maps a flax tree onto the state_dict
by path. Parameters stay fp32; compute casts them to the module's `dtype`
at use, as flax does. Norms compute in fp32.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.conv2d import Conv2dSame
from ..ops.resize import resize2d

Tensor = torch.Tensor


def sym_pad(ks) -> tuple:
    """Symmetric torch-style padding (k-1)//2 per axis (not XLA 'SAME',
    which pads strided convs asymmetrically)."""
    return tuple((k - 1) // 2 for k in ks)


def deconv_pad(ks, strides, padding=None, output_padding=None) -> tuple:
    """(padding, output_padding) per axis of the torch transposed conv that the
    flax ConvTranspose with explicit pads (k-1-p, k-1-p+op) reproduces; the
    defaults are the 3D U-Nets' p=(k-1)//2, op=s-1."""
    p = tuple(padding) if padding is not None else tuple((k - 1) // 2 for k in ks)
    op = tuple(output_padding) if output_padding is not None else tuple(s - 1 for s in strides)
    return p, op


def _tuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """Inside it, the train-mode BatchNorms of `module` normalize with batch
    statistics but leave their running statistics alone: a checkpointed
    block's recompute in the backward must not apply the running update a
    second time (flax applies it once)."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm1d)]
    for bn in bns:
        bn.stats_frozen = True
    try:
        yield
    finally:
        for bn in bns:
            bn.stats_frozen = False


def remat(fn: nn.Module, *args):
    """fn(*args) under gradient checkpointing when autograd records: the
    activations inside are recomputed in the backward, with the running
    BatchNorm statistics frozen for the replay. Without autograd recording
    it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), frozen_batch_stats(fn)))


def batch_norm(bn: nn.BatchNorm1d, x: Tensor) -> Tensor:
    """BatchNorm over the last (channel) axis in fp32, as flax's BatchNorm
    (momentum 0.9, eps 1e-5): (x - mean) * (rsqrt(var + eps) * scale) + bias.
    In train mode mean and var are the batch statistics, var by flax's
    E[x²] - E[x]² (clipped at 0), the gradient flows through both, and the
    running mean and the running BIASED variance (torch's BatchNorm would
    keep the unbiased one) move 0.1 of the way towards them; in eval mode
    they are the running statistics."""
    xf = x.float().reshape(-1, x.shape[-1])
    if bn.training:
        mean = xf.mean(0)
        var = ((xf * xf).mean(0) - mean * mean).clamp(min=0)
        if not getattr(bn, "stats_frozen", False):
            with torch.no_grad():
                bn.running_mean.lerp_(mean, bn.momentum)
                bn.running_var.lerp_(var, bn.momentum)
                bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.reshape(x.shape)


def bn_layer(c: int) -> nn.BatchNorm1d:
    # flax BatchNorm(momentum=0.9) keeps 0.9 of the old statistic: torch 0.1
    return nn.BatchNorm1d(c, eps=1e-5, momentum=0.1)


class Conv(nn.Module):
    """flax nn.Conv over channel-last 2D/3D tensors: weight [out, in, *k],
    symmetric integer padding. Also serves the 1x1(x1) kernels the JAX
    package applies as einsums (`pointwise`)."""

    def __init__(self, in_ch: int, out_ch: int, ks: Sequence[int], stride=1, padding=0,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        nd = len(ks)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *ks))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = _tuple(stride, nd)
        self.padding = _tuple(padding, nd)
        self.dtype = dtype

    def _bias(self):
        return None if self.bias is None else self.bias.to(self.dtype)

    def forward(self, x: Tensor) -> Tensor:
        conv = F.conv2d if self.weight.ndim == 4 else F.conv3d
        y = conv(torch.movedim(x.to(self.dtype), -1, 1), self.weight.to(self.dtype),
                 self._bias(), self.stride, self.padding)
        return torch.movedim(y, 1, -1)

    def pointwise(self, x: Tensor) -> Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return F.linear(x.to(self.dtype), w.to(self.dtype), self._bias())


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose as a torch transposed conv over channel-last
    tensors: weight [in, out, *k] (spatially flipped from flax's kernel by the
    converter)."""

    def __init__(self, in_ch: int, out_ch: int, ks: Sequence[int], stride, padding=0,
                 output_padding=0, bias: bool = True, dtype=torch.float32):
        super().__init__()
        nd = len(ks)
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, *ks))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = _tuple(stride, nd)
        self.padding = _tuple(padding, nd)
        self.output_padding = _tuple(output_padding, nd)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        conv = F.conv_transpose2d if self.weight.ndim == 4 else F.conv_transpose3d
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = conv(torch.movedim(x.to(self.dtype), -1, 1), self.weight.to(self.dtype), bias,
                 self.stride, self.padding, self.output_padding)
        return torch.movedim(y, 1, -1)


def conv2d_mm(x: Tensor, kernel: Tensor, bias=None) -> Tensor:
    """Stride-1 'same' conv with kernel [ky, kx, Ci, Co], fp32 accumulation,
    output in x's dtype: 1x1 is a matmul, square k in {3, 5, 7} the
    differentiable conv kernel (its plain versions on CPU)."""
    if kernel.shape[0] == kernel.shape[1] == 1:
        out = x @ kernel[0, 0]
    else:
        out = Conv2dSame.apply(x, kernel)
    if bias is not None:
        out = out.float() + bias.float()
    return out.to(x.dtype)


class MMConv(nn.Module):
    """Stride-1 'same' conv module with nn.Conv's parameter tree, routed
    through conv2d_mm (the hand-written conv kernel for k in {3, 5, 7}; the
    TPU's channel split is a VMEM workaround and is not carried over)."""

    def __init__(self, in_ch: int, features: int, kernel_size: Tuple[int, int],
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        k = self.weight.permute(2, 3, 1, 0).to(self.dtype)  # [ky, kx, ci, co]
        return conv2d_mm(x.to(self.dtype), k, self.bias)


class ConvBlock(nn.Module):
    """Conv2d + BatchNorm + LeakyReLU(0.1); stride-1 convs go through MMConv."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1,
                 act: bool = True, dtype=torch.float32):
        super().__init__()
        ks = (kernel_size, kernel_size)
        if stride == 1:
            self.Conv_0 = MMConv(in_ch, features, ks, use_bias=False, dtype=dtype)
        else:
            self.Conv_0 = Conv(in_ch, features, ks, stride, sym_pad(ks), bias=False, dtype=dtype)
        self.BatchNorm_0 = bn_layer(features)
        self.act = act
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        x = batch_norm(self.BatchNorm_0, self.Conv_0(x))
        if self.act:
            x = F.leaky_relu(x, 0.1)
        return x.to(self.dtype)


class ConvBnReLU(nn.Module):
    """Conv2d + BatchNorm + ReLU (the visibility head)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        ks = (kernel_size, kernel_size)
        if stride == 1:
            self.Conv_0 = MMConv(in_ch, features, ks, use_bias=False, dtype=dtype)
        else:
            self.Conv_0 = Conv(in_ch, features, ks, stride, sym_pad(ks), bias=False, dtype=dtype)
        self.BatchNorm_0 = bn_layer(features)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(batch_norm(self.BatchNorm_0, self.Conv_0(x))).to(self.dtype)


class Conv3dBlock(nn.Module):
    """Conv3d + BatchNorm + ReLU over NDHWC volumes."""

    def __init__(self, in_ch: int, features: int, kernel_size: Union[int, tuple] = 3,
                 stride: Union[int, tuple] = 1, act: bool = True, dtype=torch.float32):
        super().__init__()
        ks = _tuple(kernel_size, 3)
        self.Conv_0 = Conv(in_ch, features, ks, _tuple(stride, 3), sym_pad(ks), bias=False,
                           dtype=dtype)
        self.BatchNorm_0 = bn_layer(features)
        self.act = act
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        x = batch_norm(self.BatchNorm_0, self.Conv_0(x))
        return (F.relu(x) if self.act else x).to(self.dtype)


class Deconv3dBlock(nn.Module):
    """ConvTranspose3d(k=3, padding 1, output_padding s-1) + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, features: int, kernel_size: Union[int, tuple] = 3,
                 stride: Union[int, tuple] = (1, 2, 2), act: bool = True, dtype=torch.float32):
        super().__init__()
        ks, st = _tuple(kernel_size, 3), _tuple(stride, 3)
        p, op = deconv_pad(ks, st)
        self.ConvTranspose_0 = ConvTranspose(in_ch, features, ks, st, p, op, bias=False,
                                             dtype=dtype)
        self.BatchNorm_0 = bn_layer(features)
        self.act = act
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        x = batch_norm(self.BatchNorm_0, self.ConvTranspose_0(x))
        return (F.relu(x) if self.act else x).to(self.dtype)


class FPNEncoder(nn.Module):
    """4-level conv pyramid 1/1 -> 1/8."""

    def __init__(self, feat_chs: Sequence[int] = (8, 16, 32, 64), dtype=torch.float32):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        spec = [(3, c0, 7, 1), (c0, c0, 5, 1), (c0, c1, 5, 2), (c1, c1, 3, 1), (c1, c1, 3, 1),
                (c1, c2, 5, 2), (c2, c2, 3, 1), (c2, c2, 3, 1), (c2, c3, 3, 2), (c3, c3, 3, 1),
                (c3, c3, 3, 1)]
        for i, (ci, co, k, s) in enumerate(spec):
            setattr(self, f"ConvBlock_{i}", ConvBlock(ci, co, k, s, dtype=dtype))

    def forward(self, x: Tensor):
        outs = []
        for i in range(11):
            x = getattr(self, f"ConvBlock_{i}")(x)
            if i in (1, 4, 7, 10):
                outs.append(x)
        return tuple(outs)  # conv01, conv11, conv21, conv31


class FPNDecoder(nn.Module):
    """Top-down pyramid with BN + Swish heads; bilinear align_corners=True
    upsampling. Conv_0..Conv_6 interleave heads and laterals as in flax."""

    def __init__(self, feat_chs: Sequence[int] = (8, 16, 32, 64), dtype=torch.float32):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        convs = [(c3, c3, 1), (c2, c3, 1), (c3, c2, 3), (c1, c3, 1), (c3, c1, 3), (c0, c3, 1),
                 (c3, c0, 3)]
        for i, (ci, co, k) in enumerate(convs):
            setattr(self, f"Conv_{i}", MMConv(ci, co, (k, k), dtype=dtype))
        for i, c in enumerate((c3, c2, c1, c0)):
            setattr(self, f"BatchNorm_{i}", bn_layer(c))
        self.dtype = dtype

    def _head(self, i: int, x: Tensor) -> Tensor:
        conv = getattr(self, f"Conv_{0 if i == 0 else 2 * i}")
        x = batch_norm(getattr(self, f"BatchNorm_{i}"), conv(x))
        return (x * torch.sigmoid(x)).to(self.dtype)

    def _up_add(self, i: int, x: Tensor, lateral: Tensor) -> Tensor:
        up = resize2d(x, lateral.shape[-3], lateral.shape[-2], method="linear",
                      align_corners=True)
        lat = getattr(self, f"Conv_{2 * i - 1}")(lateral)
        return up.to(self.dtype) + lat.to(self.dtype)

    def forward(self, conv01, conv11, conv21, conv31):
        intra = conv31
        outs = [self._head(0, intra)]
        for i, lateral in enumerate((conv21, conv11, conv01), start=1):
            intra = self._up_add(i, intra, lateral)
            outs.append(self._head(i, intra))
        return tuple(outs)


class LayerNorm3D(nn.Module):
    """LayerNorm over the channel axis of NDHWC volumes, fp32 statistics."""

    def __init__(self, c: int, epsilon: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.epsilon = epsilon
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(self.dtype)
