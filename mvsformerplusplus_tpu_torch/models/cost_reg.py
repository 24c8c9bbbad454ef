"""Cost-volume regularizers over NDHWC volumes (counterpart of
mvsformerplusplus_tpu/models/cost_reg.py, its unfolded `ndhwc` branch):
3D U-Nets (CostRegNet, CostRegNet3D with its optional uncertainty channel,
CostRegNet2D) and the pure-transformer (CTA) regularizer.

flax names the blocks in construction order, and in `A(B(x))` the outer A
is constructed first: Conv3dBlock_0 is the stride-1 conv applied AFTER the
strided Conv3dBlock_1, and so on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.pe import position_encoding_3d
from .blocks import FlashAttnBlock
from .layers import Conv, Conv3dBlock, ConvTranspose, Deconv3dBlock, LayerNorm3D

Tensor = torch.Tensor


class _UNet3D(nn.Module):
    """Shared 3-level 3D U-Net body; `stride` is (2, 2, 2) for CostRegNet and
    (1, 2, 2) for CostRegNet3D and CostRegNet2D, `kernel` that of the
    strided convs and the deconvs (3x3x3, or (1, 3, 3) for CostRegNet2D)."""

    def __init__(self, in_ch: int, bc: int, stride, dtype, kernel=3):
        super().__init__()
        chans = [(in_ch, bc * 2), (bc * 2, bc * 4), (bc * 4, bc * 8)]
        for lvl, (ci, co) in enumerate(chans):
            setattr(self, f"Conv3dBlock_{2 * lvl}", Conv3dBlock(co, co, dtype=dtype))
            setattr(self, f"Conv3dBlock_{2 * lvl + 1}",
                    Conv3dBlock(ci, co, kernel_size=kernel, stride=stride, dtype=dtype))
        for i, (ci, co) in enumerate([(bc * 8, bc * 4), (bc * 4, bc * 2), (bc * 2, bc)]):
            setattr(self, f"Deconv3dBlock_{i}", Deconv3dBlock(ci, co, kernel_size=kernel,
                                                              stride=stride, dtype=dtype))
        self.has_inner = in_ch != bc
        if self.has_inner:
            self.Conv_0 = Conv(in_ch, bc, (1, 1, 1), dtype=dtype)

    def body(self, x: Tensor) -> Tensor:
        conv0 = x
        conv2 = self.Conv3dBlock_0(self.Conv3dBlock_1(conv0))
        conv4 = self.Conv3dBlock_2(self.Conv3dBlock_3(conv2))
        y = self.Conv3dBlock_4(self.Conv3dBlock_5(conv4))
        y = conv4 + self.Deconv3dBlock_0(y)
        y = conv2 + self.Deconv3dBlock_1(y)
        up = self.Deconv3dBlock_2(y)
        inner = self.Conv_0.pointwise(conv0) if self.has_inner else conv0
        return inner + up

    def final_name(self) -> str:
        return "Conv_1" if self.has_inner else "Conv_0"


class CostRegNet(_UNet3D):
    """3D U-Net with stride 2 in (D, H, W) and a 3x3x3 probability conv."""

    def __init__(self, in_ch: int, base_channels: int, last_layer: bool = True,
                 dtype=torch.float32):
        super().__init__(in_ch, base_channels, (2, 2, 2), dtype)
        self.last_layer = last_layer
        if last_layer:
            self.add_module(self.final_name(),
                            Conv(base_channels, 1, (3, 3, 3), 1, 1, bias=False, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        y = self.body(x)
        return getattr(self, self.final_name())(y) if self.last_layer else y


class CostRegNet3D(_UNet3D):
    """3D U-Net with (H, W)-only strides and a 1x1x1 probability conv; with
    `log_var` the conv has a second output channel, the per-hypothesis
    log-variance."""

    def __init__(self, in_ch: int, base_channels: int, log_var: bool = False,
                 dtype=torch.float32):
        super().__init__(in_ch, base_channels, (1, 2, 2), dtype)
        self.add_module(self.final_name(),
                        Conv(base_channels, 2 if log_var else 1, (1, 1, 1), dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        return getattr(self, self.final_name()).pointwise(self.body(x))


class CostRegNet2D(_UNet3D):
    """U-Net whose strided convs and deconvs take (1, 3, 3) kernels at
    (1, 2, 2) strides (the stride-1 convs stay 3x3x3), the input (of
    `base_channels` channels) added to the last deconv's output, then a
    1x1x1 conv to one channel."""

    def __init__(self, base_channels: int, dtype=torch.float32):
        super().__init__(base_channels, base_channels, (1, 2, 2), dtype, kernel=(1, 3, 3))
        self.Conv_0 = Conv(base_channels, 1, (1, 1, 1), dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.Conv_0.pointwise(self.body(x))


class PureTransformerCostReg(nn.Module):
    """CTA: 3D-PE add + patchify conv + transformer blocks over (h, w, d)
    tokens (d fastest) + unpatchify transposed conv + 1x1x1 probability head."""

    def __init__(self, base_channel: int = 8, mid_channel: int = 64, num_heads: int = 4,
                 mlp_ratio: float = 4.0, layer_num: int = 6,
                 down_rate: Sequence[int] = (2, 4, 4), position_encoding: bool = True,
                 use_pe_proj: bool = True, softmax_scale: Optional[str] = "entropy_invariance",
                 train_avg_length: Optional[int] = 12185, init_values: float = 1.0,
                 in_ch: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        cb = base_channel
        c = in_ch or cb
        rd = tuple(down_rate)
        self.position_encoding, self.use_pe_proj = position_encoding, use_pe_proj
        if position_encoding and use_pe_proj:
            self.pe_proj = Conv(3 * cb, cb, (1, 1, 1), bias=False, dtype=dtype)
        self.down = Conv(c, mid_channel, rd, rd, 0, dtype=dtype)
        self.down_norm = LayerNorm3D(mid_channel, dtype=dtype)
        self.layer_num = layer_num
        for i in range(layer_num):
            setattr(self, f"block{i}", FlashAttnBlock(
                mid_channel, num_heads, mlp_ratio, "softmax", init_values, softmax_scale,
                train_avg_length, post_norm=True, dtype=dtype))
        self.up = ConvTranspose(mid_channel, cb, rd, rd, 0, 0, dtype=dtype)
        self.up_norm = LayerNorm3D(cb, dtype=dtype)
        self.prob = Conv(cb, 1, (1, 1, 1), dtype=dtype)
        self.cb, self.mid = cb, mid_channel
        self.dtype = dtype

    def forward(self, x: Tensor, position3d: Optional[Tensor] = None) -> Tensor:
        b, d, h, w, c = x.shape
        if position3d is not None and self.position_encoding:
            if self.use_pe_proj:
                pe = self.pe_proj.pointwise(position_encoding_3d(position3d, self.cb))
            else:
                pe = position_encoding_3d(position3d, c // 3).to(self.dtype)
            x = x + pe
        xc = self.down_norm(self.down(x))
        d2, h2, w2 = xc.shape[1:4]
        tokens = xc.permute(0, 2, 3, 1, 4).reshape(b, h2 * w2 * d2, self.mid)
        for i in range(self.layer_num):
            tokens = getattr(self, f"block{i}")(tokens)
        xv = tokens.reshape(b, h2, w2, d2, self.mid).permute(0, 3, 1, 2, 4)
        xv = self.up_norm(self.up(xv))
        return self.prob.pointwise(xv)
