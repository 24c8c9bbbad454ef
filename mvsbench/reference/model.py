"""Plain float32 reference of the benchmarked model, DINOv2MVSNet
(MVSFormer++), in eval mode over channel-last tensors: the FPN, the frozen
DINOv2 ViT with its cross-view decoder, the FMT with its pathway, and the
4-stage cascade (plane-sweep volume with visibility weights, CTA or 3D U-Net
regularizer, depth and confidence heads). Its module and parameter names
equal the program's, so one state dict loads into both; it computes every
step in float32 (products at `ops.PRECISION`), with no checkpointing, no
sharding and no kernel of its own. Built by `build(arch_args)` from a
configuration's `arch.args`.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops
from .ops import q

Tensor = torch.Tensor


# ------------------------------------------------------------------ layers

def batch_norm(bn: nn.BatchNorm1d, x: Tensor) -> Tensor:
    """BatchNorm over the channel axis with its running statistics."""
    xf = x.float().reshape(-1, x.shape[-1])
    mean, var = bn.running_mean, bn.running_var
    return ((xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias).reshape(x.shape)


def bn_layer(c: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(c, eps=1e-5, momentum=0.1)


def _t(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class Conv(nn.Module):
    """Convolution over channel-last 2D/3D tensors, weight [out, in, *k]."""

    def __init__(self, ci, co, ks, stride=1, padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, *ks))
        self.bias = nn.Parameter(torch.zeros(co)) if bias else None
        self.stride, self.padding = _t(stride, len(ks)), _t(padding, len(ks))

    def forward(self, x):
        conv = F.conv2d if self.weight.ndim == 4 else F.conv3d
        y = conv(torch.movedim(q(x.float()), -1, 1), q(self.weight), self.bias, self.stride,
                 self.padding)
        ops.record_conv(x, self.weight, y, transposed=False)
        return torch.movedim(y, 1, -1)

    def pointwise(self, x):
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return F.linear(q(x.float()), q(w), self.bias)


class ConvTranspose(nn.Module):
    """Transposed convolution over channel-last tensors, weight [in, out, *k]."""

    def __init__(self, ci, co, ks, stride, padding=0, output_padding=0, bias=True):
        super().__init__()
        n = len(ks)
        self.weight = nn.Parameter(torch.empty(ci, co, *ks))
        self.bias = nn.Parameter(torch.zeros(co)) if bias else None
        self.stride, self.padding = _t(stride, n), _t(padding, n)
        self.output_padding = _t(output_padding, n)

    def forward(self, x):
        conv = F.conv_transpose2d if self.weight.ndim == 4 else F.conv_transpose3d
        y = conv(torch.movedim(q(x.float()), -1, 1), q(self.weight), self.bias, self.stride,
                 self.padding, self.output_padding)
        ops.record_conv(x, self.weight, y, transposed=True)
        return torch.movedim(y, 1, -1)


class MMConv(nn.Module):
    """Stride-1 'same' conv (1x1 as a matmul)."""

    def __init__(self, ci, co, ks, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(co, ci, *ks))
        self.bias = nn.Parameter(torch.zeros(co)) if use_bias else None

    def forward(self, x):
        if self.weight.shape[-1] == 1:
            y = q(x.float()) @ q(self.weight[:, :, 0, 0].t())
        else:
            y = ops.conv2d_same(x, self.weight)
        return y if self.bias is None else y + self.bias


class ConvBlock(nn.Module):
    """Conv + BatchNorm + LeakyReLU(0.1) (the FPN encoder's blocks)."""

    def __init__(self, ci, co, k=3, stride=1):
        super().__init__()
        ks = (k, k)
        if stride == 1:
            self.Conv_0 = MMConv(ci, co, ks, use_bias=False)
        else:
            self.Conv_0 = Conv(ci, co, ks, stride, (k - 1) // 2, bias=False)
        self.BatchNorm_0 = bn_layer(co)

    def forward(self, x):
        return F.leaky_relu(batch_norm(self.BatchNorm_0, self.Conv_0(x)), 0.1)


class ConvBnReLU(nn.Module):
    def __init__(self, ci, co, k=3):
        super().__init__()
        self.Conv_0 = MMConv(ci, co, (k, k), use_bias=False)
        self.BatchNorm_0 = bn_layer(co)

    def forward(self, x):
        return F.relu(batch_norm(self.BatchNorm_0, self.Conv_0(x)))


class Conv3dBlock(nn.Module):
    def __init__(self, ci, co, kernel_size=3, stride=1):
        super().__init__()
        ks = _t(kernel_size, 3)
        self.Conv_0 = Conv(ci, co, ks, _t(stride, 3), tuple((k - 1) // 2 for k in ks), bias=False)
        self.BatchNorm_0 = bn_layer(co)

    def forward(self, x):
        return F.relu(batch_norm(self.BatchNorm_0, self.Conv_0(x)))


class Deconv3dBlock(nn.Module):
    def __init__(self, ci, co, kernel_size=3, stride=(1, 2, 2)):
        super().__init__()
        ks, st = _t(kernel_size, 3), _t(stride, 3)
        self.ConvTranspose_0 = ConvTranspose(ci, co, ks, st, tuple((k - 1) // 2 for k in ks),
                                             tuple(s - 1 for s in st), bias=False)
        self.BatchNorm_0 = bn_layer(co)

    def forward(self, x):
        return F.relu(batch_norm(self.BatchNorm_0, self.ConvTranspose_0(x)))


class FPNEncoder(nn.Module):
    def __init__(self, feat_chs=(8, 16, 32, 64)):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        spec = [(3, c0, 7, 1), (c0, c0, 5, 1), (c0, c1, 5, 2), (c1, c1, 3, 1), (c1, c1, 3, 1),
                (c1, c2, 5, 2), (c2, c2, 3, 1), (c2, c2, 3, 1), (c2, c3, 3, 2), (c3, c3, 3, 1),
                (c3, c3, 3, 1)]
        for i, (ci, co, k, s) in enumerate(spec):
            setattr(self, f"ConvBlock_{i}", ConvBlock(ci, co, k, s))

    def forward(self, x):
        outs = []
        for i in range(11):
            x = getattr(self, f"ConvBlock_{i}")(x)
            if i in (1, 4, 7, 10):
                outs.append(x)
        return tuple(outs)


class FPNDecoder(nn.Module):
    def __init__(self, feat_chs=(8, 16, 32, 64)):
        super().__init__()
        c0, c1, c2, c3 = feat_chs
        convs = [(c3, c3, 1), (c2, c3, 1), (c3, c2, 3), (c1, c3, 1), (c3, c1, 3), (c0, c3, 1),
                 (c3, c0, 3)]
        for i, (ci, co, k) in enumerate(convs):
            setattr(self, f"Conv_{i}", MMConv(ci, co, (k, k)))
        for i, c in enumerate((c3, c2, c1, c0)):
            setattr(self, f"BatchNorm_{i}", bn_layer(c))

    def _head(self, i, x):
        x = batch_norm(getattr(self, f"BatchNorm_{i}"),
                       getattr(self, f"Conv_{0 if i == 0 else 2 * i}")(x))
        return x * torch.sigmoid(x)

    def forward(self, c01, c11, c21, c31):
        intra = c31
        outs = [self._head(0, intra)]
        for i, lat in enumerate((c21, c11, c01), start=1):
            up = ops.resize2d(intra, lat.shape[-3], lat.shape[-2], "linear", True)
            intra = up + getattr(self, f"Conv_{2 * i - 1}")(lat)
            outs.append(self._head(i, intra))
        return tuple(outs)


class LayerNorm3D(nn.Module):
    def __init__(self, c, epsilon=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.epsilon = epsilon

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.weight + self.bias


# ------------------------------------------------------------------ blocks

class Dense(nn.Module):
    def __init__(self, fi, fo, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fo, fi))
        self.bias = nn.Parameter(torch.zeros(fo)) if bias else None

    def forward(self, x):
        return F.linear(q(x.float()), q(self.weight), self.bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, dim, heads, variant="softmax", qkv_bias=False, softmax_scale=None,
                 train_avg_length=None):
        super().__init__()
        self.q_proj = Dense(dim, dim, qkv_bias)
        self.k_proj = Dense(dim, dim, qkv_bias)
        self.v_proj = Dense(dim, dim, qkv_bias)
        self.proj = Dense(dim, dim, True)
        self.dim, self.heads, self.variant = dim, heads, variant
        self.avg = train_avg_length if softmax_scale == "entropy_invariance" else None

    def forward(self, x, key=None, value=None):
        b, n, _ = x.shape
        key = x if key is None else key
        value = key if value is None else value
        dh = self.dim // self.heads
        qq = self.q_proj(x).reshape(b, n, self.heads, dh)
        k = self.k_proj(key).reshape(b, key.shape[1], self.heads, dh)
        v = self.v_proj(value).reshape(b, value.shape[1], self.heads, dh)
        if self.variant == "linear":
            out = ops.linear_attention(qq, k, v)
        else:
            out = ops.softmax_attention(qq, k, v, ops.entropy_inv_scale(dh, n, self.avg))
        return self.proj(out.reshape(b, n, self.dim))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, dim)

    def forward(self, x):
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class LayerScale(nn.Module):
    def __init__(self, dim, init=1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma


class CrossBlock(nn.Module):
    """Pre-norm transformer block with optional cross attention; with
    pre_norm_query False the key and value are normed by norm1 too."""

    def __init__(self, dim, heads, variant="linear", init_values=1.0, softmax_scale=None,
                 train_avg_length=None, pre_norm_query=True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, heads, variant, softmax_scale=softmax_scale,
                                       train_avg_length=train_avg_length)
        self.mlp = Mlp(dim, dim * 4)
        self.ls1 = LayerScale(dim, init_values)
        self.ls2 = LayerScale(dim, init_values)
        self.pre_norm_query = pre_norm_query

    def forward(self, x, key=None, value=None):
        x = x.float()
        if not self.pre_norm_query:
            key = self.norm1(key.float()) if key is not None else None
            value = self.norm1(value.float()) if value is not None else None
        x = x + self.ls1(self.attn(self.norm1(x), key, value))
        return x + self.ls2(self.mlp(self.norm2(x)))


class FlashAttnBlock(nn.Module):
    """The CTA's post-norm block with scalar residual gammas."""

    def __init__(self, dim, heads, mlp_ratio, softmax_scale, train_avg_length):
        super().__init__()
        self.attn = MultiHeadAttention(dim, heads, "softmax", softmax_scale=softmax_scale,
                                       train_avg_length=train_avg_length)
        self.ffn = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(torch.tensor(1.0))
        self.gamma2 = nn.Parameter(torch.tensor(1.0))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.norm1(x + self.gamma1 * self.attn(x))
        return self.norm2(x + self.gamma2 * self.ffn(x))


# --------------------------------------------------------------- DINOv2 ViT

class DinoAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.dim, self.heads = dim, heads

    def forward(self, x):
        b, n, c = x.shape
        dh = self.dim // self.heads
        qq, k, v = self.qkv(x).reshape(b, n, 3, self.heads, dh).unbind(dim=2)
        return self.proj(ops.softmax_attention(qq, k, v, dh ** -0.5).reshape(b, n, c))


class DinoBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.ls1_gamma = nn.Parameter(torch.ones(dim))
        self.ls2_gamma = nn.Parameter(torch.ones(dim))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = Dense(dim, dim * 4)
        self.mlp_fc2 = Dense(dim * 4, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1_gamma
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)))) * self.ls2_gamma


class DinoVisionTransformer(nn.Module):
    def __init__(self, embed_dim=768, depth=12, heads=12, patch=14, grid=37, taps=3):
        super().__init__()
        self.patch_embed = Conv(3, embed_dim, (patch, patch), patch, 0)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, embed_dim))
        for i in range(depth):
            setattr(self, f"blocks_{i}", DinoBlock(embed_dim, heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.c, self.depth, self.patch, self.grid = embed_dim, depth, patch, grid
        self.interval = depth // taps

    def forward(self, imgs):
        b, h, w, _ = imgs.shape
        h0, w0, c, g = h // self.patch, w // self.patch, self.c, self.grid
        x = self.patch_embed(imgs).reshape(b, h0 * w0, c)
        pe = self.pos_embed[:, 1:]
        if (h0, w0) != (g, g):
            pe = ops.resize2d(pe.reshape(1, g, g, c), h0, w0, "cubic", False,
                              (h0 + 0.1) / g, (w0 + 0.1) / g).reshape(1, h0 * w0, c)
        x = torch.cat([self.cls_token.expand(b, 1, c), x], dim=1)
        x = x + torch.cat([self.pos_embed[:, :1], pe], dim=1)
        feats = []
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
            if (i + 1) % self.interval == 0 and i != self.depth - 1:
                feats.append(x[:, 1:])
        feats.append(self.norm(x)[:, 1:])
        return feats


class CrossVITDecoder(nn.Module):
    def __init__(self, d_model, nhead, taps, prev_values, softmax_scale, train_avg_length,
                 out_ch, pre_norm_query=True):
        super().__init__()

        def blk():
            return CrossBlock(d_model, nhead, "linear", 1.0, softmax_scale, train_avg_length,
                              pre_norm_query)

        for i in range(taps - 1):
            setattr(self, f"self_attn_{i}", blk())
            setattr(self, f"combine_norm_{i}", nn.LayerNorm(d_model, eps=1e-6))
            setattr(self, f"prev_value_{i}", nn.Parameter(torch.tensor(float(prev_values))))
        for i in range(taps):
            setattr(self, f"cross_attn_{i}", blk())
        self.proj = Conv(d_model, out_ch * 4, (3, 3), 1, 1)
        self.proj_bn = bn_layer(out_ch * 4)
        self.up0 = ConvTranspose(out_ch * 4, out_ch * 2, (4, 4), 2, 1, 0)
        self.up0_bn = bn_layer(out_ch * 2)
        self.up1 = ConvTranspose(out_ch * 2, out_ch, (4, 4), 2, 1, 0)
        self.up1_bn = bn_layer(out_ch)
        self.taps, self.out_ch = taps, out_ch

    def _combine(self, i, prev, tokens):
        return getattr(self, f"combine_norm_{i}")(getattr(self, f"prev_value_{i}") * prev
                                                  + tokens)

    def forward(self, levels, shape):
        b, v, h, w, c = shape
        ref = [levels[0][:, 0].float()]
        for i in range(self.taps - 1):
            ref.append(self._combine(i, getattr(self, f"self_attn_{i}")(ref[-1]),
                                     levels[i + 1][:, 0].float()))
        srcs = []
        for vi in range(1, v):
            src = None
            for i in range(self.taps):
                query = (levels[0][:, vi].float() if i == 0
                         else self._combine(i - 1, src, levels[i][:, vi].float()))
                src = getattr(self, f"cross_attn_{i}")(query, key=ref[i], value=ref[i])
            srcs.append(src)
        x = torch.stack([ref[-1]] + srcs, dim=1).reshape(b * v, h, w, c)
        for conv, bn in ((self.proj, self.proj_bn), (self.up0, self.up0_bn),
                         (self.up1, self.up1_bn)):
            x = F.silu(batch_norm(bn, conv(x)))
        return x.reshape(b, v, 4 * h, 4 * w, self.out_ch)


# --------------------------------------------------------------------- FMT

class FMT(nn.Module):
    def __init__(self, d_model, nhead, layer_names, softmax_scale, train_avg_length,
                 pre_norm_query):
        super().__init__()
        self.layer_names = tuple(layer_names)
        for i in range(len(self.layer_names)):
            setattr(self, f"layer{i}", CrossBlock(d_model, nhead, "linear", 1.0, softmax_scale,
                                                  train_avg_length, pre_norm_query))

    @staticmethod
    def _tokens(f):
        b, h, w, c = f.shape
        return (f.float() + ops.sine_pe_2d(c, h, w, f.device)).reshape(b, h * w, c)

    def forward_ref(self, f):
        x, outs = self._tokens(f), []
        for i, name in enumerate(self.layer_names):
            if name == "self":
                x = getattr(self, f"layer{i}")(x)
                outs.append(x)
        return outs

    def forward_src(self, refs, f):
        b, h, w, c = f.shape
        x = self._tokens(f)
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer{i}")
            if name == "self":
                x = layer(x)
            else:
                ref = refs[i if len(refs) == len(self.layer_names) else i // 2]
                x = layer(x, key=ref, value=ref)
        return x.reshape(b, h, w, c)


class FMTWithPathway(nn.Module):
    def __init__(self, bc, cfg):
        super().__init__()
        d = cfg.get("d_model", 64)
        self.fmt = FMT(d, cfg.get("nhead", 4), cfg.get("layer_names",
                                                      ("self", "cross", "self", "cross")),
                       cfg.get("softmax_scale", "entropy_invariance"),
                       cfg.get("train_avg_length", 12185), cfg.get("pre_norm_query", False))
        self.dim_reduction_1 = MMConv(d, bc * 4, (1, 1), use_bias=False)
        self.dim_reduction_2 = MMConv(bc * 4, bc * 2, (1, 1), use_bias=False)
        self.dim_reduction_3 = MMConv(bc * 2, bc, (1, 1), use_bias=False)
        self.smooth_1 = MMConv(bc * 4, bc * 4, (3, 3), use_bias=False)
        self.smooth_2 = MMConv(bc * 2, bc * 2, (3, 3), use_bias=False)
        self.smooth_3 = MMConv(bc, bc, (3, 3), use_bias=False)

    @staticmethod
    def _up_add(x, y):
        return ops.resize2d(x, y.shape[1], y.shape[2], "linear", False) + y.float()

    def forward(self, feats):
        b, v = feats["stage1"].shape[:2]
        outs = {k: [] for k in ("stage1", "stage2", "stage3", "stage4")}
        refs = None
        for vi in range(v):
            if vi == 0:
                refs = self.fmt.forward_ref(feats["stage1"][:, 0])
                _, h, w, c = feats["stage1"][:, 0].shape
                f1 = refs[-1].reshape(b, h, w, c)
            else:
                f1 = self.fmt.forward_src(refs, feats["stage1"][:, vi])
            f2 = self.smooth_1(self._up_add(self.dim_reduction_1(f1), feats["stage2"][:, vi]))
            f3 = self.smooth_2(self._up_add(self.dim_reduction_2(f2), feats["stage3"][:, vi]))
            f4 = self.smooth_3(self._up_add(self.dim_reduction_3(f3), feats["stage4"][:, vi]))
            for k, f in zip(outs, (f1, f2, f3, f4)):
                outs[k].append(f)
        return {k: torch.stack(fs, dim=1) for k, fs in outs.items()}


# ---------------------------------------------------------- regularizers

class _UNet3D(nn.Module):
    def __init__(self, ci, bc, stride):
        super().__init__()
        for lvl, (a, c) in enumerate([(ci, bc * 2), (bc * 2, bc * 4), (bc * 4, bc * 8)]):
            setattr(self, f"Conv3dBlock_{2 * lvl}", Conv3dBlock(c, c))
            setattr(self, f"Conv3dBlock_{2 * lvl + 1}", Conv3dBlock(a, c, 3, stride))
        for i, (a, c) in enumerate([(bc * 8, bc * 4), (bc * 4, bc * 2), (bc * 2, bc)]):
            setattr(self, f"Deconv3dBlock_{i}", Deconv3dBlock(a, c, 3, stride))
        self.has_inner = ci != bc
        if self.has_inner:
            self.Conv_0 = Conv(ci, bc, (1, 1, 1))

    def body(self, x):
        c2 = self.Conv3dBlock_0(self.Conv3dBlock_1(x))
        c4 = self.Conv3dBlock_2(self.Conv3dBlock_3(c2))
        y = self.Conv3dBlock_4(self.Conv3dBlock_5(c4))
        y = c4 + self.Deconv3dBlock_0(y)
        y = c2 + self.Deconv3dBlock_1(y)
        inner = self.Conv_0.pointwise(x) if self.has_inner else x.float()
        return inner + self.Deconv3dBlock_2(y)

    def final(self):
        return getattr(self, "Conv_1" if self.has_inner else "Conv_0")


class CostRegNet(_UNet3D):
    def __init__(self, ci, bc):
        super().__init__(ci, bc, (2, 2, 2))
        self.add_module("Conv_1" if self.has_inner else "Conv_0",
                        Conv(bc, 1, (3, 3, 3), 1, 1, bias=False))

    def forward(self, x):
        return self.final()(self.body(x))


class CostRegNet3D(_UNet3D):
    def __init__(self, ci, bc):
        super().__init__(ci, bc, (1, 2, 2))
        self.add_module("Conv_1" if self.has_inner else "Conv_0", Conv(bc, 1, (1, 1, 1)))

    def forward(self, x):
        return self.final().pointwise(self.body(x))


class PureTransformerCostReg(nn.Module):
    def __init__(self, base_channel=8, mid_channel=64, num_heads=4, mlp_ratio=4.0,
                 layer_num=6, down_rate=(2, 4, 4), position_encoding=True, use_pe_proj=True,
                 softmax_scale="entropy_invariance", train_avg_length=12185, **_):
        super().__init__()
        cb, rd = base_channel, tuple(down_rate)
        self.position_encoding, self.use_pe_proj = position_encoding, use_pe_proj
        if position_encoding and use_pe_proj:
            self.pe_proj = Conv(3 * cb, cb, (1, 1, 1), bias=False)
        self.down = Conv(cb, mid_channel, rd, rd, 0)
        self.down_norm = LayerNorm3D(mid_channel)
        self.layer_num = layer_num
        for i in range(layer_num):
            setattr(self, f"block{i}", FlashAttnBlock(mid_channel, num_heads, mlp_ratio,
                                                      softmax_scale, train_avg_length))
        self.up = ConvTranspose(mid_channel, cb, rd, rd, 0, 0)
        self.up_norm = LayerNorm3D(cb)
        self.prob = Conv(cb, 1, (1, 1, 1))
        self.cb, self.mid = cb, mid_channel

    def forward(self, x, pos=None):
        b, d, h, w, c = x.shape
        x = x.float()
        if pos is not None and self.position_encoding:
            if self.use_pe_proj:
                x = x + self.pe_proj.pointwise(ops.position_encoding_3d(pos, self.cb))
            else:
                x = x + ops.position_encoding_3d(pos, c // 3)
        xc = self.down_norm(self.down(x))
        d2, h2, w2 = xc.shape[1:4]
        t = xc.permute(0, 2, 3, 1, 4).reshape(b, h2 * w2 * d2, self.mid)
        for i in range(self.layer_num):
            t = getattr(self, f"block{i}")(t)
        xv = t.reshape(b, h2, w2, d2, self.mid).permute(0, 3, 1, 2, 4)
        return self.prob.pointwise(self.up_norm(self.up(xv)))


# ---------------------------------------------------------------- cascade

class VisibilityNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvBnReLU_0 = ConvBnReLU(1, 16)
        self.ConvBnReLU_1 = ConvBnReLU(16, 16)
        self.ConvBnReLU_2 = ConvBnReLU(16, 8)
        self.Conv_0 = MMConv(8, 1, (1, 1))

    def forward(self, e):
        return torch.sigmoid(self.Conv_0(self.ConvBnReLU_2(self.ConvBnReLU_1(
            self.ConvBnReLU_0(e)))))


class StageNet(nn.Module):
    def __init__(self, ndepth, groups, reg_type, depth_type, tcfg):
        super().__init__()
        self.vis = VisibilityNet()
        if reg_type == "PureTransformerCostReg":
            cfg = {k: v for k, v in (tcfg or {}).items() if k not in ("base_channel",)}
            self.cost_reg = PureTransformerCostReg(base_channel=groups, **cfg)
        elif ndepth <= 8:
            self.cost_reg = CostRegNet3D(groups, groups)
        else:
            self.cost_reg = CostRegNet(groups, groups)
        self.ndepth, self.groups = ndepth, groups
        self.reg_type, self.depth_type = reg_type, depth_type

    def build_volume(self, feats, cams, hypo):
        """Visibility-weighted mean over the source views of the warped
        source features times the reference's, reduced to G groups:
        [B, D, H, W, G]."""
        b, v, h, w, c = feats.shape
        sub = c // self.groups
        ref = feats[:, 0].float()
        projs = ops.compose_projection(cams)
        prods, ents = [], []
        for vi in range(1, v):
            coords = ops.sweep_coords(projs[:, vi], projs[:, 0], hypo, h, w).detach()
            prods.append(ops.warp(feats[:, vi], coords) * ref[:, None])  # [B, D, H, W, C]
            p = torch.softmax(prods[-1].detach().sum(dim=-1) / sub, dim=1)
            ents.append(-torch.sum(p * torch.log(p + 1e-7), dim=1))  # [B, H, W]
        # one visibility call over every source view (its batch statistics
        # are taken over all of them), rows view-major
        vis = self.vis(torch.cat(ents)[..., None]).reshape(v - 1, b, 1, h, w, 1)
        vol = sum(pr * vis[i] for i, pr in enumerate(prods)) / (vis.sum(dim=0) + 1e-6)
        return vol.reshape(b, -1, h, w, self.groups, sub).mean(dim=-1)

    def forward(self, feats, cams, hypo, tmp, pos=None):
        vol = self.build_volume(feats, cams, hypo)
        reg = self.cost_reg(vol, pos) if self.reg_type == "PureTransformerCostReg" \
            else self.cost_reg(vol)
        pre = reg[..., 0]
        prob = torch.softmax(pre, dim=1)
        depth = ops.depth_regression(torch.softmax(pre * tmp, dim=1), hypo)
        return {"depth": depth, "prob_volume": prob,
                "photometric_confidence": prob.max(dim=1).values.detach(),
                "depth_values": hypo, "prob_volume_pre": pre}


class CascadeDepth(nn.Module):
    def __init__(self, ndepths, ratios, reg_types, depth_types, groups, use_pe3d, tcfgs):
        super().__init__()
        self.ndepths, self.ratios = tuple(ndepths), tuple(ratios)
        self.reg_types, self.use_pe3d = tuple(reg_types), use_pe3d
        for i, nd in enumerate(self.ndepths):
            tc = None
            if reg_types[i] == "PureTransformerCostReg" and tcfgs:
                tc = tcfgs[min(i, len(tcfgs) - 1)]
            self.add_module(f"stage{i + 1}", StageNet(nd, groups[i], reg_types[i],
                                                      depth_types[i], tc))

    def forward(self, feats, cams, dv, tmp):
        dv = dv.float()
        last = feats[f"stage{len(self.ndepths)}"]
        img_h, img_w = last.shape[2], last.shape[3]
        outputs, prev, bounds, probs = {}, {}, None, 0.0
        for i, nd in enumerate(self.ndepths):
            key = f"stage{i + 1}"
            f, c = feats[key], cams[key]
            h, w = f.shape[2], f.shape[3]
            if i == 0:
                hypo = ops.init_inverse_range(dv, nd, h, w)
            else:
                hypo = ops.schedule_inverse_range(prev["depth"].detach(), prev["depth_values"],
                                                  nd, self.ratios[i], h, w)
            pos = None
            if self.reg_types[i] != "Normal" and self.use_pe3d:
                pos, bounds = ops.position_3d(c[:, 0, 1, :3, :3], hypo, h, w, dv.min(),
                                              dv.max(), bounds)
            prev = getattr(self, key)(f, c, hypo, tmp[i], pos)
            outputs[key] = prev
            conf = prev["photometric_confidence"]
            if conf.shape[1] != img_h or conf.shape[2] != img_w:
                conf = ops.resize2d(conf[..., None], img_h, img_w, "nearest")[..., 0]
            probs = probs + conf
        outputs["refined_depth"] = prev["depth"]
        outputs["photometric_confidence"] = probs / len(self.ndepths)
        return outputs


# ------------------------------------------------------------------ models

class DINOv2MVSNet(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        fc = tuple(a["feat_chs"])
        self.encoder = FPNEncoder(fc)
        self.decoder = FPNDecoder(fc)
        dino = a.get("dino_cfg", {})
        taps = dino.get("cross_interval_layers", 3)
        self.vit = DinoVisionTransformer(a["vit_ch"], a.get("vit_depth", 12),
                                         a.get("vit_num_heads", 12), a.get("vit_patch", 14),
                                         taps=taps)
        self.vit.requires_grad_(not a.get("freeze_vit", True))
        dec = dino.get("decoder_cfg", {})
        self.decoder_vit = CrossVITDecoder(dec.get("d_model", a["vit_ch"]), dec.get("nhead", 12),
                                           taps, dec.get("prev_values", 0.5),
                                           dec.get("softmax_scale", "entropy_invariance"),
                                           dec.get("train_avg_length", 762), a["out_ch"],
                                           dec.get("pre_norm_query", True))
        self.fmt = FMTWithPathway(a["base_ch"][0], a.get("FMT_config", {}))
        self.cascade = _cascade(a)
        self.rescale, self.patch, self.vit_ch = a["rescale"], a.get("vit_patch", 14), a["vit_ch"]

    def forward(self, imgs, cams, dv, tmp=(5.0, 5.0, 5.0, 1.0)):
        b, v, h, w, _ = imgs.shape
        flat = imgs.reshape(b * v, h, w, 3).float()
        c01, c11, c21, c31 = self.encoder(flat)
        p = self.patch
        vh, vw = int(h * self.rescale // p * p), int(w * self.rescale // p * p)
        with torch.no_grad():
            levels = self.vit(ops.resize2d(flat, vh, vw, "cubic", False))
        levels = [f.reshape(b, v, -1, self.vit_ch) for f in levels]
        vit = self.decoder_vit(levels, (b, v, vh // p, vw // p, self.vit_ch))
        vit = vit.reshape(b * v, vit.shape[2], vit.shape[3], -1)
        if vit.shape[1:3] != c31.shape[1:3]:
            vit = ops.resize2d(vit, c31.shape[1], c31.shape[2], "linear", False)
        f = self.decoder(c01, c11, c21, c31 + vit)
        feats = {f"stage{i + 1}": x.reshape(b, v, *x.shape[1:]) for i, x in enumerate(f)}
        return self.cascade(self.fmt(feats), cams, dv, tmp)


def _cascade(a):
    return CascadeDepth(a["ndepths"], a["depth_interals_ratio"], a["cost_reg_type"],
                        a["depth_type"], a["base_ch"], a.get("use_pe3d", False),
                        a.get("transformer_config"))


def build(arch_args: dict) -> nn.Module:
    """The reference model of a configuration's `arch.args` (DINOv2MVSNet)."""
    for k in ("log_var", "shard_views", "shard_depth"):
        if arch_args.get(k):
            raise ValueError(f"the reference does not model arch.args.{k}")
    if arch_args.get("inverse_depth", True) is not True:
        raise ValueError("the reference models the inverse-depth cascade only")
    if any(t != "ce" for t in arch_args["depth_type"]):
        raise ValueError("the reference models CE stages only")
    for cfg in (arch_args.get("FMT_config", {}),
                arch_args.get("dino_cfg", {}).get("decoder_cfg", {})):
        if cfg.get("attention_type", "Linear") != "Linear" or cfg.get("ffn_type", "ffn") != "ffn":
            raise ValueError("the reference models linear attention with a GELU FFN in the "
                             "FMT and the ViT decoder")
    if arch_args.get("model_type") == "casmvs":
        raise ValueError("the reference models DINOv2MVSNet only, not CasMVSNet")
    return DINOv2MVSNet(arch_args)
