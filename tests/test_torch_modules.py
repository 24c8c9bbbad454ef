"""The PyTorch port's modules against the JAX modules on converted random
weights and BatchNorm statistics, fp32 on CPU at atol/rtol 2e-4."""
import numpy as np
import pytest
import torch

import jax

from mvsformerplusplus_tpu.models import blocks as jblocks
from mvsformerplusplus_tpu.models import cost_reg as jcost
from mvsformerplusplus_tpu.models import dino as jdino
from mvsformerplusplus_tpu.models import layers as jlayers
from mvsformerplusplus_tpu.models import stagenet as jstage
from mvsformerplusplus_tpu.ops.geometry import get_position_3d
from mvsformerplusplus_tpu.ops.sampling import init_inverse_range
from mvsformerplusplus_tpu_torch.models import blocks as tblocks
from mvsformerplusplus_tpu_torch.models import cost_reg as tcost
from mvsformerplusplus_tpu_torch.models import dino as tdino
from mvsformerplusplus_tpu_torch.models import layers as tlayers
from mvsformerplusplus_tpu_torch.models import stagenet as tstage
from tests.test_casmvs import make_inputs
from tests.torch_parity import assert_close, init_flax, load_port, t

FEAT_CHS = (4, 8, 16, 32)


def _apply(module, variables, *args, **kwargs):
    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def _run(module, *args, **kwargs):
    with torch.inference_mode():
        return module(*args, **kwargs)


def test_fpn_encoder_decoder():
    x = np.random.RandomState(0).rand(1, 16, 32, 3).astype(np.float32)
    jenc = jlayers.FPNEncoder(FEAT_CHS)
    venc = init_flax(jenc, x)
    want = _apply(jenc, venc, x)
    tenc = load_port(tlayers.FPNEncoder(FEAT_CHS), venc)
    got = _run(tenc, t(x))
    for g, w in zip(got, want):
        assert_close(g, w)
    feats = [np.asarray(w) for w in want]
    jdec = jlayers.FPNDecoder(FEAT_CHS)
    vdec = init_flax(jdec, *feats, seed=1)
    tdec = load_port(tlayers.FPNDecoder(FEAT_CHS), vdec)
    for g, w in zip(_run(tdec, *map(t, feats)), _apply(jdec, vdec, *feats)):
        assert_close(g, w)


@pytest.mark.parametrize("variant,post_norm,pre_norm_query,cross", [
    ("linear", False, True, False), ("linear", False, False, True),
    ("softmax", False, True, True), ("softmax", True, True, False),
])
def test_cross_block(variant, post_norm, pre_norm_query, cross):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 37, 32).astype(np.float32)
    kv = rng.randn(2, 29, 32).astype(np.float32) if cross else None
    kw = dict(dim=32, num_heads=2, variant=variant, post_norm=post_norm,
              pre_norm_query=pre_norm_query, softmax_scale="entropy_invariance",
              train_avg_length=762)
    jm = jblocks.CrossBlock(**kw)
    v = init_flax(jm, x, kv, kv)
    tm = load_port(tblocks.CrossBlock(**kw), v)
    got = _run(tm, t(x), None if kv is None else t(kv), None if kv is None else t(kv))
    assert_close(got, _apply(jm, v, x, kv, kv))


@pytest.mark.parametrize("post_norm", [True, False])
def test_flash_attn_block(post_norm):
    x = np.random.RandomState(2).randn(1, 96, 16).astype(np.float32)
    kw = dict(dim=16, num_heads=2, mlp_ratio=2.0, softmax_scale="entropy_invariance",
              train_avg_length=12185, init_values=0.7, post_norm=post_norm)
    jm = jblocks.FlashAttnBlock(**kw)
    v = init_flax(jm, x)
    assert_close(_run(load_port(tblocks.FlashAttnBlock(**kw), v), t(x)), _apply(jm, v, x))


@pytest.mark.parametrize("cls,in_ch", [("CostRegNet", 4), ("CostRegNet", 6),
                                       ("CostRegNet3D", 4), ("CostRegNet3D", 6)])
def test_unet_cost_regs(cls, in_ch):
    x = np.random.RandomState(3).randn(1, 8, 8, 8, in_ch).astype(np.float32)
    jm = getattr(jcost, cls)(base_channels=4, layout="ndhwc")
    v = init_flax(jm, x)
    tm = load_port(getattr(tcost, cls)(in_ch, 4), v)
    assert_close(_run(tm, t(x)), _apply(jm, v, x))


@pytest.mark.parametrize("use_pe_proj", [True, False])
def test_pure_transformer_cost_reg(use_pe_proj):
    rng = np.random.RandomState(4)
    b, d, h, w, c = 1, 8, 8, 16, 6
    x = rng.randn(b, d, h, w, c).astype(np.float32)
    pos = rng.rand(b, 3, d, h, w).astype(np.float32)
    kw = dict(base_channel=6 if not use_pe_proj else c, mid_channel=16, num_heads=2,
              mlp_ratio=2.0, layer_num=2, use_pe_proj=use_pe_proj, init_values=0.5)
    jm = jcost.PureTransformerCostReg(**kw)
    v = init_flax(jm, x, pos)
    tm = load_port(tcost.PureTransformerCostReg(**kw, in_ch=c), v)
    assert_close(_run(tm, t(x), t(pos)), _apply(jm, v, x, pos))


def test_visibility_net():
    e = np.random.RandomState(5).rand(3, 16, 24, 1).astype(np.float32) * 3
    jm = jstage.VisibilityNet()
    v = init_flax(jm, e)
    assert_close(_run(load_port(tstage.VisibilityNet(), v), t(e)), _apply(jm, v, e))


@pytest.mark.parametrize("cost_reg_type,ndepth,depth_type", [
    ("PureTransformerCostReg", 8, "ce"), ("Normal", 4, "ce"), ("Normal", 16, "reg"),
])
def test_stagenet(cost_reg_type, ndepth, depth_type):
    _, cams, dv = make_inputs(np.random.RandomState(6), v=3, h=64, w=128, dfull=32)
    cams = np.asarray(cams["stage2"])
    dv = np.asarray(dv)
    h, w, c, g = 8, 16, 8, 4
    feats = np.random.RandomState(7).randn(1, 3, h, w, c).astype(np.float32)
    hypo = np.asarray(init_inverse_range(dv, ndepth, h, w))
    pos = None
    tc = None
    if cost_reg_type != "Normal":
        pos, _ = get_position_3d(cams[:, 0, 1, :3, :3], hypo, h, w, dv.min(), dv.max())
        pos = np.asarray(pos)
        tc = dict(mid_channel=16, num_heads=2, mlp_ratio=2, layer_num=1)
    jm = jstage.StageNet(ndepth=ndepth, groups=g, cost_reg_type=cost_reg_type,
                         depth_type=depth_type, transformer_config=tc)
    v = init_flax(jm, feats, cams, hypo, 2.0, pos, False)
    want = _apply(jm, v, feats, cams, hypo, 2.0, pos, False)
    tm = load_port(tstage.StageNet(ndepth, g, cost_reg_type, depth_type, tc), v)
    got = _run(tm, t(feats), t(cams), t(hypo), 2.0, None if pos is None else t(pos))
    for key in ("prob_volume_pre", "prob_volume", "depth", "photometric_confidence"):
        assert_close(got[key], want[key])


def test_dino_vit_interval_taps():
    x = np.random.RandomState(8).rand(2, 28, 56, 3).astype(np.float32)
    kw = dict(embed_dim=32, depth=4, num_heads=2, cross_interval_layers=2)
    jm = jdino.DinoVisionTransformer(**kw)
    v = init_flax(jm, x)
    got = _run(load_port(tdino.DinoVisionTransformer(**kw), v), t(x))
    want = _apply(jm, v, x)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_close(g, w)
