"""The model variants of the JAX package that no shipped config selects,
ported: SwiGLU (and a CrossBlock with ffn_type "glu"), ConvBlock's "IN" and
"none" norms and FPNEncoder(norm="IN"), CostRegNet2D, CostRegNet3D with the
log_var channel, StageNet's log_var output and gate, the correlation
functions, and the tiny flagship with the variant config (log_var, reg
depth at stages 3-4, SwiGLU in the ViT decoder and FMT): its forward and
one train step. Each against the JAX module on CPU from the same converted
weights and seeded inputs, fp32, at test_torch_modules.py's atol/rtol 2e-4
unless a test says otherwise; the train step at test_torch_train_step.py's
tolerances and conditioning where the JAX CPU reference is that accurate,
as its tests say.

flax 0.12's GroupNorm defaults num_groups to 32 and refuses group_size
with it, so the JAX ConvBlock(norm="IN") raises at init on this flax. The
IN tests run it with a GroupNorm whose num_groups defaults to None (the
group_size=1 norm the JAX code names), patched into flax.linen for the
test only.
"""
import contextlib
from typing import Optional

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvsformerplusplus_tpu import losses as jlosses
from mvsformerplusplus_tpu.models import blocks as jblocks
from mvsformerplusplus_tpu.models import cost_reg as jcost
from mvsformerplusplus_tpu.models import layers as jlayers
from mvsformerplusplus_tpu.models import stagenet as jstage
from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu.ops import correlation as jcorr
from mvsformerplusplus_tpu.ops.sampling import init_inverse_range
from mvsformerplusplus_tpu.train.optim import make_optimizer as jax_make_optimizer
from mvsformerplusplus_tpu.train.step import TrainState, make_train_step
from mvsformerplusplus_tpu_torch import convert
from mvsformerplusplus_tpu_torch import losses as tlosses
from mvsformerplusplus_tpu_torch.config import Config, build_model
from mvsformerplusplus_tpu_torch.convert import from_jax_variables
from mvsformerplusplus_tpu_torch.models import blocks as tblocks
from mvsformerplusplus_tpu_torch.models import cost_reg as tcost
from mvsformerplusplus_tpu_torch.models import layers as tlayers
from mvsformerplusplus_tpu_torch.models import stagenet as tstage
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.ops import correlation as tcorr
from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from mvsformerplusplus_tpu_torch.train.step import train_step
from tests.test_casmvs import make_inputs
from tests.test_mvsformer import TINY_DECODER_CFG, TINY_FMT_CFG
from tests.test_torch_flagship import TINY, TINY_ARCH_ARGS
from tests.test_torch_train_step import LR, OPT, capture_grads, to_torch
from tests.torch_parity import assert_close, init_flax, load_port, t

FEAT_CHS = (4, 8, 16, 32)
VARIANT = dict(TINY, decoder_cfg=dict(TINY_DECODER_CFG, ffn_type="glu"),
               fmt_config=dict(TINY_FMT_CFG, ffn_type="glu"),
               depth_type=("ce", "ce", "reg", "reg"), log_var=True)
# the batch seed (testing.conditioned_train_batch) whose CE stages keep their
# argmax depths clear of ties with the variant's weights and whose step is
# insensitive to a one-ulp change of the images (both asserted below)
SEED = 9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class GroupNorm(fnn.GroupNorm):
    num_groups: Optional[int] = None


@pytest.fixture
def jax_in_norm(monkeypatch):
    monkeypatch.setattr(fnn, "GroupNorm", GroupNorm)


def _apply(module, variables, *args, **kwargs):
    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def _run(module, *args, **kwargs):
    with torch.inference_mode():
        return module(*args, **kwargs)


def _train_grads(jm, tm, variables, x, seed):
    """Train mode on both sides: the outputs, the gradients of a random
    linear functional of every output (JAX's tree converted to the port's
    layout) and the JAX running statistics; the port's are in tm."""
    def outs(o):
        return list(o) if isinstance(o, (tuple, list)) else [o]

    def loss(params):
        o, upd = jm.apply({**variables, "params": params}, x, train=True,
                          mutable=["batch_stats"])
        return sum(jnp.sum(a * c) for a, c in zip(outs(o), cot)), (o, upd)

    probe = outs(jax.eval_shape(lambda: jm.apply(variables, x, train=True,
                                                 mutable=["batch_stats"])[0]))
    rng = np.random.RandomState(seed)
    cot = [rng.randn(*a.shape).astype(np.float32) for a in probe]
    (_, (want, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    tm.train()
    got = outs(tm(t(x)))
    sum((g * t(c)).sum() for g, c in zip(got, cot)).backward()
    return got, outs(want), from_jax_variables({"params": grads, **upd})


def _assert_grads(tm, want):
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        assert_close(p.grad, w, atol=1e-4 * (1 + np.abs(w).max()))
    for name, v in want.items():
        if name.endswith(("running_mean", "running_var")):
            assert_close(tm.state_dict()[name], v.numpy())


# ---------------------------------------------------------------------- SwiGLU

@pytest.mark.parametrize("dim,hidden", [(32, 128), (48, 100), (20, 7)])
def test_swiglu(dim, hidden):
    x = np.random.RandomState(0).randn(2, 11, dim).astype(np.float32)
    jm = jblocks.SwiGLU(hidden=hidden)
    v = init_flax(jm, x)
    tm = load_port(tblocks.SwiGLU(dim, hidden), v)
    h = (int(hidden * 2 / 3) + 7) // 8 * 8
    assert tuple(tm.Dense_0.weight.shape) == (2 * h, dim)
    assert_close(_run(tm, t(x)), _apply(jm, v, x))
    cot = np.random.RandomState(1).randn(2, 11, dim).astype(np.float32)
    grads = from_jax_variables({"params": jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, x) * cot))(v["params"])})
    (tm(t(x)) * t(cot)).sum().backward()
    for name, p in tm.named_parameters():
        assert_close(p.grad, grads[name])


@pytest.mark.parametrize("variant,post_norm,cross", [("linear", False, True),
                                                      ("softmax", False, False),
                                                      ("softmax", True, True)])
def test_cross_block_glu(variant, post_norm, cross):
    """Any ffn_type but "ffn" selects SwiGLU, as in the JAX CrossBlock."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 37, 32).astype(np.float32)
    kv = rng.randn(2, 29, 32).astype(np.float32) if cross else None
    kw = dict(dim=32, num_heads=2, variant=variant, post_norm=post_norm, ffn_type="glu",
              softmax_scale="entropy_invariance", train_avg_length=762)
    jm = jblocks.CrossBlock(**kw)
    v = init_flax(jm, x, kv, kv)
    tm = load_port(tblocks.CrossBlock(**kw), v)
    assert isinstance(tm.mlp, tblocks.SwiGLU)
    got = _run(tm, t(x), None if kv is None else t(kv), None if kv is None else t(kv))
    assert_close(got, _apply(jm, v, x, kv, kv))


# ------------------------------------------------------------------ norms, FPN

@pytest.mark.parametrize("norm,k,stride", [("IN", 3, 1), ("IN", 5, 2), ("IN", 7, 1),
                                           ("none", 3, 1), ("none", 3, 2)])
def test_conv_block_norms(jax_in_norm, norm, k, stride):
    x = np.random.RandomState(2).randn(2, 16, 24, 6).astype(np.float32)
    jm = jlayers.ConvBlock(8, k, stride, norm=norm)
    v = init_flax(jm, x)
    tm = load_port(tlayers.ConvBlock(6, 8, k, stride, norm=norm), v)
    assert hasattr(tm, "GroupNorm_0") == (norm == "IN")
    assert (tm.Conv_0.bias is not None) == (norm == "none")
    assert_close(_run(tm, t(x)), _apply(jm, v, x))


def test_conv_block_defaults_to_in():
    assert jlayers.ConvBlock(8).norm == tlayers.ConvBlock(3, 8).norm == "IN"
    assert jlayers.FPNEncoder().norm == "BN"
    assert isinstance(tlayers.FPNEncoder().ConvBlock_0.BatchNorm_0, torch.nn.BatchNorm1d)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_fpn_encoder_in(jax_in_norm, mode):
    """FPNEncoder(norm="IN"): the forward in eval mode, and in train mode
    (IN keeps no statistics: the same numbers) with the gradients of every
    parameter."""
    x = np.random.RandomState(3).rand(2, 32, 48, 3).astype(np.float32)
    jm = jlayers.FPNEncoder(FEAT_CHS, norm="IN")
    v = init_flax(jm, x)
    assert "batch_stats" not in v
    tm = load_port(tlayers.FPNEncoder(FEAT_CHS, norm="IN"), v)
    if mode == "eval":
        for g, w in zip(_run(tm, t(x)), _apply(jm, v, x)):
            assert_close(g, w)
        return
    got, want, grads = _train_grads(jm, tm, v, x, 4)
    for g, w in zip(got, want):
        assert_close(g, w)
    _assert_grads(tm, grads)


# ------------------------------------------------------------------- U-Nets

def test_cost_reg_net_2d_eval():
    x = np.random.RandomState(5).randn(2, 4, 8, 16, 4).astype(np.float32)
    jm = jcost.CostRegNet2D(base_channels=4)
    v = init_flax(jm, x)
    tm = load_port(tcost.CostRegNet2D(4), v)
    got = _run(tm, t(x))
    assert got.shape == (2, 4, 8, 16, 1)
    assert_close(got, _apply(jm, v, x))


def test_cost_reg_net_2d_train():
    """Batch statistics, the running update and every gradient."""
    x = np.random.RandomState(6).randn(2, 4, 8, 16, 4).astype(np.float32)
    jm = jcost.CostRegNet2D(base_channels=4)
    v = init_flax(jm, x)
    tm = load_port(tcost.CostRegNet2D(4), v)
    got, want, grads = _train_grads(jm, tm, v, x, 7)
    assert_close(got[0], want[0])
    _assert_grads(tm, grads)


@pytest.mark.parametrize("in_ch", [4, 6])
def test_cost_reg_net_3d_log_var(in_ch):
    x = np.random.RandomState(7).randn(1, 8, 8, 8, in_ch).astype(np.float32)
    jm = jcost.CostRegNet3D(base_channels=4, log_var=True, layout="ndhwc")
    v = init_flax(jm, x)
    tm = load_port(tcost.CostRegNet3D(in_ch, 4, log_var=True), v)
    got = _run(tm, t(x))
    assert got.shape[-1] == 2
    assert_close(got, _apply(jm, v, x))


# -------------------------------------------------------------- correlation

@pytest.mark.parametrize("groups", [8, 4, 1])
def test_correlation_functions(groups):
    rng = np.random.RandomState(8)
    b, d, h, w, c = 2, 6, 5, 7, 8
    warped = rng.randn(b, d, h, w, c).astype(np.float32)
    ref = rng.randn(b, h, w, c).astype(np.float32)
    corr = tcorr.groupwise_correlation(t(warped), t(ref), groups)
    assert corr.shape == (b, d, h, w, groups)
    assert_close(corr, jcorr.groupwise_correlation(warped, ref, groups))
    ent = tcorr.correlation_entropy(corr)
    assert ent.shape == (b, h, w, 1)
    assert_close(ent, jcorr.correlation_entropy(np.asarray(corr)))
    pairs = [(rng.randn(b, d, h, w, groups).astype(np.float32),
              rng.rand(b, h, w, 1).astype(np.float32)) for _ in range(3)]
    assert_close(tcorr.accumulate_weighted_volume([(t(a), t(v)) for a, v in pairs]),
                 jcorr.accumulate_weighted_volume(pairs))


def test_correlation_rejects_uneven_groups_and_stops_the_entropy_gradient():
    with pytest.raises(ValueError, match="divisible"):
        tcorr.groupwise_correlation(torch.zeros(1, 2, 3, 3, 6), torch.zeros(1, 3, 3, 6), 4)
    corr = torch.randn(1, 4, 3, 3, 2, requires_grad=True)
    assert not tcorr.correlation_entropy(corr).requires_grad


# ---------------------------------------------------------------- StageNet

def _stage_inputs(ndepth):
    _, cams, dv = make_inputs(np.random.RandomState(9), v=3, h=64, w=128, dfull=32)
    cams = np.asarray(cams["stage2"])
    h, w = 8, 16
    feats = np.random.RandomState(10).randn(1, 3, h, w, 8).astype(np.float32)
    return feats, cams, np.asarray(init_inverse_range(np.asarray(dv), ndepth, h, w))


@pytest.mark.parametrize("ndepth,depth_type", [(4, "reg"), (8, "ce"), (8, "reg")])
def test_stagenet_log_var(ndepth, depth_type):
    feats, cams, hypo = _stage_inputs(ndepth)
    jm = jstage.StageNet(ndepth=ndepth, groups=4, depth_type=depth_type, log_var=True)
    v = init_flax(jm, feats, cams, hypo, 2.0, None, False)
    want = _apply(jm, v, feats, cams, hypo, 2.0, None, False)
    tm = load_port(tstage.StageNet(ndepth, 4, depth_type=depth_type, log_var=True), v)
    got = _run(tm, t(feats), t(cams), t(hypo), 2.0)
    assert got["log_var"].shape == got["depth"].shape
    for key in ("log_var", "prob_volume_pre", "prob_volume", "depth", "photometric_confidence"):
        assert_close(got[key], want[key])


def _stage_train(hw, dtype=torch.float32):
    """A reg stage with the log_var head at hw x hw in train mode: the JAX
    gradients of reg_depth_loss with its uncertainty term, and the port's
    (in `dtype`), converted to the port's layout."""
    _, cams, dv = make_inputs(np.random.RandomState(9), v=3, h=2 * hw, w=2 * hw, dfull=32)
    cams = np.asarray(cams["stage4"])
    rng = np.random.RandomState(1)
    feats = rng.randn(1, 3, hw, hw, 8).astype(np.float32)
    hypo = np.asarray(init_inverse_range(np.asarray(dv), 4, hw, hw))
    gt = rng.uniform(3, 7, (1, hw, hw)).astype(np.float32)
    mask = np.ones_like(gt)
    di = np.asarray(dv[:, 1] - dv[:, 0])
    jm = jstage.StageNet(ndepth=4, groups=4, depth_type="reg", log_var=True)
    v = init_flax(jm, feats, cams, hypo, 1.0, None, False)

    def loss(params):
        o, _ = jm.apply({**v, "params": params}, feats, cams, hypo, 1.0, None, True,
                        mutable=["batch_stats"])
        return jlosses.reg_depth_loss(o["depth"], gt, mask, di, o["depth_values"], True,
                                      "dynamic", o["log_var"])[0]

    want = from_jax_variables({"params": jax.jit(jax.grad(loss))(v["params"])})
    tm = tstage.StageNet(4, 4, depth_type="reg", log_var=True, dtype=dtype)
    tm.load_state_dict(from_jax_variables(v))
    tm.to(dtype).train()
    o = tm(t(feats).to(dtype), t(cams).to(dtype), t(hypo).to(dtype), 1.0)
    tlosses.reg_depth_loss(o["depth"], t(gt), t(mask), t(di).to(dtype), o["depth_values"], True,
                           "dynamic", o["log_var"])[0].backward()
    return want, {n: p.grad.double() for n, p in tm.named_parameters()}


def _grad_ratio(got, want):
    """max over tensors of max |got - want| / (1e-3 max |want| + 5e-5)."""
    return max(((got[n].double() - w.double()).abs().max()
                / (1e-3 * w.double().abs().max() + 5e-5)).item() for n, w in want.items())


def test_stagenet_log_var_train_gradients():
    """A reg stage's uncertainty loss backpropagated through the log_var
    head: every gradient against JAX's within 1e-3 of its tensor's largest
    entry + 5e-5."""
    want, got = _stage_train(16)
    assert _grad_ratio(got, want) <= 1


@contextlib.contextmanager
def float64_port():
    """Inside it the port's StageNet computes in float64: its fp32 casts and
    pixel grid keep float64, and new tensors default to it."""
    from mvsformerplusplus_tpu_torch.ops import geometry

    to_f32, grid, default = torch.Tensor.float, geometry.pixel_grid, torch.get_default_dtype()
    torch.Tensor.float = lambda x, *a, **k: x if x.dtype == torch.float64 else to_f32(x, *a, **k)
    geometry.pixel_grid = lambda h, w, device=None: grid(h, w, device).double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, geometry.pixel_grid = to_f32, grid
        torch.set_default_dtype(default)


def test_stagenet_log_var_gradients_against_float64():
    """At 64 x 64 the same reg stage in float64 decides between the two fp32
    computations: the port's gradients lie within 1e-3 of each tensor's
    largest entry + 5e-5 of it, the JAX CPU step's do not (its BatchNorm
    statistics are sequential fp32 sums), which is why the variant
    flagship's step holds the gradients that follow a 64 x 64 reg stage
    per module (test_variant_train_step_gradients_and_update)."""
    want, got = _stage_train(64)
    with float64_port():
        _, exact = _stage_train(64, torch.float64)
    assert _grad_ratio(got, exact) <= 1
    assert _grad_ratio(want, exact) > 2


@pytest.mark.parametrize("cost_reg_type,ndepth", [("PureTransformerCostReg", 8), ("Normal", 16)])
def test_stagenet_log_var_gate(cost_reg_type, ndepth):
    """Only a CostRegNet3D stage carries the head: both packages raise."""
    feats, cams, hypo = _stage_inputs(ndepth)
    tc = dict(mid_channel=16, num_heads=2, mlp_ratio=2, layer_num=1)
    jm = jstage.StageNet(ndepth=ndepth, groups=4, cost_reg_type=cost_reg_type,
                         transformer_config=tc, log_var=True)
    with pytest.raises(ValueError, match="CostRegNet3D"):
        jax.eval_shape(lambda r: jm.init(r, feats, cams, hypo, 2.0, None, False),
                       jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="CostRegNet3D"):
        tstage.StageNet(ndepth, 4, cost_reg_type, transformer_config=tc, log_var=True)


def test_build_model_rejects_shard_views_with_shard_depth():
    cfg = Config({"arch": {"args": dict(TINY_ARCH_ARGS)}})
    assert build_model(cfg, torch.float32, "cpu", shard_depth=True).cascade.stage2.shard_depth
    with pytest.raises(ValueError, match="shard_views and shard_depth"):
        build_model(cfg, torch.float32, "cpu", shard_views=True, shard_depth=True)


# ---------------------------------------------------------------- converter

def _variant_trees():
    """(port module, JAX variables) for each new parameter tree."""
    x2 = np.zeros((1, 16, 16, 3), np.float32)
    x3 = np.zeros((1, 4, 8, 8, 4), np.float32)
    tok = np.zeros((1, 5, 32), np.float32)
    yield tblocks.SwiGLU(32, 128), init_flax(jblocks.SwiGLU(hidden=128), tok)
    yield tlayers.ConvBlock(3, 8), init_flax(jlayers.ConvBlock(8), x2)
    yield (tlayers.FPNEncoder(FEAT_CHS, norm="IN"),
           init_flax(jlayers.FPNEncoder(FEAT_CHS, norm="IN"), x2))
    yield tcost.CostRegNet2D(4), init_flax(jcost.CostRegNet2D(base_channels=4), x3)
    yield (tcost.CostRegNet3D(4, 4, log_var=True),
           init_flax(jcost.CostRegNet3D(base_channels=4, log_var=True, layout="ndhwc"), x3))
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    yield (DINOv2MVSNet(**VARIANT),
           init_flax(JaxFlagship(**VARIANT, remat_stages=False), imgs, cams, dv, train=False))


def test_converter_takes_every_new_tree(jax_in_norm, tmp_path):
    """Every converted key is a tensor of the port's module of the same
    shape and every tensor of the module gets one; through load_npz (the
    converted-checkpoint format) every key lands, and a planted extra key
    raises."""
    for i, (tm, variables) in enumerate(_variant_trees()):
        sd = from_jax_variables(variables)
        want = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
        assert {k for k in sd if not k.endswith("num_batches_tracked")} == want, type(tm)
        flat = {f"{coll}:{'/'.join(p.key for p in path)}": np.asarray(leaf)
                for coll in variables
                for path, leaf in jax.tree_util.tree_flatten_with_path(variables[coll])[0]}
        np.savez(tmp_path / f"v{i}.npz", **flat)
        assert convert.load_npz(tmp_path / f"v{i}.npz", tm) == len(sd)
        for k, v in sd.items():
            assert torch.equal(tm.state_dict()[k], v), k
        key, leaf = next(iter(flat.items()))
        np.savez(tmp_path / f"x{i}.npz", **flat, **{key + "_planted": leaf})
        with pytest.raises(KeyError, match="planted"):
            convert.load_npz(tmp_path / f"x{i}.npz", tm)


# ------------------------------------------------------- the variant flagship

def test_variant_flagship_forward():
    """The eval forward: refined depth where testing.well_conditioned holds,
    the probabilities and confidences everywhere, and log_var at the
    CostRegNet3D stages (2-4; stage 1 is the CTA's and has none)."""
    from mvsformerplusplus_tpu_torch.testing import well_conditioned

    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    jm = JaxFlagship(**VARIANT, remat_stages=False)
    v = init_flax(jm, imgs, cams, dv, train=False)
    want = jax.jit(lambda vv: jm.apply(vv, imgs, cams, dv, train=False))(v)
    tm = load_port(DINOv2MVSNet(**VARIANT), v)
    got = _run(tm, t(imgs), {k: t(c) for k, c in cams.items()}, t(dv))
    assert "log_var" not in got["stage1"] and "log_var" not in want["stage1"]
    for i in (2, 3, 4):
        s = f"stage{i}"
        assert_close(got[s]["log_var"], want[s]["log_var"], atol=1e-3, rtol=1e-3)
        assert_close(got[s]["prob_volume"], want[s]["prob_volume"], atol=1e-3, rtol=1e-3)
    assert_close(got["photometric_confidence"], want["photometric_confidence"], atol=1e-3,
                 rtol=1e-3)
    mask = well_conditioned(want["stage4"]["depth_values"], far=8.0)
    assert mask.mean() > 0.5
    np.testing.assert_allclose(got["refined_depth"].numpy()[mask],
                               np.asarray(want["refined_depth"])[mask], rtol=1e-3)


def temper_log_var_heads(variables, stages=(2, 3, 4), scale=0.1):
    """The log-variance channel of each stage's 2-channel head drawn `scale`
    times smaller: random weights put log_var near -10 at stage 4, where
    exp(-log_var) magnifies every rounding difference 20 000-fold; at 1/10
    it stays within a few units, as a trained head's does."""
    for s in stages:
        reg = variables["params"]["cascade"][f"stage{s}"]["cost_reg"]
        head = reg["Conv_1" if "Conv_1" in reg else "Conv_0"]
        head["kernel"] = head["kernel"].at[..., 1].multiply(scale)
        head["bias"] = head["bias"].at[1].multiply(scale)
    return variables


@pytest.fixture(scope="module")
def variant_steps():
    """The JAX make_train_step and the port's train_step on the variant
    flagship (log_var heads tempered), and the port's step again on images
    one ulp up (its rounding sensitivity)."""
    batch = conditioned_train_batch(seed=SEED)
    depth_types = VARIANT["depth_type"]
    jm = JaxFlagship(**VARIANT, remat_stages=False)
    variables = temper_log_var_heads(init_flax(jm, batch["imgs"], batch["cams"],
                                               batch["depth_values"], train=False))
    tx = optax.chain(capture_grads(), jax_make_optimizer(freeze_vit=True, **OPT))
    new, logs = jax.jit(make_train_step(jm, tx, depth_types=depth_types))(
        TrainState.create(variables, tx), jax.tree.map(jnp.asarray, batch))
    want = dict(logs={k: float(v) for k, v in logs.items() if k == "loss" or k.startswith("stage")},
                grads=from_jax_variables({"params": jax.device_get(new.opt_state[0])}),
                new=from_jax_variables({"params": jax.device_get(new.params),
                                        "batch_stats": jax.device_get(new.batch_stats)}))
    tm = DINOv2MVSNet(**VARIANT, remat_granularity="cost_reg")
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tb = to_torch(batch)
    with torch.no_grad():
        out = tm(tb["imgs"], tb["cams"], tb["depth_values"])
    ulp = dict(tb, imgs=torch.nextafter(tb["imgs"], tb["imgs"] + 1))
    port = {}
    for run, b in (("ulp", ulp), ("step", tb)):
        tm.load_state_dict(before)
        opt, sched = make_optimizer(tm, freeze_vit=True, **OPT)
        lr = opt.param_groups[0]["lr"]
        logs = train_step(tm, opt, sched, b, depth_types=depth_types)
        port[run] = {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}
    return want, dict(model=tm, out=out, logs=logs, before=before, ulp_grads=port["ulp"],
                      lr=lr, eps=opt.defaults["eps"])


def test_variant_train_step_losses(variant_steps):
    """Per-stage losses, the uncertainty terms of the reg stages among them,
    at rtol 1e-5. Conditioning: the CE stages hand on argmax depths clear of
    ties (test_torch_train_step.py's), and no gradient of the port's step
    moves by half the gradient tolerance when the images move one ulp (no
    ReLU or clip kink within rounding)."""
    want, port = variant_steps
    for i in (1, 2):
        top2 = port["out"][f"stage{i}"]["prob_volume"].topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        assert gap[gap > 0].min() > 1e-5, i
    grads = {n: p.grad for n, p in port["model"].named_parameters() if p.grad is not None}
    assert _grad_ratio(port["ulp_grads"], grads) <= 0.5
    assert {"stage3_uncertainty", "stage4_uncertainty"} <= set(want["logs"])
    assert set(want["logs"]) <= set(port["logs"])
    for k, v in want["logs"].items():
        np.testing.assert_allclose(float(port["logs"][k]), v, rtol=1e-5, err_msg=k)


def _module(name):
    return ".".join(name.split(".")[:2]) if name.startswith("cascade.") else name.split(".")[0]


def test_variant_train_step_gradients_and_update(variant_steps):
    """Gradients: every tensor of stages 1-3 (the log_var and reg stage 3
    among them) within 1e-3 of its largest entry + 5e-5 (test_torch_train_
    step.py's tolerance). Stage 4's, and those of the modules that feed it
    (encoder, decoder, ViT decoder, FMT), sum the backward of a 64 x 64 reg
    stage, where the JAX CPU step's fp32 BatchNorm sums are the larger error
    (test_stagenet_log_var_gradients_against_float64): they are held per
    top-level module, at a relative L2 distance of 1e-2. The SwiGLU blocks
    and both channels of the 2-channel heads take gradients. The running
    statistics at rtol 1e-4 / atol 2e-5. After AdamW: every parameter moved
    by AdamW's first step on its own gradient, -lr g / (|g| + eps), within
    1e-6; the tensors held one by one equal JAX's within 1e-6 where |g| is
    above the gradient tolerance, and every parameter is within 2 lr of
    JAX's."""
    want, port = variant_steps
    grads, new, before = want["grads"], want["new"], port["before"]
    model = port["model"]
    strict, sums = [], {}
    for name, p in model.named_parameters():
        w = grads[name].numpy()
        if name.startswith("vit."):
            assert p.grad is None and not w.any(), name
            continue
        g = p.grad.numpy()
        tol = 1e-3 * np.abs(w).max() + 5e-5
        if name.startswith(("cascade.stage1.", "cascade.stage2.", "cascade.stage3.")):
            assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
            strict.append(name)
            noisy = np.abs(w) < tol
            got, wn = p.detach().numpy(), new[name].numpy()
            np.testing.assert_allclose(got[~noisy], wn[~noisy], rtol=0, atol=1e-6, err_msg=name)
        d, n = sums.get(_module(name), (0.0, 0.0))
        sums[_module(name)] = (d + float(((g - w).astype(np.float64) ** 2).sum()),
                               n + float((w.astype(np.float64) ** 2).sum()))
        step = p.detach() - before[name]
        adam = -port["lr"] * p.grad / (p.grad.abs() + port["eps"])
        assert (step - adam).abs().max() <= 1e-6, name
        assert np.abs(p.detach().numpy() - new[name].numpy()).max() <= 2 * LR + 1e-6, name
    assert len(strict) > 120
    assert {"encoder", "decoder", "decoder_vit", "fmt", "cascade.stage4"} <= set(sums)
    for m, (d, n) in sums.items():
        assert (d / n) ** 0.5 <= 1e-2, (m, (d / n) ** 0.5)
    swiglu = [n for n, _ in model.named_parameters() if ".mlp.Dense_0" in n]
    assert any(n.startswith("decoder_vit.") for n in swiglu)
    assert any(n.startswith("fmt.") for n in swiglu)
    assert all(model.get_parameter(n).grad.abs().max() > 0 for n in swiglu)
    for s in (3, 4):  # the reg stages' 2-channel heads: both channels take a gradient
        reg = model.cascade.get_submodule(f"stage{s}").cost_reg
        head = getattr(reg, reg.final_name()).weight
        assert head.shape[0] == 2 and (head.grad.reshape(2, -1).abs().amax(1) > 0).all()
    sd = model.state_dict()
    for k in new:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=2e-5,
                                       err_msg=k)
            assert not torch.equal(sd[k], before[k]), k
