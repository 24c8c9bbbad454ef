"""The PyTorch port's flagship DINOv2MVSNet eval forward against the JAX
package on CPU, on weights converted by convert.from_jax_variables; plus the
port's import boundary and its card-by-default entry point."""
import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu.config import Config as JaxConfig
from mvsformerplusplus_tpu.config import build_model as jax_build_model
from mvsformerplusplus_tpu.config import parse_override as jax_parse_override
from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu_torch.config import Config, build_model, load_config, parse_override
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.testing import well_conditioned
from tests.test_casmvs import make_inputs
from tests.test_mvsformer import TINY_DECODER_CFG, TINY_FMT_CFG, TINY_TRANSFORMER_CFG
from tests.torch_parity import assert_close, init_flax, load_port, t

REPO = Path(__file__).resolve().parents[1]

TINY = dict(feat_chs=(4, 8, 16, 32), vit_ch=48, vit_depth=3, vit_num_heads=2, out_ch=32,
            ndepths=(8, 4, 4, 4), groups=(4, 4, 4, 4), decoder_cfg=TINY_DECODER_CFG,
            fmt_config=TINY_FMT_CFG, transformer_config=TINY_TRANSFORMER_CFG,
            cost_reg_type=("PureTransformerCostReg", "Normal", "Normal", "Normal"),
            use_pe3d=True)


@pytest.fixture(scope="module")
def flagship_pair():
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    jm = JaxFlagship(**TINY, remat_stages=False)
    variables = init_flax(jm, imgs, cams, dv, train=False)
    want = jax.jit(lambda v: jm.apply(v, imgs, cams, dv, train=False))(variables)
    tm = load_port(DINOv2MVSNet(**TINY), variables)
    with torch.inference_mode():
        got = tm(t(imgs), {k: t(c) for k, c in cams.items()}, t(dv))
    return got, want


def _well_conditioned(want, stage="stage4"):
    """Depth is compared where testing.well_conditioned holds for the
    scene's far depth (8); the probabilities are compared everywhere."""
    mask = well_conditioned(want[stage]["depth_values"], far=8.0)
    assert mask.mean() > 0.5, mask.mean()
    return mask


def test_flagship_refined_depth(flagship_pair):
    got, want = flagship_pair
    mask = _well_conditioned(want)
    assert_close(got["refined_depth"].numpy()[mask], np.asarray(want["refined_depth"])[mask],
                 atol=0, rtol=1e-3)


def test_flagship_confidence(flagship_pair):
    got, want = flagship_pair
    assert_close(got["photometric_confidence"], want["photometric_confidence"], atol=1e-3,
                 rtol=0)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3", "stage4"])
def test_flagship_stage_outputs(flagship_pair, stage):
    got, want = flagship_pair
    mask = _well_conditioned(want, stage)
    assert_close(got[stage]["depth"].numpy()[mask], np.asarray(want[stage]["depth"])[mask],
                 atol=0, rtol=1e-3)
    assert_close(got[stage]["prob_volume"], want[stage]["prob_volume"], atol=1e-3, rtol=0)


def _port_sources():
    return sorted((REPO / "mvsformerplusplus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No module of the port and no line of chip_smoke.py imports jax, flax,
    the JAX package or the repo's tools, nor PIL or OpenCV (the card's
    machine has neither)."""
    banned = ("jax", "flax", "mvsformerplusplus_tpu", "tools", "PIL", "cv2")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_build_model_defaults_to_the_card(monkeypatch):
    """build_model with no device asks for CUDA and raises when it is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(REPO / "configs" / "mvsformerplusplus.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)


def test_build_model_rejects_unported_casmvs():
    cfg = load_config(REPO / "configs" / "casmvs.json")
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


TINY_ARCH_ARGS = dict(feat_chs=[4, 8, 16, 32], vit_ch=48, vit_depth=1, vit_num_heads=2, out_ch=32,
                      ndepths=[8, 4, 4, 4], base_ch=[4, 4, 4, 4],
                      dino_cfg=dict(decoder_cfg=TINY_DECODER_CFG), FMT_config=TINY_FMT_CFG,
                      transformer_config=list(TINY_TRANSFORMER_CFG),
                      cost_reg_type=["PureTransformerCostReg", "Normal", "Normal", "Normal"])


@pytest.mark.parametrize("remat", [{}, {"remat_granularity": "stage"},
                                   {"remat_granularity": "cost_reg", "remat_stages": False}],
                         ids=["default", "stage", "off"])
def test_build_model_reads_remat_from_the_config(remat):
    """arch.args.remat_stages / remat_granularity choose the cascade's
    checkpointing as the JAX build_model reads them ("cost_reg" unless the
    config says otherwise), with no argument from the caller."""
    cfg = Config({"arch": {"args": {**TINY_ARCH_ARGS, **remat}}})
    jm = jax_build_model(cfg, remat_stages=remat.get("remat_stages", True))
    tm = build_model(cfg, dtype=torch.float32, device="cpu", train=True)
    want = (jm.remat_stages and jm.remat_granularity == "cost_reg",
            jm.remat_stages and jm.remat_granularity == "stage")
    assert (tm.cascade.stage1.remat_cost_reg, tm.cascade.remat_whole_stage) == want
    assert tm.training and all(s.remat_cost_reg == want[0] for s in
                               (tm.cascade.stage2, tm.cascade.stage3, tm.cascade.stage4))


@pytest.mark.parametrize("log_var", [True, [False, False, True, False]], ids=["bare", "per_stage"])
def test_build_model_rejects_unported_log_var(log_var):
    """arch.args.log_var builds the JAX package's uncertainty head; the port
    has none yet and must say so instead of training another model."""
    cfg = Config({"arch": {"args": {**TINY_ARCH_ARGS, "log_var": log_var}}})
    with pytest.raises(NotImplementedError, match="log_var"):
        build_model(cfg, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("keys", [
    {}, {"warp_mode": "auto"}, {"warp_mode": "banded", "fold_depth": False, "warp_gy": 8},
    {"warp_mode": "pallas", "fold_depth": True, "warp_gy": 16, "banded_bwd": False},
    {"warp_mode": "xgrouped"}, {"warp_mode": "grouped"}, {"warp_mode": "folded"},
    {"warp_mode": ["banded", "pallas", "folded", "auto"], "fold_depth": [False, True, True, False],
     "warp_gy": [8, 16, 8, "auto"], "log_var": False}], ids=lambda k: str(k))
def test_build_model_accepts_every_jax_warp_key(keys):
    """Every value the JAX build_model takes passes (each is served by the
    exact warp); the JAX factory builds the same config."""
    cfg = Config({"arch": {"args": {**TINY_ARCH_ARGS, **keys}}})
    jax_build_model(JaxConfig(cfg))
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    assert isinstance(model, DINOv2MVSNet)


@pytest.mark.parametrize("keys", [{"warp_mode": "bilinear"}, {"warp_mode": ["banded"] * 3},
                                  {"fold_depth": "yes"}, {"warp_gy": 0}, {"warp_gy": 2.5},
                                  {"banded_bwd": "true"}, {"warp_mode": ["banded", "nope",
                                                                         "folded", "auto"]}],
                         ids=lambda k: str(k))
def test_build_model_rejects_unknown_warp_keys(keys):
    cfg = Config({"arch": {"args": {**TINY_ARCH_ARGS, **keys}}})
    with pytest.raises(ValueError, match="arch.args"):
        build_model(cfg, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("expr", ["optimizer;args;lr=1e-4", "trainer.epochs=3", "a;b=[1, 2]",
                                  "data_loader;0;args;datapath=/data/dtu", "x=true", "y=null",
                                  "z=a=b", 'w={"k": 1}'])
def test_parse_override_and_get_path_match_jax(expr):
    assert parse_override(expr) == jax_parse_override(expr)
    cfg = {"optimizer": {"args": {"lr": 1e-3}}, "data_loader": [{"args": {"datapath": "x"}}],
           "trainer": {"epochs": 1}}
    path, value = parse_override(expr)
    got, want = Config(json.loads(json.dumps(cfg))), JaxConfig(json.loads(json.dumps(cfg)))
    got.set_path(path, value)
    want.set_path(path, value)
    assert got == want
    for query in (path, "data_loader;0;args;datapath", "data_loader;-1;args", "data_loader;5",
                  "optimizer;nope;lr", "trainer;epochs;deeper"):
        assert got.get_path(query, "d") == want.get_path(query, "d")
