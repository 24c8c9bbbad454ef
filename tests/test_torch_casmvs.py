"""The port's CasMVSNet against the JAX package's on CPU, on weights
converted by convert.from_jax_variables: the eval forward (depth at rtol
1e-3 where testing.well_conditioned holds, probabilities and confidence
everywhere at atol 1e-3), one train step against the JAX make_train_step
on testing.conditioned_train_batch (per-stage losses, every gradient, the
BatchNorm running statistics, the parameters after AdamW; with the
cascade's remat off, at "cost_reg" and at "stage"), the converted
checkpoint (convert.load_npz) of CasMVSNet's tree, and the arguments
build_model gives it against the JAX build_model's.

Tolerances and conditioning are those of test_torch_flagship.py and
test_torch_train_step.py (ROADMAP.md §3, Trap 3): the batch keeps every
CE stage's argmax far from a tie, and the test asserts that it does."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvsformerplusplus_tpu.config import Config as JaxConfig
from mvsformerplusplus_tpu.config import build_model as jax_build_model
from mvsformerplusplus_tpu.models.casmvs import CasMVSNet as JaxCasMVSNet
from mvsformerplusplus_tpu.train.optim import make_optimizer as jax_make_optimizer
from mvsformerplusplus_tpu.train.step import TrainState, make_train_step
from mvsformerplusplus_tpu_torch.config import Config, build_model, init_weights, load_config
from mvsformerplusplus_tpu_torch.convert import from_jax_variables, load_npz
from mvsformerplusplus_tpu_torch.models import casmvs
from mvsformerplusplus_tpu_torch.models.casmvs import CasMVSNet
from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch, well_conditioned
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from mvsformerplusplus_tpu_torch.train.step import train_step
from tests.test_casmvs import make_inputs
from tests.test_torch_train_step import LR, OPT, capture_grads, to_torch
from tests.torch_parity import assert_close, init_flax, load_port, t
from tools.convert_reference import save_npz

REPO = Path(__file__).resolve().parents[1]
TINY = dict(feat_chs=(4, 8, 16, 32), ndepths=(8, 4, 4, 4), groups=(4, 4, 4, 4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small CPU ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forward_pair():
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    jm = JaxCasMVSNet(**TINY, remat_stages=False)
    variables = init_flax(jm, imgs, cams, dv, train=False)
    want = jax.jit(lambda v: jm.apply(v, imgs, cams, dv, train=False))(variables)
    tm = load_port(CasMVSNet(**TINY), variables)
    with torch.inference_mode():
        got = tm(t(imgs), {k: t(c) for k, c in cams.items()}, t(dv))
    return got, want, variables


def _conditioned(want, stage):
    mask = well_conditioned(want[stage]["depth_values"], far=8.0)
    assert mask.mean() > 0.5, mask.mean()
    return mask


def test_casmvs_refined_depth_and_confidence(forward_pair):
    got, want, _ = forward_pair
    mask = _conditioned(want, "stage4")
    assert_close(got["refined_depth"].numpy()[mask], np.asarray(want["refined_depth"])[mask],
                 atol=0, rtol=1e-3)
    assert_close(got["photometric_confidence"], want["photometric_confidence"], atol=1e-3,
                 rtol=0)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3", "stage4"])
def test_casmvs_stage_outputs(forward_pair, stage):
    got, want, _ = forward_pair
    mask = _conditioned(want, stage)
    assert_close(got[stage]["depth"].numpy()[mask], np.asarray(want[stage]["depth"])[mask],
                 atol=0, rtol=1e-3)
    assert_close(got[stage]["prob_volume"], want[stage]["prob_volume"], atol=1e-3, rtol=0)


def test_casmvs_load_npz(forward_pair, tmp_path):
    """The npz tools/convert_reference.py writes for CasMVSNet's tree (an
    encoder, a decoder and a cascade, no ViT) loads strictly, every tensor
    as from_jax_variables converts it; a partial one (the reference's
    checkpoints convert only the submodules they hold) loads its tensors
    and leaves the model's others as they were."""
    _, _, variables = forward_pair
    path = tmp_path / "casmvs.npz"
    save_npz(variables["params"], variables["batch_stats"], path)
    model = CasMVSNet(**TINY)
    want = from_jax_variables(variables)
    assert load_npz(path, model) == len(want)
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    fpn = {c: {k: v for k, v in variables[c].items() if k != "cascade"}
           for c in ("params", "batch_stats")}
    save_npz(fpn["params"], fpn["batch_stats"], tmp_path / "fpn.npz")
    model = CasMVSNet(**TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_npz(tmp_path / "fpn.npz", model) == len(from_jax_variables(fpn))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k] if not k.startswith("cascade.") else before[k]), k


@pytest.fixture(scope="module")
def jax_step():
    batch = conditioned_train_batch()
    jm = JaxCasMVSNet(**TINY, remat_stages=False)
    variables = init_flax(jm, batch["imgs"], batch["cams"], batch["depth_values"], train=False)
    tx = optax.chain(capture_grads(), jax_make_optimizer(freeze_vit=True, **OPT))
    state = TrainState.create(variables, tx)
    new, logs = jax.jit(make_train_step(jm, tx))(state, jax.tree.map(jnp.asarray, batch))
    return dict(batch=batch, variables=variables,
                logs={k: float(v) for k, v in logs.items() if k == "loss" or k.startswith("stage")},
                grads=from_jax_variables({"params": jax.device_get(new.opt_state[0])}),
                new=from_jax_variables({"params": jax.device_get(new.params),
                                        "batch_stats": jax.device_get(new.batch_stats)}))


@pytest.fixture(scope="module", params=["off", "cost_reg", "stage"])
def port_step(request, jax_step):
    gran = request.param
    tm = CasMVSNet(**TINY, remat_stages=gran != "off",
                   remat_granularity="stage" if gran == "off" else gran)
    tm.load_state_dict(from_jax_variables(jax_step["variables"]), strict=True)
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    batch = to_torch(jax_step["batch"])
    with torch.no_grad():
        out = tm(batch["imgs"], batch["cams"], batch["depth_values"])
    tm.load_state_dict(before)  # undo the running-stat update of that forward
    opt, sched = make_optimizer(tm, freeze_vit=True, **OPT)
    logs = train_step(tm, opt, sched, batch)
    return dict(model=tm, before=before, out=out, logs=logs)


def test_casmvs_batch_is_well_conditioned(port_step):
    out = port_step["out"]
    for i in range(1, 5):
        dv = out[f"stage{i}"]["depth_values"]
        assert ((dv > 0) & (dv < 20)).all()
    for i in range(1, 4):
        top2 = out[f"stage{i}"]["prob_volume"].topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        assert gap[gap > 0].min() > 1e-5, i


def test_casmvs_step_losses(jax_step, port_step):
    assert set(jax_step["logs"]) == {"loss", "stage1", "stage2", "stage3", "stage4"}
    for k, want in jax_step["logs"].items():
        np.testing.assert_allclose(float(port_step["logs"][k]), want, rtol=1e-5, err_msg=k)


def test_casmvs_step_gradients(jax_step, port_step):
    grads = jax_step["grads"]
    names = [n for n, _ in port_step["model"].named_parameters()]
    assert sorted(names) == sorted(grads)
    for name, p in port_step["model"].named_parameters():
        want = grads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 5e-5, (name, err, np.abs(want).max())


def test_casmvs_step_batch_norm_and_params(jax_step, port_step):
    """The running statistics move once per step (flax's biased variance);
    AdamW's first step moves each entry by about -lr sign(g), so entries
    whose |g| lies within the frameworks' gradient noise may be up to 2 lr
    apart, the rest within 1e-6."""
    new, grads, before = jax_step["new"], jax_step["grads"], port_step["before"]
    sd = port_step["model"].state_dict()
    stats = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=k)
        assert not torch.equal(sd[k], before[k]), k
    for name, p in port_step["model"].named_parameters():
        got, want = p.detach().numpy(), new[name].numpy()
        noisy = np.abs(grads[name].numpy()) < 5e-5
        np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(got[noisy] - want[noisy]).max(initial=0) <= 2 * LR + 1e-6, name


@pytest.fixture
def casmvs_kwargs(monkeypatch):
    """The keyword arguments build_model hands the port's CasMVSNet."""
    seen = {}

    class Spy(CasMVSNet):
        def __init__(self, **kwargs):
            seen.update(kwargs)
            super().__init__(**kwargs)

    monkeypatch.setattr(casmvs, "CasMVSNet", Spy)
    return seen


@pytest.mark.parametrize("args", [{}, {"remat_granularity": "stage"},
                                  {"feat_chs": [4, 8, 16, 32], "ndepths": [8, 4, 4, 4],
                                   "base_ch": 4, "inverse_depth": False,
                                   "depth_interals_ratio": [2.0, 2.0, 1.0, 1.0]}])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_build_model_arguments_match_jax(casmvs_kwargs, args, dtype):
    """configs/casmvs.json (with `args` over its arch.args) builds
    CasMVSNet with the JAX build_model's arguments: its common set, the
    caller's dtype, remat_granularity from the config ("cost_reg" unless
    it says otherwise) and the class's remat_stages."""
    cfg = load_config(REPO / "configs" / "casmvs.json")
    cfg["arch"]["args"].update(args)
    model = build_model(cfg, dtype=getattr(torch, dtype), device="cpu")
    jm = jax_build_model(JaxConfig(cfg), dtype=getattr(jnp, dtype))
    assert isinstance(jm, JaxCasMVSNet) and isinstance(model, CasMVSNet)
    assert casmvs_kwargs.pop("dtype") == getattr(torch, dtype)
    for k, v in casmvs_kwargs.items():
        assert v == getattr(jm, k), k
    assert set(casmvs_kwargs) == {"feat_chs", "ndepths", "depth_intervals_ratio",
                                  "inverse_depth", "depth_type", "groups", "cost_reg_type",
                                  "log_var", "transformer_config", "use_pe3d",
                                  "remat_granularity"}
    assert jm.remat_stages and model.cascade.remat_stages
    assert model.cascade.remat_granularity == jm.remat_granularity
    assert not hasattr(model, "vit") and not model.training


def test_build_model_casmvs_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(load_config(REPO / "configs" / "casmvs.json"))


def test_build_model_casmvs_runs_the_config_tree(tmp_path):
    """build_model's CasMVSNet takes a flax CasMVSNet's variables built
    from the same config (from_jax_variables, strict)."""
    cfg = Config({"arch": {"args": {"model_type": "casmvs", "feat_chs": [4, 8, 16, 32],
                                    "ndepths": [8, 4, 4, 4], "base_ch": [4, 4, 4, 4]}}})
    imgs, cams, dv = make_inputs(np.random.RandomState(1), h=64, w=64)
    jm = jax_build_model(JaxConfig(cfg), dtype=jnp.float32)
    variables = init_flax(jm, imgs, cams, dv, train=False)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
