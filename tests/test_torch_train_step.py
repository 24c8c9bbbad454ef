"""One train step of the port's tiny flagship against the JAX package's
make_train_step on CPU, from the same converted weights and batch: per-stage
losses, every parameter's gradient, the BatchNorm running statistics and the
parameters after the two-group AdamW update; with the cascade's remat off,
at "cost_reg" and at "stage" granularity (the BatchNorm statistics pin the
running update to one per step: a checkpoint replay must not apply it again),
and the frozen ViT untouched.

Conditioning. CE stages hand their argmax depth to the next stage, so a
pixel whose two best hypotheses are within rounding of each other can pick
another depth in the two frameworks and change the later stages. The batch
(testing.conditioned_train_batch) is a scene 4-5 units away seen by in-view cameras, where every
hypothesis stays positive and no stage is near such a tie at the scale of
the two frameworks' differences; the test asserts both before comparing.
The JAX side on CPU sums the BatchNorm statistics in sequential fp32 (about
1e-4 relative error in a variance, against float64), which reaches the
gradients of the visibility heads; gradients are held at 1e-3 of each
tensor's largest entry plus 5e-5 absolute (the largest gradient is ~1.2).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformerplusplus_tpu.models.mvsformer import DINOv2MVSNet as JaxFlagship
from mvsformerplusplus_tpu.train.optim import make_optimizer as jax_make_optimizer
from mvsformerplusplus_tpu.train.step import TrainState, make_train_step
from mvsformerplusplus_tpu_torch.convert import from_jax_variables
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from mvsformerplusplus_tpu_torch.train.step import train_step
from tests.test_torch_flagship import TINY
from tests.torch_parity import init_flax, t

LR = 1e-3
OPT = dict(lr=LR, warmup_steps=0, total_steps=10)


def to_torch(batch):
    return {k: to_torch(v) if isinstance(v, dict) else t(v) for k, v in batch.items()}


def capture_grads():
    """An optax stage that passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


@pytest.fixture(scope="module")
def jax_step():
    batch = conditioned_train_batch()
    jm = JaxFlagship(**TINY, remat_stages=False)
    variables = init_flax(jm, batch["imgs"], batch["cams"], batch["depth_values"], train=False)
    tx = optax.chain(capture_grads(), jax_make_optimizer(freeze_vit=True, **OPT))
    state = TrainState.create(variables, tx)
    step = jax.jit(make_train_step(jm, tx))
    new, logs = step(state, jax.tree.map(jnp.asarray, batch))
    return dict(batch=batch, variables=variables,
                logs={k: float(v) for k, v in logs.items() if k == "loss" or k.startswith("stage")},
                grads=from_jax_variables({"params": jax.device_get(new.opt_state[0])}),
                new=from_jax_variables({"params": jax.device_get(new.params),
                                        "batch_stats": jax.device_get(new.batch_stats)}))


@pytest.fixture(scope="module", params=["off", "cost_reg", "stage"])
def port_step(request, jax_step):
    gran = request.param
    tm = DINOv2MVSNet(**TINY, remat_stages=gran != "off",
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


def test_batch_is_well_conditioned(port_step):
    """Every hypothesis is positive and below 4x the far depth, and at
    stages 1-3 the two best hypotheses of a pixel are either tied exactly
    (a tie that both frameworks break to the first index) or at least 1e-5
    apart in probability, above the frameworks' differences (< 5e-6)."""
    out = port_step["out"]
    for i in range(1, 5):
        dv = out[f"stage{i}"]["depth_values"]
        assert ((dv > 0) & (dv < 20)).all()
    for i in range(1, 4):
        top2 = out[f"stage{i}"]["prob_volume"].topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        assert gap[gap > 0].min() > 1e-5, i


def test_stage_losses(jax_step, port_step):
    for k, want in jax_step["logs"].items():
        np.testing.assert_allclose(float(port_step["logs"][k]), want, rtol=1e-5, err_msg=k)


def test_gradients(jax_step, port_step):
    grads = jax_step["grads"]
    checked = 0
    for name, p in port_step["model"].named_parameters():
        want = grads[name].numpy()
        if name.startswith("vit."):
            assert p.grad is None and not p.requires_grad, name
            assert not want.any(), name
            continue
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max() + 5e-5, (name, err, np.abs(want).max())
        checked += 1
    assert checked > 300


def test_batch_norm_running_stats(jax_step, port_step):
    """Biased batch variance (flax), one update per step whatever the remat."""
    new, sd = jax_step["new"], port_step["model"].state_dict()
    names = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert len(names) > 80
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=k)
        assert not torch.equal(sd[k], port_step["before"][k]), k


def test_params_after_update(jax_step, port_step):
    """AdamW's first step moves each entry by -lr * g / (|g| + eps) ~ -lr *
    sign(g); where |g| is within the two frameworks' gradient noise the sign
    may differ, so those entries may be up to 2 lr apart. The frozen ViT and
    the main group's zero weight decay leave the rest exact."""
    new, grads, before = jax_step["new"], jax_step["grads"], port_step["before"]
    for name, p in port_step["model"].named_parameters():
        got, want = p.detach().numpy(), new[name].numpy()
        if name.startswith("vit."):
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        noisy = np.abs(grads[name].numpy()) < 5e-5
        np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(got[noisy] - want[noisy]).max(initial=0) <= 2 * LR + 1e-6, name
