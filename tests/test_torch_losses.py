"""The port's losses against mvsformerplusplus_tpu/losses.py on CPU: values
and gradients (with respect to the logits or the depth) against jax.grad,
rtol 1e-5 in fp32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformerplusplus_tpu import losses as jl
from mvsformerplusplus_tpu_torch import losses as tl
from tests.torch_parity import t

RTOL = 1e-5


def _hypotheses(rng, b, d, h, w, inverse):
    """Per-pixel hypothesis bands, descending in depth under inverse_depth."""
    lo = rng.uniform(400, 500, (b, 1, h, w))
    step = rng.uniform(2, 4, (b, 1, h, w))
    dv = lo + step * np.arange(d)[None, :, None, None]
    return (dv[:, ::-1] if inverse else dv).astype(np.float32)


def _case(seed, inverse, b=2, d=8, h=6, w=10):
    rng = np.random.RandomState(seed)
    dv = _hypotheses(rng, b, d, h, w, inverse)
    logits = rng.randn(b, d, h, w).astype(np.float32) * 2
    # ground truth across the band and beyond both edges
    gt = rng.uniform(390, 540, (b, h, w)).astype(np.float32)
    mask = (rng.rand(b, h, w) > 0.25).astype(np.float32)
    return logits, dv, gt, mask


def _grad_t(fn, x):
    x = t(x).requires_grad_(True)
    out = fn(x)
    out.backward()
    return out.item(), x.grad.numpy()


@pytest.mark.parametrize("inverse", [True, False])
def test_ce_depth_loss(inverse):
    logits, dv, gt, mask = _case(0, inverse)
    want, want_g = jax.value_and_grad(lambda x: jl.ce_depth_loss(x, dv, gt, mask, inverse))(
        jnp.asarray(logits))
    got, got_g = _grad_t(lambda x: tl.ce_depth_loss(x, t(dv), t(gt), t(mask), inverse), logits)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("clip,log_var", [(None, False), ("dynamic", False), ("dynamic", True)])
def test_reg_depth_loss(clip, log_var):
    rng = np.random.RandomState(1)
    _, dv, gt, mask = _case(1, True)
    est = (gt + rng.randn(*gt.shape) * 15).astype(np.float32)
    interval = np.array([2.65, 3.1], np.float32)
    lv = rng.randn(*gt.shape).astype(np.float32) * 0.3 if log_var else None

    def jfn(x):
        return jl.reg_depth_loss(x, gt, mask, interval, dv, True, clip,
                                 None if lv is None else jnp.asarray(lv))[0]

    def tfn(x):
        return tl.reg_depth_loss(x, t(gt), t(mask), t(interval), t(dv), True, clip,
                                 None if lv is None else t(lv))[0]

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(est))
    got, got_g = _grad_t(tfn, est)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=RTOL, atol=1e-9)


def test_multi_stage_loss_mixes_ce_and_reg():
    stages = {}
    for i, seed in enumerate((2, 3, 4)):
        logits, dv, gt, mask = _case(seed, True, h=6 * 2 ** i, w=10 * 2 ** i)
        stages[f"stage{i + 1}"] = (logits, dv, gt, mask)
    types, weights = ("ce", "ce", "reg"), (1.0, 0.7, 2.0)
    interval = np.array([2.65, 2.65], np.float32)
    est3 = (stages["stage3"][2] + 10).astype(np.float32)

    def outputs(arr, logits_fn):
        out = {k: {"prob_volume_pre": logits_fn(v[0]), "depth_values": arr(v[1])}
               for k, v in stages.items()}
        out["stage3"]["depth"] = arr(est3)
        return out

    gts = {k: v[2] for k, v in stages.items()}
    masks = {k: v[3] for k, v in stages.items()}
    x1 = stages["stage1"][0]

    def jfn(x):
        out = outputs(jnp.asarray, jnp.asarray)
        out["stage1"]["prob_volume_pre"] = x
        return jl.multi_stage_loss(out, gts, masks, interval, types, weights)

    (want, want_d), want_g = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x1))
    xt = t(x1).requires_grad_(True)
    out = outputs(t, t)
    out["stage1"]["prob_volume_pre"] = xt
    got, got_d = tl.multi_stage_loss(out, {k: t(v) for k, v in gts.items()},
                                     {k: t(v) for k, v in masks.items()}, t(interval), types,
                                     weights)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert set(got_d) == set(want_d)
    for k in want_d:
        np.testing.assert_allclose(got_d[k].item(), float(want_d[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=1e-9)
