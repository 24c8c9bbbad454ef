"""The port's optimizer against mvsformerplusplus_tpu/train/optim.py on CPU:
the warmup-cosine schedule at rtol 1e-6, and five two-group AdamW steps (with
and without the frozen ViT, with and without gradient clipping) on a toy
model against optax's make_optimizer fed the same gradients. The parameters
agree at rtol 1e-6 plus 1e-6 absolute: optax forms the bias correction
1 - 0.999^t in fp32, where the cancellation costs ~1e-5 of each update
(torch forms it in float64), and the five updates move a parameter by ~1e-2."""
import math

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax

from mvsformerplusplus_tpu.train import optim as jopt
from mvsformerplusplus_tpu_torch.train import optim as topt


@pytest.mark.parametrize("step", [0, 1, 250, 500, 5250, 9999, 10000])
def test_schedule(step):
    want = float(jopt.warmup_cosine_schedule(1e-3, 500, 10000, 0.01)(step))
    got = 1e-3 * topt.warmup_cosine(step, 500, 10000, 0.01)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_layer_decay_scales():
    assert topt.vit_layer_decay_scales(0.6, 5) == pytest.approx(jopt.vit_layer_decay_scales(0.6, 5))


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.vit = nn.Linear(3, 4)
        self.head = nn.Linear(4, 2)
        self.scale = nn.Parameter(torch.ones(2))


@pytest.mark.parametrize("freeze_vit", [True, False])
@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adamw_steps(freeze_vit, grad_clip):
    """Warmup of 2 steps, so step 0 moves nothing, then two rates: the main
    group at lr with no weight decay, the ViT at vit_lr with decay (or not at
    all when frozen)."""
    rng = np.random.RandomState(0)
    kw = dict(lr=1e-2, vit_lr=3e-3, weight_decay=0.1, min_lr_frac=0.01, warmup_steps=2,
              total_steps=8, freeze_vit=freeze_vit)
    model = Toy()
    model.vit.requires_grad_(not freeze_vit)
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tree = {"vit": {"weight": params["vit.weight"], "bias": params["vit.bias"]},
            "head": {"weight": params["head.weight"], "bias": params["head.bias"]},
            "scale": params["scale"]}
    tx = jopt.make_optimizer(grad_clip=grad_clip, **kw)
    state = tx.init(tree)
    opt, sched = topt.make_optimizer(model, **kw)
    trainable = [p for g in opt.param_groups for p in g["params"]]
    for _ in range(5):
        grads = {n: (rng.randn(*p.shape) * 0.7).astype(np.float32) for n, p in params.items()}
        if freeze_vit:  # the frozen ViT's gradients are zero in the JAX tree
            grads["vit.weight"][:] = 0
            grads["vit.bias"][:] = 0
        gtree = {"vit": {"weight": grads["vit.weight"], "bias": grads["vit.bias"]},
                 "head": {"weight": grads["head.weight"], "bias": grads["head.bias"]},
                 "scale": grads["scale"]}
        updates, state = tx.update(jax.tree.map(jnp.asarray, gtree), state, tree)
        tree = optax.apply_updates(tree, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy()) if p.requires_grad else None
        if grad_clip is not None:
            topt.clip_by_global_norm(trainable, grad_clip)
        opt.step()
        sched.step()
    want = {"vit.weight": tree["vit"]["weight"], "vit.bias": tree["vit"]["bias"],
            "head.weight": tree["head"]["weight"], "head.bias": tree["head"]["bias"],
            "scale": tree["scale"]}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    if freeze_vit:
        np.testing.assert_array_equal(model.vit.weight.detach().numpy(), params["vit.weight"])
        assert len(opt.param_groups) == 1
    assert opt.param_groups[0]["weight_decay"] == 0.0
    assert math.isclose(opt.param_groups[0]["lr"], 1e-2 * topt.warmup_cosine(5, 2, 8, 0.01))


def test_vit_grads_scaled_by_layer():
    """scale_vit_grads_by_layer hooks each trainable ViT parameter's
    gradient with the JAX package's per-layer scale (the same gradients the
    JAX wrapper hands its inner optimizer); a frozen ViT gets no hook."""
    class ViT(nn.Module):
        def __init__(self):
            super().__init__()
            self.patch_embed = nn.Linear(3, 3)
            self.blocks_0 = nn.Linear(3, 3)
            self.blocks_1 = nn.Linear(3, 3)
            self.norm = nn.LayerNorm(3)
            self.cls_token = nn.Parameter(torch.ones(1, 1, 3))

        def forward(self, x):
            return self.norm(self.blocks_1(self.blocks_0(self.patch_embed(x)))) + self.cls_token

    model = nn.Module()
    model.vit, model.head = ViT(), nn.Linear(3, 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 1, 3).astype(np.float32))

    def grads():
        model.zero_grad()
        model.head(model.vit(x)).sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    plain = grads()
    assert topt.scale_vit_grads_by_layer(model, 0.6, depth=2) == len(plain) - 2
    scaled = grads()
    scales = jopt.vit_layer_decay_scales(0.6, 2)
    for n, g in plain.items():
        parts = n.split(".")
        want = g * scales[parts[1]] if parts[0] == "vit" else g
        torch.testing.assert_close(scaled[n], want, rtol=1e-6, atol=0, msg=n)
    frozen = Toy()
    frozen.vit.requires_grad_(False)
    assert topt.scale_vit_grads_by_layer(frozen, 0.6) == 0
