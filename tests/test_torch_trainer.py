"""The port's Trainer on CPU with the tiny flagship: two steps from a loader
with the JAX TrainLoader's interface, each batch of 2 split into micro-batches
of 1 by scale_batch_map. The update must apply the mean of the micro-batch
gradients (recomputed here one micro-batch at a time from a copy of the
model, the BatchNorm statistics carried from one to the next), and the log
must carry the per-stage losses. fp32, so the two agree to rounding (1e-6)."""
import copy

import numpy as np
import torch

from mvsformerplusplus_tpu_torch.config import init_weights
from mvsformerplusplus_tpu_torch.losses import multi_stage_loss
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
from mvsformerplusplus_tpu_torch.train.trainer import Trainer, split_micro, to_device
from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch
from tests.test_torch_flagship import TINY


class Loader:
    """In-memory loader: `epoch(e)` yields (batch, crop_hw)."""

    def __init__(self, batches):
        self.batches = batches

    def steps_per_epoch(self):
        return len(self.batches)

    def epoch(self, e):
        for b in self.batches:
            yield {**b, "scan": "scan1"}, (64, 64)


def test_trainer_accumulates_the_mean_of_micro_batches():
    model = DINOv2MVSNet(**TINY).train()
    init_weights(model, torch.Generator().manual_seed(0))
    ref = copy.deepcopy(model)
    batches = [conditioned_train_batch(seed=s, b=2) for s in (0, 1)]
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    opt, sched = make_optimizer(model, **opt_kw)
    trainer = Trainer(model, Loader(batches), opt, sched, scale_batch_map={"64": 1},
                      logging_every=1)
    assert trainer._micro_count((64, 64), 2) == 2
    logged = trainer.train(epochs=1, max_steps=2)

    ref_opt, ref_sched = make_optimizer(ref, **opt_kw)
    params = [p for g in ref_opt.param_groups for p in g["params"]]
    for batch in batches:
        micro_grads = []
        for mb in split_micro(to_device(batch, "cpu"), 2):
            ref.zero_grad(set_to_none=True)
            out = ref(mb["imgs"], mb["cams"], mb["depth_values"])
            dv = mb["depth_values"]
            loss, _ = multi_stage_loss(out, mb["depth_gt"], mb["mask"], dv[:, 1] - dv[:, 0])
            loss.backward()
            micro_grads.append([p.grad.clone() for p in params])
        for p, gs in zip(params, zip(*micro_grads)):
            p.grad = (gs[0] + gs[1]) / 2
        ref_opt.step()
        ref_sched.step()

    got = dict(model.named_parameters())
    for name, p in ref.named_parameters():
        if p.grad is None:
            assert got[name].grad is None, name
            continue
        torch.testing.assert_close(got[name].grad, p.grad, rtol=1e-5, atol=1e-6, msg=name)
        torch.testing.assert_close(got[name].detach(), p.detach(), rtol=1e-6, atol=1e-6,
                                   msg=name)
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=1e-6, atol=1e-6, msg=k)
    assert [e["step"] for e in logged] == [1, 2] and all(e["micro"] == 2 for e in logged)
    for e in logged:
        assert {"loss", "grad_norm", "stage1", "stage2", "stage3", "stage4"} <= set(e)
        assert np.isfinite([e["loss"], e["grad_norm"]]).all()
