"""train/checkpoints.py and the Trainer's checkpoint, best, early-stop and
preemption logic, on a one-parameter model with the train step replaced by
a plain AdamW step (the flagship's step has its own tests):
- rotation keeps the newest epochs, model_best.pth holds the best epoch
  outside the rotation and serves it once its epoch file is gone;
- a restore keeps the caller's schedule and hyperparameters at the
  checkpoint's step;
- SIGINT mid-epoch saves an interrupted=True checkpoint at the step
  boundary and -r runs that epoch again; early stop after `early_stop`
  epochs without improvement."""
import json
import signal

import numpy as np
import pytest
import torch

from mvsformerplusplus_tpu_torch.train import trainer as trainer_mod
from mvsformerplusplus_tpu_torch.train.checkpoints import CheckpointManager
from mvsformerplusplus_tpu_torch.train.optim import make_optimizer, warmup_cosine


class One(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.register_buffer("seen", torch.zeros(()))


def _opt(model, total=20):
    return make_optimizer(model, lr=0.1, warmup_steps=2, total_steps=total, min_lr_frac=0.1)


def _step(model, optimizer, scheduler, micro_batches, **kw):
    optimizer.zero_grad()
    loss = (model.w ** 2).sum()
    loss.backward()
    optimizer.step()
    scheduler.step()
    model.seen += 1
    return {"loss": loss.detach(), "grad_norm": model.w.grad.norm()}


class Loader:
    def __init__(self, n, interrupt_at=None):
        self.n, self.interrupt_at = n, interrupt_at

    def steps_per_epoch(self):
        return self.n

    def epoch(self, e):
        for i in range(self.n):
            if (e, i) == self.interrupt_at:
                signal.raise_signal(signal.SIGINT)
            yield {"imgs": np.zeros((1, 1, 2, 2, 3), np.float32)}, (64, 64)


def test_rotation_best_and_restore(tmp_path):
    model = One()
    opt, sched = _opt(model)
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    bests = [mgr.save(e, model, opt, sched, step=10 * e, config={"k": e}, monitor_value=v)
             for e, v in enumerate([0.5, 0.3, 0.4, 0.45])]
    assert bests == [True, True, False, False]
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"checkpoint-epoch2.pth", "checkpoint-epoch3.pth", "model_best.pth",
                     "model_last.pth", "meta.json", "config.json"}
    assert json.loads((tmp_path / "meta.json").read_text()) == {
        "last_epoch": 3, "best_epoch": 1, "monitor_best": 0.3, "mode": "min", "interrupted": False}
    assert json.loads((tmp_path / "config.json").read_text()) == {"k": 3}
    again = CheckpointManager(tmp_path, max_to_keep=2)
    assert again.best_epoch() == 1 and again.latest_epoch() == 3
    assert again.load(1)["epoch"] == 1 and again.load()["epoch"] == 3
    with pytest.raises(FileNotFoundError):
        again.load(0)

    for _ in range(5):
        _step(model, opt, sched, None)
    mgr.save(4, model, opt, sched, step=5)
    fresh = One()
    fopt, fsched = _opt(fresh, total=40)  # a longer run resumes on its own schedule
    assert again.restore(fresh, fopt, fsched) == (4, 5)
    assert torch.equal(fresh.w, model.w) and fresh.seen == 5
    assert fsched.last_epoch == 5
    assert fopt.param_groups[0]["lr"] == pytest.approx(0.1 * warmup_cosine(5, 2, 40, 0.1))
    assert torch.equal(fopt.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])


def test_preemption_and_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "train_step_accum", _step)
    model = One()
    opt, sched = _opt(model)
    tr = trainer_mod.Trainer(model, Loader(4, interrupt_at=(1, 2)), opt, sched,
                             save_dir=tmp_path, logging_every=1)
    before = signal.getsignal(signal.SIGINT)
    logged = tr.train(epochs=3)
    meta = json.loads((tmp_path / "checkpoints" / "meta.json").read_text())
    # the signal came while the loader fetched step 2 of epoch 1: that step
    # ran, then the interrupt checkpoint was saved and train returned
    assert (meta["last_epoch"], meta["interrupted"]) == (1, True)
    assert tr.global_step == 7 and logged[-1]["step"] == 7
    assert signal.getsignal(signal.SIGINT) is before  # restored

    model2 = One()
    opt2, sched2 = _opt(model2)
    tr2 = trainer_mod.Trainer(model2, Loader(4), opt2, sched2, save_dir=tmp_path, logging_every=1)
    assert tr2.resume() == 1  # the interrupted epoch runs again
    assert tr2.global_step == 7 and sched2.last_epoch == 7 and model2.seen == 7
    tr2.train(epochs=3, start_epoch=1)
    assert [s["epoch"] for s in tr2.epoch_stats] == [1, 2] and tr2.global_step == 15
    assert not json.loads((tmp_path / "checkpoints" / "meta.json").read_text())["interrupted"]


def test_early_stop(monkeypatch):
    """mean_error rises every epoch after the first: with early_stop=2 the
    run stops after epoch 2."""
    monkeypatch.setattr(trainer_mod, "train_step_accum", _step)
    validations = []
    monkeypatch.setattr(trainer_mod, "eval_step", lambda model, batch, interval_norm: {
        "mean_error": torch.tensor(float(len(validations)))})

    class Val:
        def epoch(self, e):
            validations.append(e)
            yield {"imgs": np.zeros((1, 1, 2, 2, 3), np.float32)}, (64, 64)

    model = One()
    tr = trainer_mod.Trainer(model, Loader(1), *_opt(model), val_loader=Val(), early_stop=2)
    tr.train(epochs=10)
    assert [s["epoch"] for s in tr.epoch_stats] == [0, 1, 2]
    assert [v["metrics"]["mean_error"] for v in tr.val_stats] == [1.0, 2.0, 3.0]
    assert tr.ckpt.best_epoch() == 0
