"""Inputs for the checks that hold the port to a reference (the CPU parity
tests against the JAX package and chip_smoke.py's card-vs-CPU phases), kept
in one place so that both hold the same batch (numpy only), and the train
step of one rank of a (data, cv) layout that both run through
parallel.dist.launch (train_step_rank, which imports torch when called)."""
from __future__ import annotations

import numpy as np


def conditioned_train_batch(seed=0, b=1, v=3, h=64, w=64, dfull=48, near=4.0, far=5.0):
    """A train batch that two numerically different runs of the model can be
    compared on: images, in-view cameras (principal point at the centre,
    baselines of 0.4 along x, depth range 4-5), per-stage ground truth and
    80% masks. Every hypothesis stays positive and no CE stage hands on an
    argmax depth near a tie, so both runs take the same hypotheses at every
    stage."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(b, v, h, w, 3).astype(np.float32)
    cams = {}
    for s in range(4):
        scale = 0.125 * 2 ** s
        cam = np.zeros((b, v, 2, 4, 4), np.float32)
        for vi in range(v):
            c, sn = np.cos(0.02 * vi), np.sin(0.02 * vi)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
            ext[0, 3] = 0.4 * vi
            cam[:, vi, 0] = ext
            f = w * scale
            cam[:, vi, 1, :3, :3] = [[f, 0, w * scale / 2], [0, f, h * scale / 2], [0, 0, 1]]
        cams[f"stage{s + 1}"] = cam
    gt = {f"stage{i + 1}": rng.uniform(near, far, (b, h >> (3 - i), w >> (3 - i))).astype(
        np.float32) for i in range(4)}
    return {"imgs": imgs, "cams": cams,
            "depth_values": np.linspace(near, far, dfull, dtype=np.float32)[None].repeat(b, 0),
            "depth_gt": gt,
            "mask": {k: (rng.rand(*g.shape) > 0.2).astype(np.float32) for k, g in gt.items()}}


def well_conditioned(depth_values, far: float) -> np.ndarray:
    """[B, D, H, W] hypotheses -> [B, H, W] mask of the pixels whose
    hypotheses are all positive and below 4x the far depth. With random
    weights a later stage's inverse-depth band can cross zero inverse depth;
    there a hypothesis 1/inv is huge and the soft-argmax amplifies rounding
    by orders of magnitude, so depths are compared only where this holds."""
    dv = np.asarray(depth_values)
    return ((dv > 0) & (dv < 4 * far)).all(axis=1)


def inverse_depth_bounds(dmin: float, dmax: float, ndepths=(32, 16, 8, 4),
                         ratios=(4.0, 2.67, 1.5, 1.0)):
    """(lo, hi) that every hypothesis, and so every regressed depth, of the
    inverse-depth cascade lies in for a depth range [dmin, dmax]: stage 1
    spans it uniformly in inverse depth; stage k spans ratio_k previous
    inverse intervals either side of the previous depth, and its own
    interval is that span over D_k - 1."""
    lo_inv, hi_inv = 1.0 / dmax, 1.0 / dmin
    itv = (hi_inv - lo_inv) / (ndepths[0] - 1)
    ext = 0.0
    for nd, r in zip(ndepths[1:], ratios[1:]):
        ext += r * itv
        itv = 2 * r * itv / (nd - 1)
    return 1.0 / (hi_inv + ext), (1.0 / (lo_inv - ext) if lo_inv > ext else float("inf"))


def temper_log_var_heads(model, scale: float = 0.1) -> None:
    """Scale the log-variance channel (the second output) of every StageNet's
    uncertainty head of `model` by `scale`, in place. Random weights put
    log_var far from 0, where exp(-log_var) in the loss magnifies any two
    runs' rounding differences many thousandfold; at 1/10 it stays within a
    few units, as a trained head's does."""
    import torch

    from .models.stagenet import StageNet

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, StageNet) and m.log_var:
                head = getattr(m.cost_reg, m.cost_reg.final_name())
                head.weight[1] *= scale
                head.bias[1] *= scale


def batch_part(batch, part: int, parts: int):
    """Rows part * B / parts ... (part + 1) * B / parts of every array of a
    (nested) batch dict: the rows one data rank holds of a global batch."""
    if isinstance(batch, dict):
        return {k: batch_part(v, part, parts) for k, v in batch.items()}
    b = len(batch) // parts
    return batch[part * b:(part + 1) * b]


def train_step_rank(ctx, make_model, batch, mesh, state=None, opt_kwargs=None,
                    loss_kwargs=None, timed=0, probe=False):
    """One rank of a (n_data, n_cv) = `mesh` train step of `make_model()`
    (picklable: a class or a functools.partial) on its data part of the
    global `batch` (numpy), with `state` (or rank 0's seeded weights) on
    every rank; for parallel.dist.launch. Returns the step's logged losses
    and gradient norm, every gradient and the state after the update (on the
    CPU); with `probe`, the losses of a forward before the step (running
    statistics restored after it) as this rank's share of the global loss
    ("shares") and as the mean over its own pixels ("local"); with `timed`,
    the ms per step of that many more steps and the peak memory; and the
    kernel launches of the whole run."""
    import time

    import torch

    from .ops.cuda import launch_counts
    from .losses import multi_stage_loss
    from .parallel.dist import make_layout
    from .train.optim import make_optimizer
    from .train.step import train_step
    from .train.trainer import to_device

    n_data, n_cv = mesh
    layout = make_layout(n_data, n_cv, data_per_process=n_data)
    model = make_model().to(ctx.device).train()
    if state is not None:
        model.load_state_dict(state)
    layout.attach(model)
    layout.world.broadcast_(list(model.state_dict().values()))
    mine = to_device(batch_part(batch, layout.data_index, n_data), ctx.device)
    loss_kwargs = dict(loss_kwargs or {})
    out = {}
    if probe:
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            outputs = model(mine["imgs"], mine["cams"], mine["depth_values"])
            dv = mine["depth_values"]
            for name, group in (("shares", layout.data), ("local", None)):
                _, losses = multi_stage_loss(outputs, mine["depth_gt"], mine["mask"],
                                             dv[:, 1] - dv[:, 0], group=group, **loss_kwargs)
                out[name] = {k: float(v) for k, v in losses.items()}
        model.load_state_dict(before)
    opt, sched = make_optimizer(model, **(opt_kwargs or {}))
    logs = train_step(model, opt, sched, mine, layout=layout, **loss_kwargs)
    out["logs"] = {k: float(v) for k, v in logs.items()
                   if k in ("loss", "grad_norm") or k.startswith("stage")}
    out["grads"] = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                    if p.grad is not None}
    out["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
    if timed:
        cuda = ctx.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
        t0 = time.perf_counter()
        for _ in range(timed):
            train_step(model, opt, sched, mine, layout=layout, **loss_kwargs)
        if cuda:
            marks[1].record()
            torch.cuda.synchronize(ctx.device)
            out["ms_per_step"] = marks[0].elapsed_time(marks[1]) / timed
            out["peak_mem_gb"] = torch.cuda.max_memory_allocated(ctx.device) / 1e9
        else:
            out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed
    out["launches"] = launch_counts()
    return out
