"""The comparison that decides `correct`: what the timed path served, held
to the plain float32 reference (reference/) run on the same inputs after the
window, with the program's model freed.

Eval: the first answer the window served for each of a seeded sample of
the pool's samples (its refined depth and confidence, and the logits of
every stage's probability volume, which the model returns beside them),
the reference run once over each at the timed sizes, in float32 with TF32
off. Numbers, each the worst over the sampled maps:
- depth_mae_itv: the mean over pixels of |depth - reference depth| in
  units of the sample's depth interval (the spacing of its hypotheses);
- conf_mae: the mean over pixels of |confidence - reference confidence|;
- logit_gap: the worst stage's mean |logit - reference logit| over the mean
  absolute deviation of the reference's logits (random weights leave the
  probabilities nearly flat, so depth and confidence move little with the
  arithmetic; the logits carry it).
Each number is compared with its limit in limits/<workload>.json; a
number whose limit is missing or is exceeded fails the run.
"""
from __future__ import annotations

import numpy as np
import torch

from . import weights
from .reference import model as ref_model
from .reference import ops as ref_ops


def reference_model(ctx):
    """The reference of the cell's configuration on the run's device, with
    the seed's weights drawn again."""
    ref_ops.PRECISION["mode"] = ctx.precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(ctx.device):
        net = ref_model.build(ctx.config["config"]["arch"]["args"])
    weights.draw_(net, ctx.seed)
    return net.eval()


def map_errors(served: list, ref: list, itv: float) -> dict:
    """served and ref: [depth, conf, stage1..stage4 logits] of one map."""
    out = {"depth_mae_itv": float(np.mean(np.abs(served[0] - ref[0]))) / itv,
           "conf_mae": float(np.mean(np.abs(served[1] - ref[1])))}
    gaps = [float(np.mean(np.abs(p - r)) / max(np.mean(np.abs(r - r.mean())), 1e-30))
            for p, r in zip(served[2:], ref[2:])]
    out["logit_gap"] = max(gaps)
    return out


def picked(ctx, n: int) -> list:
    """The pool indices whose first answer in the window is checked: a
    sample drawn from the seed."""
    rng = np.random.default_rng(ctx.seed + 17)
    k = min(ctx.traffic.get("compare", n), n)
    return sorted(rng.choice(n, size=k, replace=False).tolist())


def reference_answers(ctx, pool: list, indices) -> dict:
    """The reference's [depth, conf, stage logits...] for pool samples."""
    net = reference_model(ctx)
    conf_key = ctx.traffic["conf"]
    out_all = {}
    with torch.no_grad():
        for idx in indices:
            s, dev = pool[idx], ctx.device
            out = net(torch.from_numpy(s["imgs"]).to(dev),
                      {c: torch.from_numpy(v).to(dev) for c, v in s["cams"].items()},
                      torch.from_numpy(s["depth_values"]).to(dev), tuple(ctx.traffic["tmp"]))
            conf = (out["stage4"]["photometric_confidence"] if conf_key == "stage4"
                    else out["photometric_confidence"])
            arrays = [out["refined_depth"], conf] + [out[f"stage{k}"]["prob_volume_pre"]
                                                     for k in range(1, 5)]
            out_all[idx] = [a[0].float().cpu().numpy() for a in arrays]
            del out, conf, arrays
    del net
    ctx.free()
    return out_all


def judge(ctx, numbers: dict) -> list:
    """[(name, value, limit, ok)] for each number the cell's limits name (a
    number is correct at or below its limit); with no limits at all, every
    number, each failing (calibrate.py reads them so)."""
    out = []
    for name, value in numbers.items():
        if ctx.limits and name not in ctx.limits:
            continue
        limit = ctx.limits.get(name)
        ok = limit is not None and bool(np.isfinite(value)) and value <= limit
        out.append((name, value, limit, bool(ok)))
    return out


def eval_answers(ctx, answers: dict, pool: list, indices) -> list:
    """The checked samples' served answers against the reference's: each
    number the worst over the samples; a checked sample that was never
    served fails."""
    missing = [i for i in indices if i not in answers]
    if missing or not indices:
        return [("maps_unserved", float(len(missing)), 0.0, False)]
    ref = reference_answers(ctx, pool, indices)
    worst: dict = {}
    for idx in indices:
        dv = pool[idx]["depth_values"][0]
        for name, v in map_errors(answers[idx], ref[idx], float(dv[1] - dv[0])).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return judge(ctx, worst)

