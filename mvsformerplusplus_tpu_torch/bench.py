"""The benchmark entry point: the flagship DINOv2MVSNet on one card
(counterpart of the repo's bench.py, which measures the JAX package on a
TPU).

    python -m mvsformerplusplus_tpu_torch.bench

Two workloads, one JSON line with bench.py's keys:
- eval: the DTU eval protocol (5 views, 1152x1536, 192 depth hypotheses,
  bf16) through DINOv2MVSNet(dtype=bf16, remat_stages=False) with the
  class's defaults, as bench.py builds it: one first call, then 5 calls
  between CUDA events -> depth maps/s (the headline metric), ms per map and
  MFU;
- train: the DTU MS training protocol (B=2, 5 views, 512x640, 192
  depths, bf16, frozen ViT, remat of the cost regularizers) through
  train.optim.make_optimizer(total_steps=10000, warmup_steps=500,
  freeze_vit=True) and train.step.train_step at the defaults of the JAX
  make_train_step, the batch on the card once: one first step, then 3
  steps between CUDA events -> steps/s, samples/s and MFU.

Weights are drawn from `seed` as config.build_model draws them
(config.init_weights). Both workloads run on the card; without CUDA the
entry points raise unless the caller passes device="cpu".

MFU = products of one call (ops.cuda.flops: matmuls, convolutions and
attention, the hand-written kernels by formula, 2 per multiply-add) / its
time / the card's dense bf16 peak (PEAK_FLOPS, by
torch.cuda.get_device_name(); an unknown card raises). Elementwise work is
not counted, where bench.py's XLA count on a TPU counts it: the two MFUs
are not to be compared. Each count comes from one more call, outside the
timed ones.

Keys that differ from bench.py's: `first_call_s` and `train_first_call_s`
(bench.py's compile_s and train_compile_s) are the seconds of the first
call on the host clock up to a synchronize: the kernels' build or load at
first use, plus the first run. `power_limit_w` is the card's, from
nvidia-smi; `backend` is "cuda".
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_MAPS_PER_SEC = 1.0

# dense bf16 tensor-core peak by torch.cuda.get_device_name() (NVIDIA's
# data sheet, at the card's full power limit)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}

# bench.py's two flax models: the class's defaults but these
EVAL_ARGS = dict(remat_stages=False)
TRAIN_ARGS = dict(remat_stages=True, remat_granularity="cost_reg")
OPT_ARGS = dict(total_steps=10000, warmup_steps=500, freeze_vit=True)
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def make_dtu_eval_batch(b=1, v=5, h=1152, w=1536, dfull=192, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(b, v, h, w, 3).astype(np.float32)
    cams = {}
    for s in range(4):
        scale = 0.125 * 2**s
        cam = np.zeros((b, v, 2, 4, 4), np.float32)
        for vi in range(v):
            ang = 0.06 * vi
            c, sn = np.cos(ang), np.sin(ang)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
            ext[0, 3] = 40.0 * vi  # DTU-scale baselines (mm)
            cam[:, vi, 0] = ext
            f = 2892.33 * scale * (w / 1600.0)  # DTU-like focal scaled to crop
            cam[:, vi, 1, :3, :3] = np.array(
                [[f, 0, w * scale / 2], [0, f, h * scale / 2], [0, 0, 1]], np.float32)
        cams[f"stage{s + 1}"] = cam
    # DTU depth range: 425mm + D * 2.5mm * 1.06
    depth_values = (425.0 + np.arange(dfull, dtype=np.float32) * 2.5 * 1.06)[None].repeat(b, 0)
    return imgs, cams, depth_values


def make_train_batch(b=2, v=5, h=512, w=640, dfull=192):
    rng = np.random.RandomState(1)
    imgs, cams, dv = make_dtu_eval_batch(b=b, v=v, h=h, w=w, dfull=dfull, seed=1)
    batch = {"imgs": imgs, "cams": cams, "depth_values": dv}
    batch["depth_gt"] = {
        f"stage{i + 1}": rng.uniform(450, 900, (b, h // (8 >> i), w // (8 >> i))).astype(np.float32)
        for i in range(4)
    }
    batch["mask"] = {k: (rng.rand(*g.shape) > 0.2).astype(np.float32)
                     for k, g in batch["depth_gt"].items()}
    return batch


def check_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA one raises without CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    return device


def peak_flops(kind: str) -> float:
    """The dense bf16 peak of the card named `kind`; raises for a card
    PEAK_FLOPS does not list."""
    if kind not in PEAK_FLOPS:
        raise ValueError(f"bench: no bf16 peak for {kind!r} in PEAK_FLOPS "
                         f"({', '.join(PEAK_FLOPS)}); add the card's data-sheet peak")
    return PEAK_FLOPS[kind]


def power_limit_w(device: torch.device) -> float:
    """The card's power limit in watts, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                          "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def build(train: bool, dtype=torch.bfloat16, device="cuda", seed: int = 0, **kwargs):
    """bench.py's eval model (train False) or train model (train True) on
    `device` with weights drawn from `seed`, in eval or train mode; `kwargs`
    override model arguments (the tests' small widths)."""
    from .config import init_weights
    from .models.mvsformer import DINOv2MVSNet

    device = check_device(device)
    model = DINOv2MVSNet(dtype=dtype, **{**(TRAIN_ARGS if train else EVAL_ARGS), **kwargs})
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(train)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, iters: int, device: torch.device):
    """ms per call of `iters` calls of fn (CUDA events on the card, the host
    clock on the CPU) and the last call's result."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / iters, out


def _launches_per_call(before: dict, after: dict, iters: int) -> dict:
    return {k: (after[k] - before[k]) / iters for k in after}


def bench_eval(model, imgs, cams, depth_values, iters: int = 5) -> dict:
    """bench.py's eval leg on the model's device: a first call, one counted
    call, `iters` timed calls; their depth maps and launches per call."""
    from .ops.cuda import launch_counts
    from .ops.cuda.flops import ProductCount

    device = imgs.device

    def fwd():
        return model(imgs, cams, depth_values)["refined_depth"]

    with torch.inference_mode():
        t0 = time.perf_counter()
        fwd()
        _sync(device)
        first_s = time.perf_counter() - t0
        with ProductCount() as count:
            fwd()
        before = launch_counts()
        ms, depth = _timed(fwd, iters, device)
        launches = _launches_per_call(before, launch_counts(), iters)
    return {"maps_per_sec": imgs.shape[0] / (ms / 1e3), "ms_per_map": ms,
            "first_call_s": first_s, "flops": count.total, "kernel_flops": count.kernels,
            "finite": bool(torch.isfinite(depth.float()).all()), "depth": depth,
            "launches_per_call": launches, "iters": iters}


def bench_train(model, batch, iters: int = 3) -> dict:
    """bench.py's train leg on the model's device (the batch already
    there): a first step, one counted step, `iters` timed steps; every
    step's losses and the launches per step. The model trains in place."""
    from .ops.cuda import launch_counts
    from .ops.cuda.flops import ProductCount
    from .train.optim import make_optimizer
    from .train.step import train_step

    device = batch["imgs"].device
    opt, sched = make_optimizer(model, **OPT_ARGS)
    steps = []

    def step():
        logs = train_step(model, opt, sched, batch)
        steps.append({k: v for k, v in logs.items() if k == "loss" or k.startswith("stage")})
        return logs

    t0 = time.perf_counter()
    step()
    _sync(device)
    first_s = time.perf_counter() - t0
    with ProductCount() as count:
        step()
    before = launch_counts()
    ms, logs = _timed(step, iters, device)
    launches = _launches_per_call(before, launch_counts(), iters)
    b, v, h, w, _ = batch["imgs"].shape
    return {"steps_per_sec": 1e3 / ms, "s_per_step": ms / 1e3, "samples_per_sec": b * 1e3 / ms,
            "first_call_s": first_s, "flops": count.total, "kernel_flops": count.kernels,
            "loss_finite": bool(torch.isfinite(logs["loss"]).all()),
            "losses": [{k: float(x) for k, x in s.items()} for s in steps],
            "protocol": (f"B={b} {h}x{w} {v}views {batch['depth_values'].shape[1]}d remat "
                         f"{DTYPE_NAMES[model.dtype]}"),
            "optimizer": (opt, sched), "launches_per_call": launches, "iters": iters}


def run(device="cuda", dtype=torch.bfloat16, seed: int = 0, model_kwargs=None,
        eval_batch=None, train_batch=None, eval_iters: int = 5, train_iters: int = 3) -> dict:
    """Both legs at bench.py's protocol (or at the given batches and model
    arguments): {"eval", "train" (their results), "device_kind",
    "peak_flops", "power_limit_w", "init_s", "backend", "unit", and the
    models and inputs for a profiler ("eval_model", "eval_inputs",
    "train_model", "train_batch")}."""
    from .train.trainer import to_device

    device = check_device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        peak, power = peak_flops(kind), power_limit_w(device)
    else:
        kind, peak, power = "cpu", None, None
    model_kwargs = model_kwargs or {}
    imgs, cams, dv = eval_batch or make_dtu_eval_batch()
    t0 = time.perf_counter()
    eval_model = build(False, dtype, device, seed, **model_kwargs)
    init_s = time.perf_counter() - t0
    inputs = (torch.from_numpy(imgs).to(device),
              {k: torch.from_numpy(c).to(device) for k, c in cams.items()},
              torch.from_numpy(dv).to(device))
    ev = bench_eval(eval_model, *inputs, iters=eval_iters)
    train_model = build(True, dtype, device, seed, **model_kwargs)
    batch = to_device(train_batch or make_train_batch(), device)
    tr = bench_train(train_model, batch, iters=train_iters)
    b, v, h, w, _ = imgs.shape
    unit = (f"depth-maps/s ({h}x{w}, {v} views, {dv.shape[1]} depths, {DTYPE_NAMES[dtype]}, "
            f"1 {'card' if device.type == 'cuda' else 'cpu'})")
    return {"eval": ev, "train": tr, "device_kind": kind, "peak_flops": peak,
            "power_limit_w": power, "init_s": init_s, "backend": device.type, "unit": unit,
            "eval_model": eval_model, "eval_inputs": inputs, "train_model": train_model,
            "train_batch": batch}


def line(res: dict) -> dict:
    """run()'s result as bench.py's JSON line (with the renames the module
    docstring names)."""
    ev, tr, peak = res["eval"], res["train"], res["peak_flops"]
    eval_mfu = ev["flops"] / (ev["ms_per_map"] / 1e3) / peak if peak else None
    train_mfu = tr["flops"] / tr["s_per_step"] / peak if peak else None
    return {
        "metric": "dtu_eval_depth_maps_per_sec_per_chip",
        "value": ev["maps_per_sec"],
        "unit": res["unit"],
        "vs_baseline": ev["maps_per_sec"] / BASELINE_MAPS_PER_SEC,
        "extra": {
            "ms_per_map": ev["ms_per_map"],
            "eval_mfu_pct": 100 * eval_mfu if eval_mfu is not None else None,
            "eval_tflops_per_map": ev["flops"] / 1e12,
            "train_steps_per_sec": tr["steps_per_sec"],
            "train_samples_per_sec": tr["samples_per_sec"],
            "train_mfu_pct": 100 * train_mfu if train_mfu is not None else None,
            "train_protocol": tr["protocol"],
            "device_kind": res["device_kind"],
            "peak_tflops": peak / 1e12 if peak else None,
            "power_limit_w": res["power_limit_w"],
            "init_s": res["init_s"],
            "first_call_s": ev["first_call_s"],
            "train_first_call_s": tr["first_call_s"],
            "finite": ok(res),
            "backend": res["backend"],
        },
    }


def ok(res: dict) -> bool:
    """The depth maps and the loss are finite."""
    return res["eval"]["finite"] and res["train"]["loss_finite"]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    res = run()
    print(json.dumps(line(res)), flush=True)
    return 0 if ok(res) else 1


if __name__ == "__main__":
    sys.exit(main())
