#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  device      the card (and its name and power limit from nvidia-smi, as a
              plain line of its own);
  build       nvcc builds of csrc/*.cu into build/kernels/ (all in parallel),
              each kernel's ptxas line (registers, spills) and the warp
              kernels' SASS instruction counts (cuobjdump);
  kernel      each hand-written kernel against its plain PyTorch version at
              every shape the paths give it (the DTU-eval forward, the train
              step, and the training CLI's train steps at 512 x 640 and
              512 x 768 and its validation forwards), element by element within
              ops.cuda.tolerance (the bf16 tensor-core flash kernels within
              their rounding budget, flash_attention.budget_tolerance), and
              the same check against a planted fault, which it must reject by
              2x or more, each checked call launching that kernel alone (by
              the counters; a warp case records its variant); the f32 SIMT
              flash kernels, which only the fp32 model runs, at the tiny
              flagship's shapes, and the warps' scalar kernels, which no
              path runs, on misaligned train-shape views; the kernel's, the
              plain version's and one library call's time (CUDA events) and
              the least time the card could take;
  reference   the port on the card (kernels, fp32) against the port on the
              CPU (plain versions, fp32) on a small flagship: the eval
              forward, then one train step (per-stage losses, every
              gradient, the BatchNorm running statistics, the parameters
              after AdamW);
  main_path   the full-width flagship forward at DTU eval (1 x 5 x 1152 x
              1536, 192 depths, bf16, weights drawn from a seed) through
              build_model / load_config, with every kernel's launch count, the
              output checks, ms per depth map and peak memory;
  profile     device ms per top-level layer (CUDA events in forward hooks) and
              torch.profiler, tracing CUDA activity only, over two more
              forwards: device time by kernel, the hand-written kernels'
              share, and the device's idle share of the CUDA-event wall time
              of the same forwards; every flash kernel in the trace must be a
              tensor-core (mma) one and every warp kernel a vector one;
  train_step  the full-width flagship train step (B=2, 5 views, 512 x 640,
              192 depths, bf16, frozen ViT, remat of the regularizers, CE at
              all stages, two-group AdamW with warmup-cosine) through
              build_model(train=True) and the port's Trainer fed by a seeded
              loader: launches per step of every kernel, ms per step over 6
              steps with no host synchronisation, peak memory, losses,
              gradient norm and which parameters moved;
  profile_train  the same trace over three more train steps (the same
              check of the flash and warp kernels' names);
  train_cli   the training command line (python -m mvsformerplusplus_tpu_torch.train)
              in process with configs/mvsformerplusplus.json at full width on
              a geometric DTU-format scan it writes (5 views x 7 lights at
              576 x 800): two epochs at batch 2 over 512 x 640 and 512 x 768
              crops with validation at 512 x 640, then -r to a third epoch;
              the checkpoints, a bit-equal restore, the resumed epoch, step
              and learning rate, steps and ms per step per crop bucket, the
              host's wait on the loader, validation ms per map and peak
              memory.
Each path (main_path, train_step, train_cli) is run with every kernel's
launch count set to 0 just before it and read just after; the kernel phase's
cases must add up to those counts (so the f32 flash kernels and the warps'
scalar kernels, whose cases belong to no path, must not launch there).
Then the {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. Needs one CUDA card.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "mvsformerplusplus.json"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# SFU exponentials: 132 SMs x 16 ex2 per clock x 1.98 GHz boost clock
EXP_S = 132 * 16 * 1.98e9

TINY = dict(feat_chs=(4, 8, 16, 32), vit_ch=64, vit_depth=3, vit_num_heads=4, out_ch=32,
            ndepths=(8, 4, 4, 4), groups=(4, 4, 4, 4),
            decoder_cfg=dict(d_model=64, nhead=2, attention_type="Linear"),
            fmt_config=dict(attention_type="Linear", d_model=32, nhead=2),
            transformer_config=(dict(mid_channel=32, num_heads=2, down_rate=(2, 4, 4),
                                     mlp_ratio=2, layer_num=2),),
            cost_reg_type=("PureTransformerCostReg", "Normal", "Normal", "Normal"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_dtu_eval_batch(b=1, v=5, h=1152, w=1536, dfull=192, seed=0):
    """DTU-eval-like batch: images, per-stage cameras with DTU-scale
    baselines (mm) and focal, and the 425 mm + 2.65 mm steps depth range."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(b, v, h, w, 3).astype(np.float32)
    cams = {}
    for s in range(4):
        scale = 0.125 * 2 ** s
        cam = np.zeros((b, v, 2, 4, 4), np.float32)
        for vi in range(v):
            ang = 0.06 * vi
            c, sn = np.cos(ang), np.sin(ang)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
            ext[0, 3] = 40.0 * vi
            cam[:, vi, 0] = ext
            f = 2892.33 * scale * (w / 1600.0)
            cam[:, vi, 1, :3, :3] = np.array(
                [[f, 0, w * scale / 2], [0, f, h * scale / 2], [0, 0, 1]], np.float32)
        cams[f"stage{s + 1}"] = cam
    depth_values = (425.0 + np.arange(dfull, dtype=np.float32) * 2.5 * 1.06)[None].repeat(b, 0)
    return imgs, cams, depth_values


def to_device(batch, device):
    imgs, cams, dv = batch
    return (torch.from_numpy(imgs).to(device), {k: torch.from_numpy(c).to(device)
                                                for k, c in cams.items()},
            torch.from_numpy(dv).to(device))


def time_ms(fn, iters=5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- kernel cases
# Each `*_cases` yields (case, launches, args, TPU rows) for every shape a
# path gives the kernel; `launches` maps each path that gives it that shape to how
# often one run of the path calls the kernel there, so per path they sum to
# the kernel's launch count in that run. The paths: "main_path", the
# DTU-eval forward; "train_step", the train step; "train_cli", the training
# command line's whole run (CLI below: its train steps at two crop buckets
# and its validation forwards). Each `*_fault` computes the kernel's output
# with a planted arithmetic fault (mostly as a change of the inputs), which
# # the kernel-vs-plain check must reject. The TPU rows are those of PERF.md's
# kernel table that the JAX package runs at that shape.

TRAIN = dict(b=2, v=5, h=512, w=640, dfull=192)
TRAIN_NDEPTHS = (32, 16, 8, 4)
TRAIN_STAGE_C = (64, 32, 16, 8)

# the train_cli phase: configs/mvsformerplusplus.json on one geometric
# DTU-format scan (5 views x 7 lights = 35 samples at 576 x 800), batch 2,
# two epochs and a resumed third, validating each epoch on the 35 samples
CLI = dict(samples=35, batch=2, scales=((512, 640), (512, 768)), val_hw=(512, 640), epochs=3,
           hw=(576, 800))


def cli_counts():
    """Train steps per crop bucket over the CLI run's three epochs (the
    loader's schedule, drawn from its seed) and its validation maps."""
    from mvsformerplusplus_tpu_torch.data.mvs_dataset import ShapeBucketSchedule

    sched = ShapeBucketSchedule(CLI["samples"], CLI["scales"], CLI["batch"], seed=0)
    steps = {hw: 0 for hw in CLI["scales"]}
    for epoch in range(CLI["epochs"]):
        for _, hw in sched.epoch(epoch):
            steps[tuple(hw)] += 1
    return steps, CLI["samples"] * CLI["epochs"]


def shape_configs():
    """(name, 'eval' or 'train', (B, H, W), batch seed, {path: runs of that
    shape per run of the path}): the DTU eval forward, the train step at
    512 x 640 (the train_step path and the CLI's 512 x 640 bucket), the
    CLI's 512 x 768 bucket and the CLI's validation forwards (B=1, 512 x
    640, eval mode)."""
    steps, val_maps = cli_counts()
    return [
        ("eval1152", "eval", (1, 1152, 1536), 0, {"main_path": 1}),
        ("train640", "train", (2, 512, 640), 1,
         {"train_step": 1, "train_cli": steps[(512, 640)]}),
        ("train768", "train", (2, 512, 768), 1, {"train_cli": steps[(512, 768)]}),
        ("eval640", "eval", (1, 512, 640), 1, {"train_cli": val_maps}),
    ]


def _config_batch(bhw, seed):
    b, h, w = bhw
    return to_device(make_dtu_eval_batch(b=b, h=h, w=w, seed=seed), "cuda")


def _times(runs, n):
    return {path: n * k for path, k in runs.items() if k}


def make_train_batch(b=2, v=5, h=512, w=640, dfull=192, seed=1):
    """The train protocol's batch (as bench.py's): DTU-like images, cameras
    and depth range at the crop, ground truth uniform in 450-900 mm and 80%
    valid masks per stage."""
    rng = np.random.RandomState(seed)
    imgs, cams, dv = make_dtu_eval_batch(b=b, v=v, h=h, w=w, dfull=dfull, seed=seed)
    gt = {f"stage{i + 1}": rng.uniform(450, 900, (b, h // (8 >> i), w // (8 >> i))).astype(
        np.float32) for i in range(4)}
    return {"imgs": imgs, "cams": cams, "depth_values": dv, "depth_gt": gt,
            "mask": {k: (rng.rand(*g.shape) > 0.2).astype(np.float32) for k, g in gt.items()}}


def stage_coords(cams, dv, stage, nd, hh, ww):
    """Warp coordinates of one stage with the source views folded into the
    batch, view-major, as StageNet.build_volume folds them: [(V-1)*B, D, hh,
    ww, 2], on the inverse-depth init range."""
    from mvsformerplusplus_tpu_torch.ops.geometry import compose_projection, plane_sweep_coords
    from mvsformerplusplus_tpu_torch.ops.sampling import init_inverse_range

    projs = compose_projection(cams[f"stage{stage}"])  # [B, V, 4, 4]
    b, v = projs.shape[:2]
    src = projs[:, 1:].transpose(0, 1).reshape((v - 1) * b, 4, 4)
    ref = projs[:, 0].repeat(v - 1, 1, 1)
    hypo = init_inverse_range(dv, nd, hh, ww).repeat(v - 1, 1, 1, 1)
    return plane_sweep_coords(src, ref, hypo, hh, ww)[0]


def _stage_shapes(h, w):
    return [(i + 1, nd, c, h // 2 ** (3 - i), w // 2 ** (3 - i))
            for i, (nd, c) in enumerate(zip(TRAIN_NDEPTHS, TRAIN_STAGE_C))]


def warp_tpu_rows(stage, nd, c, ww):
    """The TPU kernel rows (PERF.md's table) the JAX package's StageNet plan
    (models/stagenet.py resolve_warp_plan) gives this stage's warp: under
    the default 'auto' mode (banded on a TPU: rows 1 and, with
    banded_fused=False, 5 where W is a 128-multiple >= 384, else row 4, for
    C up to 32 / 16; wider C falls back to XLA's gather) and under warp_mode
    'pallas' (rows 10, and 12 where it folds the depth axis: the stages of 8
    re-centered depths; C up to 16, W a 128-multiple)."""
    blocked = ww % 128 == 0 and ww >= 384
    rows = []
    if c <= (32 if blocked else 16):
        rows += [1, 5] if blocked else [4]
    if c <= 16 and ww % 128 == 0:
        rows.append(12 if stage > 1 and nd == 8 else 10)
    return tuple(rows)


def warp_cases():
    """The four stage warps (source views batched) at each shape config;
    the train crop's stage 3 is the TPU's narrow-row banded_warp_rows shape,
    the 512 x 768 crop's stage 3 the depth-folded blend's (row 12)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, _, bhw, seed, runs in shape_configs():
        imgs, cams, dv = _config_batch(bhw, seed)
        nsrc = (imgs.shape[1] - 1) * imgs.shape[0]
        for stage, nd, c, hh, ww in _stage_shapes(imgs.shape[2], imgs.shape[3]):
            coords = stage_coords(cams, dv, stage, nd, hh, ww)
            src = torch.randn(nsrc, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
            yield (f"{name}_stage{stage}", _times(runs, 1), (src, coords),
                   warp_tpu_rows(stage, nd, c, ww))


def misaligned(t):
    """t's values in a contiguous view one element off a 16-byte boundary."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


def _train640_stages(stages):
    """(stage, nd, c, hh, ww, coords, source views) of the train crop's
    warps at `stages`."""
    imgs, cams, dv = _config_batch((TRAIN["b"], TRAIN["h"], TRAIN["w"]), 1)
    nsrc = (imgs.shape[1] - 1) * imgs.shape[0]
    for stage, nd, c, hh, ww in _stage_shapes(TRAIN["h"], TRAIN["w"]):
        if stage in stages:
            yield stage, nd, c, hh, ww, stage_coords(cams, dv, stage, nd, hh, ww), nsrc


def warp_scalar_cases():
    """The scalar kernel, which no path runs (a C that is no multiple of the
    16-byte vector, or a source off a 16-byte boundary): the train crop's
    stage-1 and stage-4 warps with the source one element off."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for stage, nd, c, hh, ww, coords, nsrc in _train640_stages((1, 4)):
        src = torch.randn(nsrc, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
        yield f"train640_stage{stage}_misaligned", {}, (misaligned(src), coords), ()


def warp_fault(kernel, src, coords):
    """Sample positions off by 1/256 pixel."""
    return kernel(src, coords + 1 / 256)


def warp_bwd_cases():
    """The image gradient at the four stages of each train crop: the f32
    cotangent of the warped volume [8, D, H, W, C]. The TPU computes it with
    the banded transposes (rows 6 and 7) at every stage; row 11, the
    y-grouped blend's VJP, is its transpose where the pallas mode ran rows
    10 and 12, and no model path reaches it."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, kind, bhw, seed, runs in shape_configs():
        if kind != "train":
            continue
        imgs, cams, dv = _config_batch(bhw, seed)
        nsrc = (imgs.shape[1] - 1) * imgs.shape[0]
        for stage, nd, c, hh, ww in _stage_shapes(imgs.shape[2], imgs.shape[3]):
            coords = stage_coords(cams, dv, stage, nd, hh, ww)
            g = torch.randn(nsrc, nd, hh, ww, c, generator=gen, device="cuda")
            rows = (7,) if ww % 128 == 0 and ww >= 384 else (6,)
            if c <= 16 and ww % 128 == 0:
                rows += (11,)  # the transpose of the pallas mode's blend there
            yield f"{name}_stage{stage}", _times(runs, 1), (g, coords, (nsrc, hh, ww, c)), rows


def warp_bwd_scalar_cases():
    """The backward's scalar kernel, which no path runs: the train crop's
    stage-1 and stage-4 gradients with the cotangent one element off."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    for stage, nd, c, hh, ww, coords, nsrc in _train640_stages((1, 4)):
        g = torch.randn(nsrc, nd, hh, ww, c, generator=gen, device="cuda")
        yield f"train640_stage{stage}_misaligned", {}, (misaligned(g), coords, (nsrc, hh, ww, c)), ()


def warp_bwd_fault(kernel, g, coords, src_shape):
    """The top-left corner's bilinear weight 8% low: the kernel's result
    minus 0.08 of that corner's share, which the plain scatter gives."""
    from mvsformerplusplus_tpu_torch.ops.cuda.warp import bilinear_corners

    b, h, w, c = src_shape
    xy = coords.reshape(b, -1, 2)
    idx, wt = next(bilinear_corners(xy, h, w))
    share = torch.zeros(b * h * w, c, device=g.device)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None]
    share.index_add_(0, (idx + base).reshape(-1), (g.reshape(b, -1, c) * wt[..., None]).reshape(-1, c))
    return kernel(g, coords, src_shape) - 0.08 * share.reshape(b, h, w, c)


def _tokens(h, w):
    """ViT tokens per view (the 0.4375-rescaled image in 14-px patches, and
    the class token) and CTA tokens per sample (the stage-1 volume, 32 x
    H/8 x W/8, down by (2, 4, 4))."""
    return ((h * 7 // 16 // 14) * (w * 7 // 16 // 14) + 1,
            (32 // 2) * (h // 8 // 4) * (w // 8 // 4))


def flash_cases():
    """Per forward: the 12 ViT blocks on every view (frozen, no lse) and the
    6 CTA blocks on every sample; a train step with lse and 6 more CTA
    forwards, the replays of the checkpointed regularizer."""
    from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale

    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, kind, (b, h, w), _, runs in shape_configs():
        v = TRAIN["v"]  # every config has 5 views
        n_vit, n_cta = _tokens(h, w)
        train = kind == "train"
        for part, (bb, n, heads, dh, sc), lse, count in (
                ("vit", (b * v, n_vit, 12, 64, 64 ** -0.5), False, 12),
                ("cta", (b, n_cta, 4, 16, entropy_inv_scale(16, n_cta, 12185)), train,
                 12 if train else 6)):
            q, k, vv = (torch.randn(bb, n, heads, dh, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(3))
            yield f"{name}_{part}", _times(runs, count), (q, k, vv, sc, lse), (2,)


def flash_fault(kernel, q, k, v, scale, lse):
    """The softmax scale 8% low."""
    return kernel(q, k, v, 0.92 * scale, lse)


# the tiny flagship's flash calls (TINY on the reference phase's 3 x 128 x
# 256 batch, fp32): the ViT's blocks on 3 views of 33 tokens (4 heads of 16)
# and the CTA's on 128 tokens (2 heads of 16), with its entropy scale
TINY_VIT, TINY_CTA = (3, 33, 4, 16), (1, 128, 2, 16)


def _tiny_scales():
    from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale

    return 16 ** -0.5, entropy_inv_scale(16, TINY_CTA[1], 12185)


def flash_f32_cases():
    """The f32 SIMT forward at the tiny flagship's shapes; no path runs it
    (the fp32 model of the reference phases does)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    vit_scale, cta_scale = _tiny_scales()
    for part, (b, n, h, dh), sc, lse in (("vit", TINY_VIT, vit_scale, False),
                                         ("cta", TINY_CTA, cta_scale, True)):
        q, k, v = (torch.randn(b, n, h, dh, generator=gen, device="cuda") for _ in range(3))
        yield f"tiny_{part}", {}, (q, k, v, sc, lse), (2,)


def flash_tolerance(q, k, v, scale, lse, want):
    """The forward's rounding budget for out; lse at atol 1e-4."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (budget_tolerance,
                                                                      flash_fwd_budget)

    want = _tuple(want)
    tol = [budget_tolerance(want[0], flash_fwd_budget(q, k, v, scale))]
    if lse:
        tol.append(1e-4 + 1e-5 * want[1].abs())
    return tol


def flash_bwd_cases():
    """The CTA's backward at each train crop: 6 per step (one per block), one
    fused launch each. q and k are drawn at std 1.5: at std 1 the CTA's
    scale leaves the attention nearly uniform over its 5-6k keys, O and
    delta near 0, and no check could see an error in delta."""
    from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (attention_delta,
                                                                      flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, kind, (b, h, w), _, runs in shape_configs():
        if kind != "train":
            continue
        n = _tokens(h, w)[1]
        scale = entropy_inv_scale(16, n, 12185)
        q, k, v, dout = (torch.randn(b, n, 4, 16, generator=gen, device="cuda") * std
                         for std in (1.5, 1.5, 1, 1))
        q, k, v, dout = (x.to(torch.bfloat16) for x in (q, k, v, dout))
        out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
        yield (f"{name}_cta", _times(runs, 6),
               (q, k, v, dout, lse, attention_delta(out, dout), scale), (8,))


def flash_bwd_fault(kernel, q, k, v, dout, lse, delta, scale):
    """delta = rowsum(dO * O) 8% low."""
    return kernel(q, k, v, dout, lse, 0.92 * delta, scale)


def flash_bwd_f32_cases():
    """The f32 SIMT backward at the tiny flagship's two flash shapes (the
    CTA's, which the fp32 model of reference_train runs, and the ViT's); no
    path runs it."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (attention_delta,
                                                                      flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(8)
    for part, (b, n, h, dh), scale in zip(("vit", "cta"), (TINY_VIT, TINY_CTA), _tiny_scales()):
        q, k, v, dout = (torch.randn(b, n, h, dh, generator=gen, device="cuda") for _ in range(4))
        out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
        yield f"tiny_{part}", {}, (q, k, v, dout, lse, attention_delta(out, dout), scale), (8,)


def flash_bwd_tolerance(q, k, v, dout, lse, delta, scale, want):
    """The backward's rounding budgets of dq, dk and dv."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (budget_tolerance,
                                                                      flash_bwd_budget)

    budgets = flash_bwd_budget(q, k, v, dout, lse, delta, scale)
    return [budget_tolerance(w, b_) for w, b_ in zip(want, budgets)]


# (case, launches per forward, (batch at B=1, divisor of the image's H x W,
# Ci, Co, k)): the FPN encoder's stride-1 convs and the decoder's heads on
# the 5 views, the visibility net of each stage on the 4 source views, and
# the FMT smoothing convs, run once per view at batch 1; B samples multiply
# the batch
CONV_SHAPES = ([("encoder_7x7_3to8", 1, (5, 1, 3, 8, 7)), ("encoder_5x5_8to8", 1, (5, 1, 8, 8, 5)),
                ("encoder_16to16", 2, (5, 2, 16, 16, 3)), ("encoder_32to32", 2, (5, 4, 32, 32, 3)),
                ("encoder_64to64", 2, (5, 8, 64, 64, 3)), ("decoder_64to32", 1, (5, 4, 64, 32, 3)),
                ("decoder_64to16", 1, (5, 2, 64, 16, 3)), ("decoder_64to8", 1, (5, 1, 64, 8, 3))]
               + [(f"visibility{s + 1}_{ci}to{co}", 1, (4, 2 ** (3 - s), ci, co, 3))
                  for s in range(4) for ci, co in ((1, 16), (16, 16), (16, 8))]
               + [(f"fmt_smooth_{c}", 5, (1, c // 8, c, c, 3)) for c in (32, 16, 8)])


def _batched_conv(shapes, b):
    """The same convs on B samples: the batch of each grows B-fold."""
    return [(name, n, (b * bb, div, ci, co, k)) for name, n, (bb, div, ci, co, k) in shapes]


# the convs whose input needs a gradient on the train path, with their dx
# launches per step: not the encoder's 7x7 on the images, not each stage's
# first visibility conv on the detached entropy
CONV_DX_SHAPES = [sh for sh in CONV_SHAPES
                  if sh[0] != "encoder_7x7_3to8" and "_1to16" not in sh[0]]


def conv_cases():
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, _, (b, h, w), _, runs in shape_configs():
        for conv, count, (bb, div, ci, co, k) in _batched_conv(CONV_SHAPES, b):
            x = torch.randn(bb, h // div, w // div, ci, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kern = (torch.randn(k, k, ci, co, generator=gen, device="cuda")
                    * (k * k * ci) ** -0.5).to(torch.bfloat16)
            yield f"{name}_{conv}", _times(runs, count), (x, kern), (3,)


def conv_fault(kernel, x, kern):
    """The top row of taps weighted 8% low."""
    kern = kern.clone()
    kern[0] *= 0.92
    return kernel(x, kern)


def conv_dx_cases():
    """dx = the conv kernel on the cotangent [B, H, W, Co] with the weights
    flipped and ci/co swapped, at each train conv whose input needs it."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, kind, (b, h, w), _, runs in shape_configs():
        if kind != "train":
            continue
        for conv, count, (bb, div, ci, co, k) in _batched_conv(CONV_DX_SHAPES, b):
            g = torch.randn(bb, h // div, w // div, co, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kern = (torch.randn(k, k, ci, co, generator=gen, device="cuda")
                    * (k * k * co) ** -0.5).to(torch.bfloat16)
            yield f"{name}_{conv}", _times(runs, count), (g, kern), (9,)


def conv_dx_fault(kernel, g, kern):
    """The weights not flipped in space (dx_kernel flips the pre-flipped
    ones back)."""
    return kernel(g, kern.flip(0, 1))


def warp_library(src, coords):
    b, h, w, c = src.shape
    d = coords.shape[1]
    img = src.float().permute(0, 3, 1, 2)
    grid = torch.stack([coords[..., 0] / ((w - 1) / 2) - 1, coords[..., 1] / ((h - 1) / 2) - 1],
                       dim=-1).reshape(b, d * coords.shape[2], coords.shape[3], 2)
    return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)


def warp_bwd_library(g, coords, src_shape):
    """grid_sample's image backward (f32, NCHW), the one aten call."""
    b, h, w, c = src_shape
    d, hh, ww = coords.shape[1:4]
    img = torch.zeros(b, c, h, w, device=g.device)
    grid = torch.stack([coords[..., 0] / ((w - 1) / 2) - 1, coords[..., 1] / ((h - 1) / 2) - 1],
                       dim=-1).reshape(b, d * hh, ww, 2)
    gc = g.permute(0, 4, 1, 2, 3).reshape(b, c, d * hh, ww).contiguous()
    return lambda: torch.ops.aten.grid_sampler_2d_backward(gc, img, grid, 0, 0, True,
                                                           [True, False])


def flash_library(q, k, v, scale, lse):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)


def flash_bwd_library(q, k, v, dout, lse, delta, scale):
    """SDPA's backward (dq, dk and dv together) on the same inputs."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    gt = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)


def conv_library(x, kern):
    xc, wc = x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous()
    return lambda: F.conv2d(xc, wc, padding=kern.shape[0] // 2)


def conv_dx_library(g, kern):
    """cuDNN's conv2d_input (NCHW) for the same gradient."""
    b, hh, ww, _ = g.shape
    gc, wc = g.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous()
    size = (b, kern.shape[2], hh, ww)
    return lambda: torch.nn.grad.conv2d_input(size, wc, gc, padding=kern.shape[0] // 2)


def corner_use(coords, h, w):
    """What a warp's coordinates need of the data: (samples with a corner
    inside the image, inside corners, distinct source pixels those corners
    touch), over the batch."""
    b = coords.shape[0]
    xy = coords.reshape(b, -1, 2)
    x0, y0 = torch.floor(xy[..., 0]), torch.floor(xy[..., 1])
    rows = torch.arange(b, device=coords.device)[:, None].expand_as(x0)
    any_in = torch.zeros_like(x0, dtype=torch.bool)
    touched = torch.zeros(b, h * w, dtype=torch.bool, device=coords.device)
    corners = 0
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
            any_in |= inside
            corners += int(inside.sum())
            touched[rows[inside], (cy * w + cx)[inside].long()] = True
    return int(any_in.sum()), corners, int(touched.sum())


def warp_bound(src, coords, out):
    """What these coordinates need: the source pixels their inside corners
    touch read once, the coordinates read once, the output written once,
    against a multiply and an add per inside corner and channel."""
    b, h, w, c = src.shape
    _, corners, pixels = corner_use(coords, h, w)
    return ((pixels * c * src.element_size() + nbytes(coords, out)) / HBM_BYTES_S,
            2 * corners * c / FP32_FLOPS)


def warp_bwd_bound(g, coords, src_shape, out):
    """What these coordinates need: the cotangent of the samples with a
    corner inside the image read once (the others add nothing), the
    coordinates read once, dsrc written once, against a multiply and an add
    per inside corner and channel."""
    b, h, w, c = src_shape
    samples, corners, _ = corner_use(coords, h, w)
    return ((samples * c * g.element_size() + nbytes(coords, out)) / HBM_BYTES_S,
            2 * corners * c / FP32_FLOPS)


def _product_rate(t):
    """Peak rate of the products on t's type: bf16 tensor cores, or fp32
    FMAs outside them (the f32 kernels use no TF32)."""
    return BF16_FLOPS if t.dtype == torch.bfloat16 else FP32_FLOPS


def flash_bound(q, k, v, scale, lse, out):
    """Bytes of q, k, v and out, against the two products at their type's
    peak and the N*M exponentials on the SFUs, whichever takes longer."""
    b, n, h, dh = q.shape
    m = k.shape[1]
    return (nbytes(q, k, v, *_tuple(out)) / HBM_BYTES_S,
            max(4 * b * h * n * m * dh / _product_rate(q), b * h * n * m / EXP_S))


def _flash_bwd_bound(n_products):
    def bound(q, k, v, dout, lse, delta, scale, out):
        """Bytes of the inputs and outputs, against this kernel's products at
        their type's peak (fused: q.k, dO.v, P.dO, dS.q, dS.k; f32 dK/dV: the
        first four; f32 dQ: q.k, dO.v, dS.k) and its N*M exponentials on the
        SFUs, whichever takes longer."""
        b, n, h, dh = q.shape
        m = k.shape[1]
        return (nbytes(q, k, v, dout, lse, delta, *_tuple(out)) / HBM_BYTES_S,
                max(2 * n_products * b * h * n * m * dh / _product_rate(q),
                    b * h * n * m / EXP_S))
    return bound


def conv_bound(x, kern, out):
    b, hh, ww, ci = x.shape
    ky, kx, _, co = kern.shape
    return (nbytes(x, kern, out) / HBM_BYTES_S,
            2 * b * hh * ww * ky * kx * ci * co / BF16_FLOPS)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def kernel_table():
    """name -> (source, TPU kernel it replaces, kernel, plain, cases, fault,
    library, bound, tolerance): `tolerance(*args, want)` gives the
    element-wise tolerance of each output, or None for ops.cuda.tolerance."""
    from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention as fa, warp

    pallas = "mvsformerplusplus_tpu/ops/pallas/"
    return {
        "warp_bilinear": ("csrc/warp.cu", f"{pallas}warp_band.py:395; {pallas}warp_band.py:195; "
                          f"{pallas}warp_band.py:511; {pallas}warp_blend.py:132; "
                          f"{pallas}warp_blend.py:153",
                          warp.warp_bilinear, warp.warp_bilinear_plain, warp_cases, warp_fault,
                          warp_library, warp_bound, None),
        "warp_bilinear_bwd": ("csrc/warp_bwd.cu",
                              f"{pallas}warp_band.py:231; {pallas}warp_band.py:478; "
                              f"{pallas}warp_blend.py:217",
                              warp.warp_bilinear_bwd, warp.warp_bilinear_bwd_plain,
                              warp_bwd_cases, warp_bwd_fault, warp_bwd_library, warp_bwd_bound,
                              None),
        "warp_bilinear_scalar": ("csrc/warp.cu", f"{pallas}warp_band.py:395",
                                 warp.warp_bilinear, warp.warp_bilinear_plain, warp_scalar_cases,
                                 warp_fault, warp_library, warp_bound, None),
        "warp_bilinear_bwd_scalar": ("csrc/warp_bwd.cu", f"{pallas}warp_band.py:231",
                                     warp.warp_bilinear_bwd, warp.warp_bilinear_bwd_plain,
                                     warp_bwd_scalar_cases, warp_bwd_fault, warp_bwd_library,
                                     warp_bwd_bound, None),
        "flash_attention_fwd": ("csrc/flash_attention.cu", f"{pallas}flash_attention.py:131",
                                fa.flash_attention_fwd, fa.flash_attention_plain, flash_cases,
                                flash_fault, flash_library, flash_bound, flash_tolerance),
        "flash_attention_fwd_f32": ("csrc/flash_attention.cu", f"{pallas}flash_attention.py:131",
                                    fa.flash_attention_fwd, fa.flash_attention_plain,
                                    flash_f32_cases, flash_fault, flash_library, flash_bound,
                                    None),
        "flash_attention_bwd": ("csrc/flash_attention_bwd.cu", f"{pallas}flash_attention.py:263",
                                fa.flash_attention_bwd, fa.flash_attention_bwd_plain,
                                flash_bwd_cases, flash_bwd_fault, flash_bwd_library,
                                _flash_bwd_bound(5), flash_bwd_tolerance),
        "flash_attention_bwd_dkv_f32": ("csrc/flash_attention_bwd.cu",
                                        f"{pallas}flash_attention.py:263",
                                        fa.flash_attention_bwd_dkv,
                                        fa.flash_attention_bwd_dkv_plain, flash_bwd_f32_cases,
                                        flash_bwd_fault, flash_bwd_library, _flash_bwd_bound(4),
                                        None),
        "flash_attention_bwd_dq_f32": ("csrc/flash_attention_bwd.cu",
                                       f"{pallas}flash_attention.py:263",
                                       fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain,
                                       flash_bwd_f32_cases, flash_bwd_fault, flash_bwd_library,
                                       _flash_bwd_bound(3), None),
        "conv2d_same": ("csrc/conv2d.cu", f"{pallas}conv2d.py:176",
                        conv2d.conv2d_same, conv2d.conv2d_same_plain, conv_cases, conv_fault,
                        conv_library, conv_bound, None),
        "conv2d_same_dx": ("csrc/conv2d.cu", f"{pallas}conv2d.py:224",
                           conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain, conv_dx_cases,
                           conv_dx_fault, conv_dx_library,
                           lambda g, kern, out: conv_bound(g, conv2d.dx_kernel(kern), out), None),
    }


def launch_counters():
    """Each kernel of kernel_table() -> (wrapper, the attribute counting its
    launches): the flash and warp wrappers count each kernel they choose
    apart."""
    from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention as fa, warp

    return {"warp_bilinear": (warp.warp_bilinear, "launches_vec"),
            "warp_bilinear_bwd": (warp.warp_bilinear_bwd, "launches_vec"),
            "warp_bilinear_scalar": (warp.warp_bilinear, "launches_scalar"),
            "warp_bilinear_bwd_scalar": (warp.warp_bilinear_bwd, "launches_scalar"),
            "flash_attention_fwd": (fa.flash_attention_fwd, "launches_mma"),
            "flash_attention_fwd_f32": (fa.flash_attention_fwd, "launches_f32"),
            "flash_attention_bwd": (fa.flash_attention_bwd, "launches_mma"),
            "flash_attention_bwd_dkv_f32": (fa.flash_attention_bwd_dkv, "launches"),
            "flash_attention_bwd_dq_f32": (fa.flash_attention_bwd_dq, "launches"),
            "conv2d_same": (conv2d.conv2d_same, "launches"),
            "conv2d_same_dx": (conv2d.conv2d_same_dx, "launches")}


def zero_counts(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


# the kernels only the fp32 model launches, and the warps' scalar kernels:
# no path may launch them
F32_ONLY = ("flash_attention_fwd_f32", "flash_attention_bwd_dkv_f32", "flash_attention_bwd_dq_f32")
WARP_SCALAR = ("warp_bilinear_scalar", "warp_bilinear_bwd_scalar")
OFF_PATH = F32_ONLY + WARP_SCALAR


def err_over_tol(got, want, tol=None) -> float:
    """max over outputs of max |got - want| / tolerance, element by element:
    `tol`, one tensor per output, or else (atol + rtol |want|) with (rtol,
    atol) from ops.cuda.tolerance; at most 1 where they agree."""
    from mvsformerplusplus_tpu_torch.ops.cuda import tolerance

    ratio = 0.0
    for i, (g, w) in enumerate(zip(_tuple(got), _tuple(want))):
        wf = w.float()
        if tol is None:
            rtol, atol = tolerance(w)
            t = atol + rtol * wf.abs()
        else:
            t = tol[i]
        ratio = max(ratio, ((g.float() - wf).abs() / t).max().item())
    return ratio


def run_kernel_phase(counters):
    """Each kernel against its plain version at every shape the paths give
    it, element by element within its tolerance (`ops.cuda.tolerance`, or
    the table's own); each case's planted fault must fail the same check by
    2x or more, and the checked call must have launched that kernel and no
    other (by the counters: a warp case records the variant it ran). A
    kernel's times and bound sum each case's over the paths' runs (one DTU
    eval forward, one train step, the CLI's whole run): the case's time x
    its launches there."""
    results, all_rows = {}, []
    for name, (src, replaces, kernel, plain, cases, fault, library, bound,
               tolerance) in kernel_table().items():
        rows = []
        for case, launches, args, tpu_rows in cases():
            want = plain(*args)
            before = read_counts(counters)
            got = kernel(*args)
            launched = [k for k, n in read_counts(counters).items() if n != before[k]]
            tol = tolerance(*args, want) if tolerance is not None else None
            ratio = err_over_tol(got, want, tol)
            fault_ratio = err_over_tol(fault(kernel, *args), want, tol)
            bytes_s, ops_s = bound(*args, got)
            row = {"phase": "kernel", "kernel": name, "case": case, "tpu_rows": list(tpu_rows),
                   "launches_by_path": launches, "launched": launched,
                   "shapes": [list(a.shape) for a in args if isinstance(a, torch.Tensor)],
                   "max_abs_err": max((g.float() - w.float()).abs().max().item()
                                      for g, w in zip(_tuple(got), _tuple(want))),
                   "max_abs_ref": max(w.float().abs().max().item() for w in _tuple(want)),
                   "tolerance": "rounding budget" if tolerance else "ops.cuda.tolerance",
                   "err_over_tol": ratio, "fault_err_over_tol": fault_ratio,
                   "bound_ms": max(bytes_s, ops_s) * 1e3, "bound_bytes_ms": bytes_s * 1e3,
                   "bound_ops_ms": ops_s * 1e3,
                   "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
            del got, want, tol
            row["ms"] = time_ms(lambda: kernel(*args))
            row["plain_ms"] = time_ms(lambda: plain(*args), iters=2)
            row["library_ms"] = time_ms(library(*args)) if library is not None else None
            emit(row)
            if launched != [name]:
                raise SystemExit(f"{name}[{case}] launched {launched}, not {name} alone")
            if not ratio <= 1:
                raise SystemExit(f"{name}[{case}] disagrees with its plain version: "
                                 f"error {ratio} x its tolerance")
            if not fault_ratio >= 2:
                raise SystemExit(f"{name}[{case}]: the check rejects a planted fault "
                                 f"({fault.__doc__}) by {fault_ratio}x, less than 2x")
            rows.append(row)
            del args
            torch.cuda.empty_cache()
        all_rows += rows
        paths = sorted({p for r in rows for p in r["launches_by_path"]})

        def total(key, path=None):
            if not paths:  # a kernel no path runs: each case once
                return sum(r[key] for r in rows)
            return sum(r[key] * n for r in rows for p, n in r["launches_by_path"].items()
                       if path in (None, p))

        results[name] = {
            "name": name, "route": "cuda", "source": f"mvsformerplusplus_tpu_torch/{src}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: total(k) for k in ("ms", "plain_ms", "bound_ms")},
            "library_ms": total("library_ms") if library is not None else None,
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * sum(
                r["launches_by_path"].values()))["bound_by"],
            "times": ("summed over the runs of the paths it serves (one DTU eval forward, one "
                      "train step, the CLI's run): each case's time x its launches there"
                      if paths else "no path runs it: one launch of each case, summed"),
            "max_err_over_tol": max(r["err_over_tol"] for r in rows),
            "min_fault_err_over_tol": min(r["fault_err_over_tol"] for r in rows),
            "cases": {p: {r["case"]: r["launches_by_path"][p] for r in rows
                          if p in r["launches_by_path"]} for p in paths},
            "by_path": {p: {k: (total(k, p) if library is not None or k != "library_ms"
                                else None)
                            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                        for p in paths},
        }
    emit(tpu_row_summary(all_rows))
    return results


def tpu_row_summary(rows) -> dict:
    """Per row of PERF.md's TPU kernel table: the port kernel that serves
    it, the cases at the shapes where the JAX package runs that row, and
    per path their launches per run and time, plain time, bound and library
    time summed as the kernel summary sums them (case x its launches)."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    out = {}
    for r in rows:
        for tpu in r["tpu_rows"]:
            t = out.setdefault(str(tpu), {"kernel": r["kernel"], "cases": {}, "by_path": {}})
            t["cases"][r["case"]] = {k: r[k] for k in keys + ("launches_by_path",)}
            for path, n in r["launches_by_path"].items():
                p = t["by_path"].setdefault(path, {"launches": 0, **{k: 0.0 for k in keys}})
                p["launches"] += n
                for k in keys:
                    if r[k] is not None:
                        p[k] += r[k] * n
    return {"phase": "tpu_rows", "rows": out}


# ------------------------------------------------------------------- model runs

def tiny_model(device, train=False):
    """The small flagship in fp32 with seeded weights, its regularizers
    checkpointed as on the train path."""
    from mvsformerplusplus_tpu_torch.config import init_weights
    from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet

    model = DINOv2MVSNet(**TINY, remat_granularity="cost_reg", dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device).train(train)


def run_reference_phase():
    """Tiny flagship, fp32: kernels on the card vs plain versions on the CPU."""
    from mvsformerplusplus_tpu_torch.testing import well_conditioned

    batch = make_dtu_eval_batch(v=3, h=128, w=256, dfull=48, seed=1)
    outs = {}
    for device in ("cpu", "cuda"):
        model = tiny_model(device)
        with torch.inference_mode():
            out = model(*to_device(batch, device))
        outs[device] = {k: out[k].float().cpu() for k in ("refined_depth",
                                                            "photometric_confidence")}
        outs[device]["prob4"] = out["stage4"]["prob_volume"].float().cpu()
        outs[device]["dv4"] = out["stage4"]["depth_values"].float().cpu()
    cpu, gpu = outs["cpu"], outs["cuda"]
    mask = torch.from_numpy(well_conditioned(cpu["dv4"], float(batch[2].max())))
    depth_rel = ((gpu["refined_depth"] - cpu["refined_depth"]).abs()
                 / cpu["refined_depth"].abs())[mask].max().item()
    conf_err = (gpu["photometric_confidence"] - cpu["photometric_confidence"]).abs().max().item()
    prob_err = (gpu["prob4"] - cpu["prob4"]).abs().max().item()
    row = {"phase": "reference", "pixels_compared": float(mask.float().mean()),
           "depth_max_rel_err": depth_rel, "depth_rtol": 1e-3, "conf_max_abs_err": conf_err,
           "prob_max_abs_err": prob_err, "atol": 1e-3}
    emit(row)
    if not (mask.float().mean() > 0.5 and depth_rel <= 1e-3 and conf_err <= 1e-3
            and prob_err <= 1e-3):
        raise SystemExit("the port on the card disagrees with its plain CPU path")


def run_reference_train_phase():
    """One train step of the tiny flagship (fp32, remat of the regularizers)
    on the card against the same step on the port's CPU path, on
    testing.conditioned_train_batch: the argmax depths handed between
    stages, per-stage losses (rtol 1e-4), every gradient, the BatchNorm
    running statistics (rtol 1e-4) and the parameters after AdamW.

    Gradients: max |diff| of each tensor within 1e-3 of its largest entry +
    1e-5 of the largest gradient, or, where larger, twice the tensor's
    rounding sensitivity, measured here: the max |diff| of its gradient
    between two CPU steps whose input images differ by one ulp. Parameters:
    where |g| is above its tensor's gradient tolerance the card's update has
    the CPU's sign and the parameters agree within 1e-6; everywhere the
    card's update is AdamW's first step on its own gradient, -lr g / (|g| +
    eps), within 1e-6."""
    from mvsformerplusplus_tpu_torch.testing import conditioned_train_batch
    from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
    from mvsformerplusplus_tpu_torch.train.step import train_step
    from mvsformerplusplus_tpu_torch.train.trainer import to_device as batch_to

    runs = {}
    for run, device in (("cpu", "cpu"), ("cpu_ulp", "cpu"), ("cuda", "cuda")):
        model = tiny_model(device, train=True)
        batch = batch_to(conditioned_train_batch(), device)
        if run == "cpu_ulp":
            batch["imgs"] = torch.nextafter(batch["imgs"], batch["imgs"] + 1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            out = model(batch["imgs"], batch["cams"], batch["depth_values"])
        depths = [out[f"stage{i}"]["depth"].cpu() for i in (1, 2, 3)]
        model.load_state_dict(before)
        opt, sched = make_optimizer(model, lr=1e-3, warmup_steps=0, total_steps=10)
        lr, eps = opt.param_groups[0]["lr"], opt.defaults["eps"]
        logs = train_step(model, opt, sched, batch)
        runs[run] = dict(
            depths=depths, logs={k: float(v) for k, v in logs.items()
                                 if k == "loss" or k.startswith("stage")},
            grads={n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
            state={k: v.cpu() for k, v in model.state_dict().items()},
            before={k: v.cpu() for k, v in before.items()})
    cpu, ulp, gpu = runs["cpu"], runs["cpu_ulp"], runs["cuda"]
    gmax = max(g.abs().max().item() for g in cpu["grads"].values())
    depths_same = {run: all(torch.allclose(a, b, rtol=1e-5, atol=0)
                            for a, b in zip(cpu["depths"], runs[run]["depths"]))
                   for run in ("cpu_ulp", "cuda")}
    loss_rel = max(abs(gpu["logs"][k] - v) / abs(v) for k, v in cpu["logs"].items())
    tol, sensitive, grad_rows = {}, {}, []
    for n, g in cpu["grads"].items():
        base = 1e-3 * g.abs().max().item() + 1e-5 * gmax
        sens = (ulp["grads"][n] - g).abs().max().item()
        tol[n] = max(base, 2 * sens)
        if 2 * sens > base:
            sensitive[n] = {"base_tol": base, "ulp_sensitivity": sens}
        grad_rows.append(((gpu["grads"][n] - g).abs().max().item() / tol[n], n, tol[n]))
    grad_rows.sort()
    stat_names = [k for k in cpu["state"] if k.endswith(("running_mean", "running_var"))]
    stat_ratio = max(((gpu["state"][k] - cpu["state"][k]).abs()
                      / (2e-5 + 1e-4 * cpu["state"][k].abs())).max().item() for k in stat_names)
    firm_err, update_err = 0.0, 0.0
    for n, g in cpu["grads"].items():
        firm = g.abs() > tol[n]
        if firm.any():
            firm_err = max(firm_err, (gpu["state"][n] - cpu["state"][n])[firm].abs().max().item())
        gg = gpu["grads"][n]
        step = gpu["state"][n] - gpu["before"][n]
        update_err = max(update_err, (step + lr * gg / (gg.abs() + eps)).abs().max().item())
    same_keys = set(cpu["grads"]) == set(gpu["grads"])
    row = {"phase": "reference_train", "stage_depths_equal": depths_same,
           "loss_max_rel_err": loss_rel, "loss_rtol": 1e-4, "grad_err_over_tol": grad_rows[-1][0],
           "largest_grad": gmax, "worst_grads": grad_rows[-5:],
           "tensors_at_ulp_tolerance": sensitive, "bn_stats_err_over_tol": stat_ratio,
           "params_firm_max_abs_err": firm_err, "params_update_max_abs_err": update_err,
           "params_atol": 1e-6, "params_with_grad": len(cpu["grads"]),
           "same_params_with_grad": same_keys, "losses_cpu": cpu["logs"],
           "losses_cuda": gpu["logs"]}
    emit(row)
    if not (all(depths_same.values()) and same_keys and loss_rel <= 1e-4
            and grad_rows[-1][0] <= 1 and stat_ratio <= 1 and firm_err <= 1e-6
            and update_err <= 1e-6):
        raise SystemExit("the port's train step on the card disagrees with its plain CPU path")


def none_launched(launches, kernels) -> bool:
    """No kernel of `kernels` launched in a path's run: with F32_ONLY, every
    flash launch went through the tensor-core kernels; with WARP_SCALAR,
    every warp and warp-backward launch through the vector ones (that those
    did launch is checked by every_*kernel_launched)."""
    return not any(launches[k] for k in kernels)


def run_main_path(counters, iters=3):
    from mvsformerplusplus_tpu_torch.config import build_model, load_config

    model = build_model(load_config(CONFIG), dtype=torch.bfloat16)  # device defaults to cuda
    imgs, cams, dv = to_device(make_dtu_eval_batch(), "cuda")
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = model(imgs, cams, dv)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        depth = out["refined_depth"].float()
        conf = out["photometric_confidence"].float()
        hypo = out["stage4"]["depth_values"].float()
        lo, hi = hypo.min(dim=1).values, hypo.max(dim=1).values
        slack = 1e-3 * hypo.abs().max(dim=1).values
        checks = {
            "depth_shape": list(depth.shape) == [1, 1152, 1536],
            "depth_finite": bool(torch.isfinite(depth).all()),
            "depth_in_hypothesis_range": bool(((depth >= lo - slack) & (depth <= hi + slack))
                                              .all()),
            "confidence_in_0_1": bool(((conf >= 0) & (conf <= 1 + 1e-5)).all()),
            "every_forward_kernel_launched": all(
                launches[k] > 0 for k in ("warp_bilinear", "flash_attention_fwd",
                                          "conv2d_same")),
            "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
            "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
        }
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del out
        t0 = time.perf_counter()
        ms = time_ms(lambda: model(imgs, cams, dv), iters=iters)
        wall_s = time.perf_counter() - t0
    row = {"phase": "main_path", "config": str(CONFIG.relative_to(REPO)),
           "shape": [1, 5, 1152, 1536, 3], "depths": 192, "dtype": "bfloat16",
           "launches": launches, "checks": checks, "ms_per_map": ms, "iters": iters,
           "timing_wall_s": wall_s, "peak_mem_gb": peak_gb,
           "depth_median": float(depth.median())}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"main path checks failed: {checks}")
    emit(profile_forward(model, (imgs, cams, dv)))
    return launches


class SeededLoader:
    """The train protocol's batch, made once on the card from a seed, with
    the JAX TrainLoader's interface: `epoch(e)` yields (batch, crop_hw).
    `mark(i)`, when given, is called on the host before step i is handed
    out (after step i - 1 was dispatched) and once more after the last."""

    def __init__(self, steps: int, mark=None):
        from mvsformerplusplus_tpu_torch.train.trainer import to_device as batch_to

        self.batch = batch_to(make_train_batch(**TRAIN), "cuda")
        self.steps, self.mark = steps, mark

    def steps_per_epoch(self) -> int:
        return self.steps

    def epoch(self, e):
        for i in range(self.steps):
            if self.mark is not None:
                self.mark(i)
            yield self.batch, (TRAIN["h"], TRAIN["w"])
        if self.mark is not None:
            self.mark(self.steps)


def run_train_step(counters, iters=6):
    """The full-width train step through build_model(train=True) and the
    port's Trainer, in one epoch of 1 + `iters` steps: the first, counted
    and logged (its log read synchronises the host), then `iters` timed
    steps that log nothing, between CUDA events the loader records, with no
    host synchronisation inside the window."""
    from mvsformerplusplus_tpu_torch.config import build_model, load_config
    from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
    from mvsformerplusplus_tpu_torch.train.trainer import Trainer

    cfg = load_config(CONFIG)
    model = build_model(cfg, dtype=torch.bfloat16, train=True)
    remat = (model.cascade.stage1.remat_cost_reg, model.cascade.remat_whole_stage)
    opt, sched = make_optimizer(model, lr=1e-3, vit_lr=3e-5, weight_decay=0.01, min_lr_frac=0.01,
                                warmup_steps=500, total_steps=10000, freeze_vit=True)
    window = {}

    def mark(i):
        if i == 1:
            window["launches"] = read_counts(counters)
        window[i] = torch.cuda.Event(enable_timing=True)
        window[i].record()

    loader = SeededLoader(steps=1 + iters, mark=mark)
    trainer = Trainer(model, loader, opt, sched, logging_every=1 + iters,
                      loss_kwargs=dict(clip_func=cfg["arch"]["loss"]["clip_func"]))
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    logs = trainer.train(epochs=1)
    torch.cuda.synchronize()
    launches = window["launches"]
    ms = window[1].elapsed_time(window[1 + iters]) / iters
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), params0[n])}
    nonzero_grad = {n for n, p in model.named_parameters()
                    if p.grad is not None and bool(p.grad.ne(0).any())}
    sd = model.state_dict()
    stats_moved = sum(not torch.equal(sd[k], v) for k, v in stats0.items())
    finite = len(logs) == 1 and all(np.isfinite(v) for k, v in logs[0].items()
                                    if k == "loss" or k == "grad_norm" or k.startswith("stage"))
    checks = {
        "remat_cost_reg_from_config": remat == (True, False),
        "losses_and_grad_norm_finite": finite,
        "params_finite": all(bool(torch.isfinite(p).all()) for p in model.parameters()),
        "every_trainable_param_moved": trainable <= moved,
        "vit_unchanged": not any(n.startswith("vit.") for n in moved),
        "only_trainable_params_moved": moved <= trainable,
        "batch_norm_stats_moved": stats_moved == len(stats0),
        "every_kernel_launched": all(n > 0 for k, n in launches.items() if k not in OFF_PATH),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
    }
    row = {"phase": "train_step", "config": str(CONFIG.relative_to(REPO)),
           "shape": [TRAIN["b"], TRAIN["v"], TRAIN["h"], TRAIN["w"], 3],
           "depths": TRAIN["dfull"], "dtype": "bfloat16", "remat_granularity": "cost_reg",
           "launches_per_step": launches, "checks": checks, "ms_per_step": ms, "iters": iters,
           "first_step_ms": window[0].elapsed_time(window[1]), "peak_mem_gb": peak_gb,
           "params": {"trainable": len(trainable), "moved": len(moved),
                      "with_nonzero_grad_last_step": len(nonzero_grad),
                      "trainable_not_moved": sorted(trainable - moved)[:20],
                      "vit": sum(n.startswith("vit.") for n in params0)},
           "bn_stats": {"tensors": len(stats0), "moved": stats_moved},
           "logs": logs}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"train step checks failed: {checks}")
    emit(profile_train(model, opt, sched, loader.batch))
    return launches


LAYERS = ("encoder", "vit", "decoder_vit", "decoder", "fmt", "cascade.stage1",
          "cascade.stage2", "cascade.stage3", "cascade.stage4")
HAND_WRITTEN = ("warp_bilinear_vec_kernel", "warp_bilinear_bwd_vec_kernel",
                "warp_bilinear_scalar_kernel", "warp_bilinear_bwd_scalar_kernel",
                "flash_fwd_mma_kernel", "flash_bwd_mma_kernel", "flash_fwd_f32_kernel",
                "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel", "conv2d_same_kernel")
# the hand-written kernels no path may run: the f32 flash ones, the warps' scalar ones
OFF_PATH_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel",
                    "warp_bilinear_scalar_kernel", "warp_bilinear_bwd_scalar_kernel")


def check_kernel_names(prof, phase, want) -> None:
    """By name in the trace: the flash and warp kernels that ran are the mma
    and vector ones named, and no off-path one."""
    ours = prof["hand_written_ms_per_call"]
    if not (all(ours[k] > 0 for k in want) and not any(ours[k] for k in OFF_PATH_KERNELS)):
        raise SystemExit(f"{phase}: flash or warp kernels in the trace are not the mma and "
                         f"vector ones: {ours}")


def layer_ms(model, inputs) -> dict:
    """ms of each top-level layer's span on the device timeline over one
    forward (idle gaps inside a span included), from CUDA events recorded by
    forward hooks; `rest` is the forward's time outside those layers."""
    spans, hooks = {}, []
    for name in LAYERS:
        def pre(mod, args, name=name):
            spans[name] = [torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)]
            spans[name][0].record()

        def post(mod, args, out, name=name):
            spans[name][1].record()

        sub = model.get_submodule(name)
        hooks += [sub.register_forward_pre_hook(pre), sub.register_forward_hook(post)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        model(*inputs)
        end.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    out = {name: a.elapsed_time(b) for name, (a, b) in spans.items()}
    out["total"] = start.elapsed_time(end)
    out["rest"] = out["total"] - sum(out[n] for n in LAYERS)
    return out


def profile_run(fn, iters, top=20) -> dict:
    """torch.profiler tracing CUDA activity only (no host op recording)
    over `iters` calls of fn: device time by kernel name, the share of each
    hand-written kernel, and the device's idle share of the CUDA-event wall
    time around the same calls (one stream, so kernels do not overlap).
    Returns the last call's result under "result"."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            result = fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ours = {k: sum(ms for name, (ms, _) in by_name.items() if k in name.split("<")[0]) / iters
            for k in HAND_WRITTEN}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"iters": iters, "wall_ms_per_call": wall_ms / iters,
            "device_busy_ms_per_call": busy_ms / iters,
            "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "hand_written_ms_per_call": ours,
            "hand_written_share": sum(ours.values()) * iters / busy_ms if busy_ms else None,
            "top_kernels_per_call": [{"name": k[:160], "ms": ms / iters, "count": n / iters}
                                     for k, (ms, n) in ranked],
            "result": result}


def profile_forward(model, inputs) -> dict:
    def forward():
        with torch.inference_mode():
            model(*inputs)

    prof = profile_run(forward, iters=2)
    del prof["result"]
    check_kernel_names(prof, "profile", ("flash_fwd_mma_kernel", "warp_bilinear_vec_kernel"))
    return {"phase": "profile", "layer_ms": layer_ms(model, inputs), **prof}


def profile_train(model, opt, sched, batch, iters=3) -> dict:
    """The traced window over `iters` more train steps; their last step's
    losses and gradient norm must be finite."""
    from mvsformerplusplus_tpu_torch.train.step import train_step

    prof = profile_run(lambda: train_step(model, opt, sched, batch), iters)
    logs = prof.pop("result")
    finite = all(bool(torch.isfinite(v).all()) for k, v in logs.items()
                 if k == "loss" or k == "grad_norm" or k.startswith("stage"))
    if not finite:
        raise SystemExit("profile_train: a loss or the gradient norm is not finite")
    check_kernel_names(prof, "profile_train", ("flash_fwd_mma_kernel", "flash_bwd_mma_kernel",
                                               "warp_bilinear_vec_kernel",
                                               "warp_bilinear_bwd_vec_kernel"))
    return {"phase": "profile_train", **prof}


def _bucket_totals(epoch_stats):
    """epoch_stats of one or more runs -> per crop bucket: steps, device ms
    per step, host ms per step and the host's loader-wait share, over all
    their epochs."""
    out = {}
    for stats in epoch_stats:
        for hw, b in stats["buckets"].items():
            t = out.setdefault(hw, {"steps": 0, "ms": 0.0, "host_ms": 0.0, "wait_ms": 0.0})
            t["steps"] += b["steps"]
            t["ms"] += b["ms_per_step"] * b["steps"]
            t["host_ms"] += b["host_ms_per_step"] * b["steps"]
            t["wait_ms"] += b["loader_wait_share"] * b["host_ms_per_step"] * b["steps"]
    return {hw: {"steps": t["steps"], "ms_per_step": t["ms"] / t["steps"],
                 "host_ms_per_step": t["host_ms"] / t["steps"],
                 "loader_wait_share": t["wait_ms"] / t["host_ms"]} for hw, t in out.items()}


def run_train_cli(counters):
    """The training command line in process on the card
    (`python -m mvsformerplusplus_tpu_torch.train`'s main) with
    configs/mvsformerplusplus.json at full width, overriding only the data
    paths and lists, the batch size (2), the epochs (2), the crop scales
    (512 x 640 and 512 x 768) and the validation size (512 x 640), on one
    geometric DTU-format scan written by the port's own writers (5 views x
    7 lights at 576 x 800). Then the same command with -r --epochs 3. Checks
    every logged loss and gradient norm and every validation metric finite,
    model_last.pth and model_best.pth written, model_last.pth restoring bit
    for bit into a fresh build_model(train=True), and the resumed run
    starting at epoch 2 with the step count continued and the learning rate
    of the uninterrupted 3-epoch schedule at that step; and the steps per
    crop bucket equal to the loader's schedule."""
    import gc
    import tempfile

    from mvsformerplusplus_tpu_torch.config import build_model, load_config
    from mvsformerplusplus_tpu_torch.data.synthetic import make_geometric_dtu
    from mvsformerplusplus_tpu_torch.train import cli
    from mvsformerplusplus_tpu_torch.train.optim import warmup_cosine

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        data, save = Path(tmp) / "dtu", Path(tmp) / "saved"
        t0 = time.perf_counter()
        make_geometric_dtu(data, n_views=5, n_lights=7, h=CLI["hw"][0], w=CLI["hw"][1],
                           ndepth=192)
        write_s = time.perf_counter() - t0
        args = "data_loader;0;args;"
        argv = ["-c", str(CONFIG), "--save_dir", str(save), "--batch_size", str(CLI["batch"]),
                "--epochs", "2",
                "-o", f"{args}datapath={data}", "-o", f"{args}train_data_list={data / 'train.txt'}",
                "-o", f"{args}val_data_list={data / 'train.txt'}",
                "-o", f"{args}multi_scale_args;scales={json.dumps(CLI['scales'])}",
                "-o", f"{args}height={CLI['val_hw'][0]}", "-o", f"{args}width={CLI['val_hw'][1]}"]
        zero_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = cli.main(argv)
        first_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ck = save / "checkpoints"
        files = {n: (ck / n).exists() for n in ("model_last.pth", "model_best.pth", "meta.json")}
        fresh = build_model(load_config(CONFIG), dtype=torch.bfloat16, train=True)
        payload = torch.load(ck / "model_last.pth", weights_only=True,
                             map_location=next(fresh.parameters()).device)
        fresh.load_state_dict(payload["state_dict"])
        fresh_sd = fresh.state_dict()
        restored = all(torch.equal(fresh_sd[k], v) for k, v in first.model.state_dict().items())
        spe = first.train_loader.steps_per_epoch()
        summary = {"logged": first.logged, "epoch_stats": first.epoch_stats,
                   "val_stats": first.val_stats, "global_step": first.global_step}
        del fresh, fresh_sd, first, payload
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        resumed = cli.main(argv + ["-r", "--epochs", "3"])
        resumed_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts(counters)
        peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
        opt_args = load_config(CONFIG)["optimizer"]["args"]
        want_lr = opt_args["lr"] * warmup_cosine(2 * spe, opt_args["warmup_steps"], 3 * spe,
                                                 opt_args["min_lr"])
        logged = summary["logged"] + resumed.logged
        val_stats = summary["val_stats"] + resumed.val_stats
        epoch_stats = summary["epoch_stats"] + resumed.epoch_stats
        resumed_first = resumed.logged[0] if resumed.logged else {}
        resumed_stats = (resumed.epoch_stats, resumed.global_step)
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
    buckets = _bucket_totals(epoch_stats)
    steps, val_maps = cli_counts()
    checks = {
        "losses_and_grad_norms_finite": bool(logged) and all(
            np.isfinite(v) for e in logged for k, v in e.items()
            if k in ("loss", "grad_norm") or k.startswith("stage")),
        "val_metrics_finite": len(val_stats) == 3 and all(
            np.isfinite(v) for s in val_stats for v in s["metrics"].values()),
        "checkpoint_files": all(files.values()),
        "model_last_restores_bit_equal": restored,
        "resumed_at_epoch_2": [s["epoch"] for s in resumed_stats[0]] == [2],
        "resumed_step_count_continued": (summary["global_step"] == 2 * spe
                                         and resumed_first.get("step") == 2 * spe + 1
                                         and resumed_stats[1] == 3 * spe),
        "resumed_lr_on_the_3_epoch_schedule": abs(resumed_first.get("lr", -1) - want_lr)
        <= 1e-12 * want_lr,
        "steps_per_bucket_as_scheduled": {hw: b["steps"] for hw, b in buckets.items()}
        == {f"{h}x{w}": n for (h, w), n in steps.items() if n},
        "val_maps_as_counted": sum(s["maps"] for s in val_stats) == val_maps,
        "every_kernel_launched": all(n > 0 for k, n in launches.items() if k not in OFF_PATH),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
    }
    row = {"phase": "train_cli", "config": str(CONFIG.relative_to(REPO)),
           "argv": argv[4:], "data": {"views": 5, "lights": 7, "hw": list(CLI["hw"]),
                                           "samples": CLI["samples"], "write_s": write_s},
           "steps_per_epoch": spe, "buckets": buckets, "epochs": epoch_stats,
           "val_ms_per_map": [s["ms_per_map"] for s in val_stats],
           "val_metrics": [s["metrics"] for s in val_stats], "peak_mem_gb": peak_gb,
           "run_s": [first_s, resumed_s], "launches": launches, "checks": checks,
           "logged": logged}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"train_cli checks failed: {checks}")
    return launches


def ptxas_by_kernel(log: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel (mangled): its registers, shared
    memory and spills}."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out[name] = "; ".join(filter(None, (out.get(name), line.split(":", 1)[-1].strip())))
    return out


def sass_counts(kernels, name: str, ops=("LDG", "STG", "RED", "ATOM", "IMAD", "FFMA")):
    """Per kernel of csrc/<name>.cu: the SASS instructions cuobjdump lists
    (a static count over all branches) and those whose opcode starts with
    each of `ops` (RED covers REDG, ATOM ATOMG)."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return "cuobjdump not found"
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels._lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = out.setdefault(line.split("Function : ")[1].strip(),
                                 {"total": 0, **{op: 0 for op in ops}})
        elif cur is not None and line.strip().startswith("/*") and ";" in line:
            words = line.split("*/", 1)[1].split()
            opcode = words[1] if words[0].startswith("@") else words[0]  # after a guard
            cur["total"] += 1
            for op in ops:
                cur[op] += opcode.startswith(op)
    return out


def main() -> int:
    if not (REPO / "mvsformerplusplus_tpu_torch").is_dir() or not CONFIG.is_file():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mvsformerplusplus_tpu_torch.ops import cuda as kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {name: ptxas_by_kernel(log) for name, log in logs.items()},
          "sass": {name: sass_counts(kernels, name) for name in ("warp", "warp_bwd")}})

    counters = launch_counters()
    results = run_kernel_phase(counters)
    assert set(counters) == set(results)
    run_reference_phase()
    run_reference_train_phase()
    by_path = {"main_path": run_main_path(counters)}
    torch.cuda.empty_cache()
    by_path["train_step"] = run_train_step(counters)
    torch.cuda.empty_cache()
    by_path["train_cli"] = run_train_cli(counters)
    for name, res in results.items():
        res["launches_by_path"] = {path: by_path[path][name] for path in by_path}
        res["launches"] = sum(res["launches_by_path"].values())
        for path, n in res["launches_by_path"].items():
            checked = sum(res["cases"].get(path, {}).values())
            if checked != n:
                raise SystemExit(f"{name}: the kernel phase checks {checked} launches per run of "
                                 f"{path} at its shapes, the {path} run made {n}")
    print(card, flush=True)
    emit({"kernels": list(results.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
