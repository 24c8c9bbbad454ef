#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  device      the card (and its name and power limit from nvidia-smi, as a
              plain line of its own);
  build       nvcc builds of csrc/*.cu into build/kernels/ (all in parallel),
              and beside them g++'s build of the host library
              (csrc/host/*.cpp into build/host/, data/native.py), each
              kernel's ptxas line (registers, spills) and the warp, conv
              and flash forward kernels' SASS instruction counts
              (cuobjdump; the conv's and the flash forward's with their
              tensor-core HMMA, ldmatrix LDSM and cp.async LDGSTS);
  kernel      each hand-written kernel against its plain PyTorch version at
              every shape the paths give it (the DTU-eval forward, the train
              step, and the training CLI's train steps at 512 x 640 and
              512 x 768 and its validation forwards), element by element within
              ops.cuda.tolerance (the bf16 tensor-core flash kernels within
              their rounding budget, flash_attention.budget_tolerance), and
              the same check against a planted fault, which it must reject by
              2x or more, each checked call launching that kernel alone (by
              the counters; a warp case records its variant); the f32 flash
              kernels (the forward on 3xTF32, the backward SIMT) and the f32
              SIMT conv, which only the fp32 model runs, at the tiny
              flagship's shapes, and the warps' scalar kernels, which no
              path runs, on misaligned train-shape views and at channel
              counts outside the vector widths (bf16 12 and 3, f32 6); the
              kernel's, the plain version's and one library call's device
              time (CUDA events around calls queued behind a device spin, so
              the host's time to issue them does not count; `wall_ms`: the
              kernel's calls without the spin, host included) and the least
              time the card could take, and for the conv and the f32 flash
              forward cases the SIMT kernel's time on the same input
              (`simt_ms`);
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
              of the same forwards; every flash and conv kernel in the trace
              must be a tensor-core (mma) one and every warp kernel a vector
              one;
  train_step  the full-width flagship train step (B=2, 5 views, 512 x 640,
              192 depths, bf16, frozen ViT, remat of the regularizers, CE at
              all stages, two-group AdamW with warmup-cosine) through
              build_model(train=True) and the port's Trainer fed by a seeded
              loader: launches per step of every kernel, ms per step over 6
              steps with no host synchronisation, peak memory, losses,
              gradient norm and which parameters moved;
  profile_train  the same trace over three more train steps (the same
              check of the flash, conv and warp kernels' names);
  train_cli   the training command line (python -m mvsformerplusplus_tpu_torch.train)
              in process with configs/mvsformerplusplus.json at full width on
              a geometric DTU-format scan it writes (5 views x 7 lights at
              576 x 800, 2 of its views as references: 14 samples): two
              epochs at batch 2 over 512 x 640 and 512 x 768 crops with
              validation at 512 x 640, then -r to a third epoch; the
              checkpoints, a bit-equal restore, the resumed epoch, step and
              learning rate, scalars.jsonl, steps and ms per step per crop
              bucket, the host's wait on the loader, validation ms per map
              and peak memory;
  eval_cli    the eval command line (python -m mvsformerplusplus_tpu_torch.eval)
              in process with configs/mvsformerplusplus.json at full width on
              a 5-view geometric scan it writes at 1152 x 1536 (JPEG): 5
              depth maps at 192 depths with dpcd fusion, then --skip_depth
              with pcd and gipuma; the output files, depth and confidence
              checks, the scan's GT depths fused on the card and on the CPU
              with each method, ms per map end to end and the forward's,
              decode and encode ms per image, the loader-wait share, fusion
              seconds and points per method, peak memory; then a bench.py-
              shaped line {"metric", "value" (maps/s), ...};
  casmvs_reference, casmvs_reference_train
              the reference phases on a small CasMVSNet (fp32);
  casmvs_main_path, casmvs_profile
              CasMVSNet (configs/casmvs.json, build_model: bf16) at DTU eval
              (1 x 5 x 1152 x 1536, 192 depths), as main_path and profile;
              no flash kernel may launch (the model has no attention);
  casmvs_train_step, casmvs_profile_train
              its train step at the config's micro-batch of 4 at 512 x 640
              through the port's Trainer, as train_step and profile_train;
  casmvs_cli  the training command line with configs/casmvs.json on
              train_cli's scan and crops, batch 4, one epoch with validation
              (scalars.jsonl and the panels read back), then the eval command
              line with its checkpoints on eval_cli's scan (5 maps, dpcd);
  blended_cli the training command line with configs/mvsformerplusplus_ft.json
              (--finetune from train_cli's checkpoints, --debug) on a BlendedMVS-
              layout scan it writes (8 views at 1536 x 2048, JPEG), one epoch of
              512 x 640 crops at batch 4, validation at 1536 x 2048: metrics on
              the "blended" interval scale, scalars.jsonl's train, val and
              debug records, every module's gradient norm finite and no
              non-finite gradient, the panels, ms per step, validation ms per
              map, decode ms per image, peak memory;
  variants_reference, variants_reference_train, variants_reference_modules
              the reference phases on a small variant flagship (fp32; the
              JAX package's variants no shipped config selects: the log_var
              uncertainty head, reg depth at stages 3-4, SwiGLU in the ViT
              decoder and FMT; its log_var heads tempered), then an
              FPNEncoder(norm="IN") at the flagship's widths and a
              CostRegNet2D, forward and backward, card against CPU;
  variants_main_path
              configs/mvsformerplusplus.json with those variants
              (VARIANT_OVERRIDES) at main_path's shape, as main_path (no
              profile): log_var finite at stages 3-4 and absent at 1-2;
  variants_train_step
              the same config at train_step's protocol, as train_step (no
              profile): the uncertainty terms logged and finite, the
              2-channel heads and the SwiGLU blocks moved;
  dist_step   the flagship's train step on train_step's global batch (B=2,
              512 x 640) on one rank, again, and on images a bf16 ulp apart (its
              rounding sensitivity), then through parallel.dist.launch four
              ways, each held to the one-rank step by the reference_train
              phase's rule, its sensitivity measured by re-runs and bf16-ulp
              probes (compare_steps: the losses, the gradients and the
              BatchNorm running statistics, the parameters after AdamW): two gloo ranks
              sharing the card at --mesh 2,1 (one sample each), two at
              --mesh 1,2 (view-sharded: two source views each), two at
              --mesh 1,2 depth-sharded (half the hypotheses each), and the
              NCCL path at world 1; ms per step and peak memory per rank;
  train_cli_mesh
              the training command line with --mesh 2,1 (two gloo ranks on
              the card) on train_cli's scan: one epoch with validation, then
              -r to a second; one set of checkpoints, one scalars.jsonl, both
              ranks' losses, metrics and final weights equal, ms per step;
  eval_queue  eval_cli's scan copied into 2 scans: depth maps by two eval
              command line processes with --schedule queue sharing the card,
              then by one process; every scan claimed once and done, every
              depth map the one process's, maps/s at 2 and at 1 worker;
  e2e_protocol
              the port's end-to-end accuracy protocol
              (mvsformerplusplus_tpu_torch/tools/e2e_protocol.py) at the
              DTU eval protocol on data a process of its own renders from the
              start of the run (the analytic scene, a 5-view x 7-light train
              set and a 5-view eval scan at 1152 x 1536): CasMVSNet trained
              for E2E["casmvs_epochs"] epochs over 512 x 640, 768 x 960 and
              1024 x 1280 crops, then 5 maps at 192 depths fused by pcd, dpcd
              and gipuma, every filter's depth and cloud metrics printed
              beside the JAX artifact's, the pcd run held to
              tests/test_e2e_protocol.py's gates; then the flagship's
              FLAGSHIP_ARCH (a ViT of heads of 24, trained) for one epoch,
              its files and finite metrics; the TensorBoard mirror's events
              counted and their CRCs checked (paths e2e_casmvs, e2e_flagship);
  vit_pth     a DINOv2 .pth at full ViT-B width from seeded weights under
              the reference key names, loaded through the eval and the
              training command lines' loaders, bit-equal to the same weights
              from the converted .npz;
  dino_match  the DINOv2 matcher with a seeded fp32 ViT-B on the card (the
              f32 flash kernel at head dim 64) at the tool's working size
              (long side 644: 35 x 46 patches) under utils/profiler.trace: a
              blocky image's shift recovered, the matches the CPU's; first,
              outside the counted run, the JAX tool's test at its size and
              gates;
  scene_convert
              the port's scene converters through their command lines on
              scenes of the analytic scene (SCENE_CONVERT): a 12-frame NeRF
              scene at 1152 x 1536 with ORB on the host and with the DINOv2
              matcher on the card (the f32 flash kernel, 2 x 12 launches per
              match call), a 49-view COLMAP text model at 1200 x 1600 with
              --convert_format from PNG, BMP, LZW TIFF and an EXIF-rotated
              JPEG, then the eval command line --dataset custom on 2
              references of the converted scan; the native ORB against
              cv2's keypoints and descriptors of two committed images
              (tests/data/make_orb_fixtures.py), each view's converted
              depth range against its true depth;
  host_codec  the host library against the numpy codec on images it makes at
              1152 x 1536, 1536 x 2048 and 1200 x 1600: JPEG encode (bytes
              equal), decode (pixels equal) and a Paeth PNG's row unfilter
              (equal), ms per image each; OpenCV's share against data/
              image.py's numpy versions (equal): the area shrink at 0.55
              and 0.6133 of 1200 x 1600, the nearest shrink of a depth map,
              the hue shift of a 512 x 640 crop and the linear resize at the
              eval scripts' three sizes; the committed files PIL (or
              libjpeg-turbo) wrote (tests/data/, make_image_fixtures.py:
              progressive, CMYK, YCCK, arithmetic-coded and lossless JPEG,
              16-bit, 4-bit and Adam7 PNG decoded natively and by numpy,
              PNM, GIF, WebP and JPEG 2000 natively) against PIL's stored
              pixels, a 1152 x 1536 progressive JPEG's native decode (its
              pixels' SHA-256 PIL's) timed against the baseline file of the
              same image and quality, and the same photo as lossy WebP and
              9/7 JPEG 2000 (SHA-256 of PIL's RGB) timed; the host stages of one DTU training view; then the
              input-pipeline bench (tools/bench_input_pipeline.py) at its
              defaults for 20 steps at train_step's measured ms per step,
              and its JSON, its resizes and hue shifts all native.
Each path (main_path, train_step, train_cli, eval_cli, casmvs_main_path,
casmvs_train_step, variants_main_path, variants_train_step, casmvs_cli,
blended_cli, dist_step, train_cli_mesh, eval_queue, e2e_casmvs, e2e_flagship,
dino_match, scene_convert) is run with every kernel's launch count set to 0 just before it
and read just after, the counts of the processes it starts reported back by
each (ops.cuda.launch_counts) and added; the kernel phase's cases must add
up to those counts (so the f32 flash and conv kernels and the warps' scalar
kernels, whose cases belong to no path, must not launch there, nor any flash
kernel on a CasMVSNet path). The host library's and the numpy codec's call
counts are set to 0 with them: on eval_cli, casmvs_cli, blended_cli,
eval_queue and e2e_protocol every JPEG decode must be a native one (as many
as DecodedImages' misses and fusion's reads) and no plain version (the
numpy codec, data/image.py's resizes and hue shift) may run.
Then the eval CLI's metric line, the {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. Needs one CUDA card.
"""
import concurrent.futures
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "mvsformerplusplus.json"
CASMVS_CONFIG = REPO / "configs" / "casmvs.json"
FT_CONFIG = REPO / "configs" / "mvsformerplusplus_ft.json"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
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
TINY_CASMVS = dict(feat_chs=(4, 8, 16, 32), ndepths=(8, 4, 4, 4), groups=(4, 4, 4, 4))
# the variant flagship: the JAX package's variants that no shipped config
# selects, over configs/mvsformerplusplus.json (the uncertainty head at the
# CostRegNet3D stages, reg depth at stages 3-4, SwiGLU in the ViT decoder and
# FMT), and its tiny fp32 twin for the reference phases
VARIANT_OVERRIDES = {"arch;args;log_var": True,
                     "arch;args;depth_type": ["ce", "ce", "reg", "reg"],
                     "arch;args;dino_cfg;decoder_cfg;ffn_type": "glu",
                     "arch;args;FMT_config;ffn_type": "glu"}
TINY_VARIANT = dict(TINY, decoder_cfg=dict(TINY["decoder_cfg"], ffn_type="glu"),
                    fmt_config=dict(TINY["fmt_config"], ffn_type="glu"),
                    depth_type=("ce", "ce", "reg", "reg"), log_var=True)


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


def device_ms(fn, iters=5) -> float:
    """Device ms per call of fn: after a warm call, `iters` calls queued
    behind a spin of the device (torch.cuda._sleep) that outlasts the host's
    time to queue them, between CUDA events, so that a call the device
    finishes faster than the host issues it is timed at its device time, not
    at the host's (Python, the wrapper's checks, the launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s * iters + 1e-3) * 2e9))  # cycles at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def release() -> None:
    """Free what a finished run left on the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- kernel cases
# Each `*_cases` yields (case, launches, args, TPU rows) for every shape a
# path gives the kernel; `launches` maps each path that gives it that shape to how
# often one run of the path calls the kernel there, so per path they sum to
# the kernel's launch count in that run. The paths: "main_path", the
# DTU-eval forward; "train_step", the train step; "train_cli", the training
# command line's whole run (CLI below: its train steps at two crop buckets
# and its validation forwards); "eval_cli", the eval command line's; their
# CasMVSNet counterparts "casmvs_main_path", "casmvs_train_step" and
# "casmvs_cli" (its training and eval command lines); "blended_cli", the
# BlendedMVS fine-tune's run. Each `*_fault` computes the kernel's output
# with a planted arithmetic fault (mostly as a change of the inputs), which
# # the kernel-vs-plain check must reject. The TPU rows are those of PERF.md's
# kernel table that the JAX package runs at that shape. A shape config names
# the model family whose kernels run at it: CasMVSNet runs no flash and no
# FMT smoothing conv.

TRAIN = dict(b=2, v=5, h=512, w=640, dfull=192)
# the casmvs_train_step phase: CasMVSNet at its config's micro-batch at 512 rows
CAS_TRAIN = dict(b=4, v=5, h=512, w=640, dfull=192)
TRAIN_NDEPTHS = (32, 16, 8, 4)
TRAIN_STAGE_C = (64, 32, 16, 8)

# the train_cli phase: configs/mvsformerplusplus.json on one geometric
# DTU-format scan (5 views x 7 lights at 576 x 800, pair.txt cut to its
# first 2 reference views: 14 samples), batch 2, two epochs and a resumed
# third, validating each epoch on the 14 samples
CLI = dict(samples=14, refs=2, batch=2, scales=((512, 640), (512, 768)), val_hw=(512, 640),
           epochs=3, hw=(576, 800))

# the eval_cli phase: the eval command line on one 5-view geometric scan at
# the DTU-eval size, 192 depths: 5 depth maps (each at main_path's shapes),
# then fusion of the 5 reference views, each against its 4 sources
EVAL_CLI = dict(views=5, hw=(1152, 1536), depths=192)

# the dist_step phase: the flagship's train step on the global batch of
# train_step (B=2, 512 x 640) on one rank, DIST_PROBES' five times (the step
# every layout is compared with, and its sensitivity probes), then 1 +
# `timed` steps (the compared one and the timed ones)
# on each of: two gloo ranks at --mesh 2,1 (B=1 each), two gloo ranks at
# --mesh 1,2 (2 source views each), the NCCL path at world 1 (B=2)
DIST = dict(timed=2)

# the train_cli_mesh phase: the training CLI at --mesh 2,1 (two gloo ranks
# on the card) on train_cli's scan at batch 4 (2 samples per rank: the
# train_step shapes; 3 steps an epoch), one epoch, then -r to a second
CLI_MESH = dict(epochs=2, batch=4)

# the eval_queue phase: eval_cli's scan copied into 2 scans, depth maps by
# two --schedule queue workers sharing the card, then by one process
EVAL_QUEUE = dict(scans=2, workers=2)

# the casmvs_cli phase: configs/casmvs.json through the training CLI on
# train_cli's scan and crops at batch 4 (its scale_batch_map's micro-batch
# at 512 rows: one micro-batch a step), one epoch validating on the 14
# samples; then the eval CLI on eval_cli's scan (5 maps, dpcd fusion)
CAS_CLI = dict(batch=4, epochs=1)

# the blended_cli phase: configs/mvsformerplusplus_ft.json on one
# BlendedMVS-layout scan of 8 views at the config's 1536 x 2048 (8 samples):
# one epoch of 512 x 640 crops at batch 4 (2 steps), validating the 8 views
# whole; the train and validation datasets decode each view once (16 decodes)
BLENDED = dict(views=8, hw=(1536, 2048), batch=4, scales=((512, 640),), epochs=1)


# the e2e_protocol phase: the port's tools/e2e_protocol.py at the DTU eval
# protocol (a 5-view x 7-light train set and a 5-view eval scan rendered at
# 1152 x 1536 from the analytic scene, 192 depths at eval): batch 2 over
# crops of 512 x 640, 768 x 960 and 1024 x 1280 (micro-batches of 2, 1 and
# 1; whole-stage remat at 1024 rows), the 35 samples validated at 512 x 640
# each epoch, then 5 maps fused by pcd, dpcd and gipuma; CasMVSNet for
# `casmvs_epochs` epochs (the protocol's 8 cut to fit the script's time),
# then the flagship's FLAGSHIP_ARCH (its ViT: heads of 24) for one
E2E = dict(samples=35, batch=2, crops=((512, 640), (768, 960), (1024, 1280)),
           micro={512: 2, 768: 1, 1024: 1}, hw=(1152, 1536), views=5, casmvs_epochs=2,
           flagship_epochs=1)

# the ViT a flagship shape config runs, (blocks, heads, head dim, trained):
# configs/mvsformerplusplus.json's frozen ViT-B, and FLAGSHIP_ARCH's ViT
# trained from scratch (48 channels in 2 heads of 24)
VIT_B = (12, 12, 64, False)
VIT_TINY = (3, 2, 24, True)

# the dino_match phase: the port's DINOv2 matcher with a seeded fp32 ViT-B
# on the card, a blocky image against itself shifted 28 px right: at the
# working size of the tool's one caller (tools/nerf2mvsnet.py, long side
# 644), 2 ViT forwards of 12 blocks on 35 x 46 patches; and the JAX tool's
# test at its own size (11 x 15 patches) and gates
DINO_MATCH = dict(hw=(490, 644), test_hw=(154, 210), shift=28, blocks=12)

# the scene_convert phase: the port's scene converters on scenes of the
# analytic scene at sizes users convert, rendered and written by a process
# of its own from the start of the run (render_scene_data). A NeRF scene of 12 frames at 1152 x
# 1536 (frames 1, 5 and 9 RGBA PNGs, camera_angle_x), converted with ORB on
# the host and with the DINOv2 matcher (the vit_pth phase's seeded ViT-B
# .pth) on the card: the matcher's working size is 34 x 46 patches (long
# side 644), 2 ViT forwards of 12 blocks per match call. A COLMAP text
# model of 49 views at DTU's raw 1200 x 1600 (PINHOLE, 50000 points lifted
# from the views' renders; PNG sources but view 1 a BMP, view 2 an LZW TIFF,
# view 3 a JPEG with EXIF orientation 6), converted with --convert_format;
# then the eval CLI (--dataset custom) on 2 reference views of that scan
# (each the other's one fusion source: --fusion_view 1), 5 views at the
# DTU-eval size, gipuma fusion with --num_consistent 1 (dpcd needs two
# sources; gipuma samples the nearest pixel, no warp kernel)
SCENE_CONVERT = dict(nerf_frames=12, nerf_hw=(1152, 1536), nerf_rgba=(1, 5, 9), colmap_views=49,
                     colmap_hw=(1200, 1600), colmap_points=50000,
                     colmap_formats={1: "bmp", 2: "tif", 3: "jpg6"}, eval_refs=2,
                     dino_hw=(476, 644))
# the dino conversion's flash launches: 2 x 12 per match call, the calls
# counted in its run (scene_convert fills it before the launch check)
SCENE_DINO_RUNS: dict = {}


class ShapeConfig(NamedTuple):
    """One shape a path runs the model at (shape_configs)."""
    name: str
    kind: str  # "eval" or "train"
    bhw: tuple  # (B, H, W)
    seed: int  # the batch's
    runs: dict  # {path: runs of this shape per run of the path}
    model: str  # "flagship" or "casmvs"
    views: int = 4  # the source views a rank warps
    # {path: runs} of a split rank's other kernels at this unsharded twin's
    # shapes, and of its visibility nets
    shared: dict = {}
    shared_vis: dict = {}
    parts: int = 1  # of the hypotheses a rank warps
    remat: str = "cost_reg"  # a train config's granularity ("stage" replays
    # each stage's warps and visibility convs in the backward)
    vit: tuple = VIT_B


def schedule_steps(samples, scales, batch, epochs):
    """Train steps per crop bucket over `epochs` epochs of the loader's
    schedule (drawn from its seed)."""
    from mvsformerplusplus_tpu_torch.data.mvs_dataset import ShapeBucketSchedule

    sched = ShapeBucketSchedule(samples, scales, batch, seed=0)
    steps = {tuple(hw): 0 for hw in scales}
    for epoch in range(epochs):
        for _, hw in sched.epoch(epoch):
            steps[tuple(hw)] += 1
    return steps


def cli_counts():
    """Train steps per crop bucket over the CLI run's three epochs and its
    validation maps."""
    return (schedule_steps(CLI["samples"], CLI["scales"], CLI["batch"], CLI["epochs"]),
            CLI["samples"] * CLI["epochs"])


def shape_configs():
    """The ShapeConfigs of every path: the flagship's DTU eval forward (also the variant flagship's,
    variants_main_path), its train step at
    512 x 640 (the train_step path and the CLI's 512 x 640 bucket), the
    CLI's 512 x 768 bucket and the CLI's validation forwards (B=1, 512 x
    640, eval mode; its train step also the variant flagship's,
    variants_train_step); CasMVSNet's DTU eval forward (casmvs_main_path and the
    casmvs_cli's eval maps), its train step at micro-batch 4 at 512 x 640 and
    512 x 768 and its validation forwards; the flagship's BlendedMVS
    validation forward at 1536 x 2048 and its fine-tune step at micro-batch
    4 at 512 x 640; the ranks' train steps at B=1 (dist_step's --mesh 2,1;
    train_cli_mesh's ranks step at train_step's B=2), the view-sharded rank's
    step (dist_step's --mesh 1,2: B=2, 2 of the 4 source views) and the
    depth-sharded rank's (dist_step's --mesh 1,2 with shard_depth: B=2, half
    the hypotheses of every stage). Only the warps and the visibility nets
    see a view split, only the warps a depth split: the other kernels of a
    split rank run at its unsharded twin's shapes, whose `shared` and
    `shared_vis` count them. The e2e_protocol paths' configs (e2e_configs)
    follow. A config no path runs is left out."""
    steps, val_maps = cli_counts()
    cas = schedule_steps(CLI["samples"], CLI["scales"], CAS_CLI["batch"], CAS_CLI["epochs"])
    blended = schedule_steps(BLENDED["views"], BLENDED["scales"], BLENDED["batch"],
                             BLENDED["epochs"])
    mesh = schedule_steps(CLI["samples"], CLI["scales"], CLI_MESH["batch"], CLI_MESH["epochs"])
    rank_steps = 2 * (1 + DIST["timed"])  # two ranks, a compared step and the timed ones
    queue_maps = 2 * EVAL_QUEUE["scans"] * EVAL_CLI["views"]  # the queue's run and one process's
    C = ShapeConfig
    configs = [
        C("eval1152", "eval", (1, 1152, 1536), 0,
          {"main_path": 1, "eval_cli": EVAL_CLI["views"], "eval_queue": queue_maps,
           "variants_main_path": 1, "scene_convert": SCENE_CONVERT["eval_refs"]}, "flagship"),
        C("train640", "train", (2, 512, 640), 1,
          {"train_step": 1, "train_cli": steps[(512, 640)],
           "dist_step": len(DIST_PROBES) + 1 + DIST["timed"],
           "train_cli_mesh": 2 * mesh[(512, 640)], "variants_train_step": 1}, "flagship",
          shared={"dist_step": 2 * rank_steps}, shared_vis={"dist_step": rank_steps}),
        C("train768", "train", (2, 512, 768), 1,
          {"train_cli": steps[(512, 768)], "train_cli_mesh": 2 * mesh[(512, 768)]}, "flagship"),
        C("eval640", "eval", (1, 512, 640), 1,
          {"train_cli": val_maps, "train_cli_mesh": CLI["samples"] * CLI_MESH["epochs"]},
          "flagship"),
        C("casmvs_eval", "eval", (1, 1152, 1536), 0,
          {"casmvs_main_path": 1, "casmvs_cli": EVAL_CLI["views"]}, "casmvs"),
        C("casmvs_train", "train", (4, 512, 640), 1,
          {"casmvs_train_step": 1, "casmvs_cli": cas[(512, 640)]}, "casmvs"),
        C("casmvs_train768", "train", (4, 512, 768), 1, {"casmvs_cli": cas[(512, 768)]},
          "casmvs"),
        C("casmvs_val", "eval", (1, 512, 640), 1,
          {"casmvs_cli": CLI["samples"] * CAS_CLI["epochs"]}, "casmvs"),
        C("blended_val", "eval", (1,) + BLENDED["hw"], 2,
          {"blended_cli": BLENDED["views"] * BLENDED["epochs"]}, "flagship"),
        C("blended_train", "train", (BLENDED["batch"],) + BLENDED["scales"][0], 1,
          {"blended_cli": blended[BLENDED["scales"][0]]}, "flagship"),
        C("rank640", "train", (1, 512, 640), 1, {"dist_step": rank_steps}, "flagship"),
        C("shard640", "train", (2, 512, 640), 1, {"dist_step": rank_steps}, "flagship",
          views=2),
        C("depth640", "train", (2, 512, 640), 1, {"dist_step": rank_steps}, "flagship",
          parts=2),
    ]

    def shape(c):  # what the kernels see: all but the name, seed and runs
        return c._replace(name=None, seed=None, runs=None)

    for c in e2e_configs():
        same = [i for i, o in enumerate(configs) if shape(o) == shape(c)]
        if same:
            configs[same[0]] = configs[same[0]]._replace(runs=_plus(configs[same[0]].runs,
                                                                    c.runs))
        else:
            configs.append(c)
    return [c for c in configs if any(c.runs.values())]


def e2e_configs():
    """The e2e_protocol paths' shape configs: per model, its train steps'
    micro-batches per crop bucket (two micro-batches of one sample a step
    at 768 and 1024 rows; whole-stage remat at 1024), its validation
    forwards at 512 x 640 and its 5 eval maps. A CasMVSNet config equal to
    one of the other paths' takes its runs there."""
    out = []
    for family, path, epochs, vit in (("casmvs", "e2e_casmvs", E2E["casmvs_epochs"], VIT_B),
                                      ("flagship", "e2e_flagship", E2E["flagship_epochs"],
                                       VIT_TINY)):
        steps = schedule_steps(E2E["samples"], E2E["crops"], E2E["batch"], epochs)
        for (h, w), n in steps.items():
            mb = E2E["micro"][h]
            out.append(ShapeConfig(f"{path}_train{h}", "train", (mb, h, w), 1,
                                   {path: n * (E2E["batch"] // mb)}, family,
                                   remat="stage" if h == 1024 else "cost_reg", vit=vit))
        out.append(ShapeConfig(f"{path}_val", "eval", (1,) + E2E["crops"][0], 1,
                               {path: E2E["samples"] * epochs}, family, vit=vit))
        out.append(ShapeConfig(f"{path}_eval", "eval", (1,) + E2E["hw"], 0,
                               {path: E2E["views"]}, family, vit=vit))
    return out


def _config_batch(bhw, seed):
    b, h, w = bhw
    return to_device(make_dtu_eval_batch(b=b, h=h, w=w, seed=seed), "cuda")


def _times(runs, n):
    return {path: n * k for path, k in runs.items() if k}


def _plus(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


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


def stage_coords(cams, dv, stage, nd, hh, ww, views=4, parts=1):
    """Warp coordinates of one stage with the first `views` source views
    (all 4, or cv rank 0's under view sharding) folded into the batch,
    view-major, as StageNet.build_volume folds them, at the first nd / parts
    of the nd hypotheses of the inverse-depth init range (all, or cv rank
    0's under depth sharding): [views*B, nd / parts, hh, ww, 2]."""
    from mvsformerplusplus_tpu_torch.ops.geometry import compose_projection, plane_sweep_coords
    from mvsformerplusplus_tpu_torch.ops.sampling import init_inverse_range

    projs = compose_projection(cams[f"stage{stage}"])  # [B, V, 4, 4]
    b = projs.shape[0]
    src = projs[:, 1:1 + views].transpose(0, 1).reshape(views * b, 4, 4)
    ref = projs[:, 0].repeat(views, 1, 1)
    hypo = init_inverse_range(dv, nd, hh, ww)[:, :nd // parts].repeat(views, 1, 1, 1)
    return plane_sweep_coords(src, ref, hypo, hh, ww)[0]


def _stage_shapes(h, w):
    return [(i + 1, nd, c, h // 2 ** (3 - i), w // 2 ** (3 - i))
            for i, (nd, c) in enumerate(zip(TRAIN_NDEPTHS, TRAIN_STAGE_C))]


def warp_tpu_rows(stage, nd, c, ww, sharded=False):
    """The TPU kernel rows (PERF.md's table) the JAX package's StageNet plan
    (models/stagenet.py resolve_warp_plan) gives this stage's warp: under
    the default 'auto' mode (banded on a TPU: rows 1 and, with
    banded_fused=False, 5 where W is a 128-multiple >= 384, else row 4, for
    C up to 32 / 16; wider C falls back to XLA's gather) and under warp_mode
    'pallas' (rows 10, and 12 where it folds the depth axis: the stages of 8
    re-centered depths; C up to 16, W a 128-multiple). Under view or depth
    sharding the plan demotes the banded warp to 'pallas' and folds no
    depth: row 10 where C <= 16 and W is a 128-multiple, else XLA."""
    if sharded:
        return (10,) if c <= 16 and ww % 128 == 0 else ()
    blocked = ww % 128 == 0 and ww >= 384
    rows = []
    if c <= (32 if blocked else 16):
        rows += [1, 5] if blocked else [4]
    if c <= 16 and ww % 128 == 0:
        rows.append(12 if stage > 1 and nd == 8 else 10)
    return tuple(rows)


def warp_cases():
    """The four stage warps (source views batched) at each shape config
    (twice per train step where whole stages are rematerialised);
    the train crop's stage 3 is the TPU's narrow-row banded_warp_rows shape,
    the 512 x 768 crop's stage 3 the depth-folded blend's (row 12); then
    fusion's samples (fusion_warp_cases)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for cfg in shape_configs():
        imgs, cams, dv = _config_batch(cfg.bhw, cfg.seed)
        nsrc = cfg.views * imgs.shape[0]
        replays = 2 if cfg.kind == "train" and cfg.remat == "stage" else 1
        for stage, nd, c, hh, ww in _stage_shapes(imgs.shape[2], imgs.shape[3]):
            coords = stage_coords(cams, dv, stage, nd, hh, ww, cfg.views, cfg.parts)
            src = torch.randn(nsrc, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
            yield (f"{cfg.name}_stage{stage}", _times(cfg.runs, replays), (src, coords),
                   warp_tpu_rows(stage, nd, c, ww, cfg.views < 4 or cfg.parts > 1))
    yield from fusion_warp_cases()


def fusion_warp_cases():
    """Fusion's bilinear samples at the eval CLI's size: per reference view
    (5 in the eval_cli run) dpcd samples the 4 source depth maps (C=1) and
    pcd the 4 sources' (x, y, depth) fields (C=3), each padded to 4 f32
    channels (fusion.bilinear_sample), at the reference pixels' projections
    into the sources (the eval scan's rig, the scene's mean depth). The
    values are random: a constant field would hide the planted fault. In
    the JAX package these are XLA gathers (no TPU row). The coordinates
    [V, 1, H, W, 2] (one depth) are fusion's [V, H, W, 2]: the same
    samples."""
    from mvsformerplusplus_tpu_torch.data.io import build_camera_stack
    from mvsformerplusplus_tpu_torch.data.synthetic import geometric_cameras
    from mvsformerplusplus_tpu_torch.fusion.fusion import project_ref

    h, w = EVAL_CLI["hw"]
    v = EVAL_CLI["views"]
    cams = torch.from_numpy(np.stack([build_camera_stack(K, E)
                                      for K, E in geometric_cameras(v, h, w)])).cuda()
    wc = project_ref(torch.full((h, w), 650.0, device="cuda"), cams[0], cams[1:])[..., :2]
    static = torch.stack([wc[..., 0] / w * (w - 1), wc[..., 1] / h * (h - 1)], dim=-1)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for method, c, coords in (("dpcd", 1, wc[:, None].contiguous()),
                              ("pcd", 3, static[:, None])):
        src = torch.zeros(v - 1, h, w, 4, device="cuda")
        src[..., :c] = torch.randn(v - 1, h, w, c, generator=gen, device="cuda")
        # casmvs_cli fuses its 5 maps with dpcd alone; the e2e_protocol
        # paths fuse theirs with pcd, dpcd and gipuma, as eval_cli
        runs = {"eval_cli": v, "e2e_casmvs": v, "e2e_flagship": v,
                **({"casmvs_cli": v} if method == "dpcd" else {})}
        yield f"eval_cli_fusion_{method}", runs, (src, coords), ()


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


# the widths outside VEC_CHANNELS the scalar kernels are held at, beside the
# misaligned cases: (dtype, C) at the train crop's stage-1 and stage-4 geometry
SCALAR_WIDTHS = ((torch.bfloat16, 12), (torch.bfloat16, 3), (torch.float32, 6))


def warp_scalar_cases():
    """The scalar kernel, which no path runs (a C that is no multiple of the
    16-byte vector, or a source off a 16-byte boundary): the train crop's
    stage-1 and stage-4 warps with the source one element off, then at
    SCALAR_WIDTHS' channel counts."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for stage, nd, c, hh, ww, coords, nsrc in _train640_stages((1, 4)):
        src = torch.randn(nsrc, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
        yield f"train640_stage{stage}_misaligned", {}, (misaligned(src), coords), ()
        del src
        for dtype, cw in SCALAR_WIDTHS:
            src = torch.randn(nsrc, hh, ww, cw, generator=gen, device="cuda").to(dtype)
            yield (f"train640_stage{stage}_{str(dtype)[6:]}_c{cw}", {}, (src, coords), ())
            del src


def warp_fault(kernel, src, coords):
    """Sample positions off by 1/256 pixel."""
    return kernel(src, coords + 1 / 256)


def warp_bwd_cases():
    """The image gradient at the four stages of each train crop: the f32
    cotangent of the warped volume [8, D, H, W, C]. The TPU computes it with
    the banded transposes (rows 6 and 7) at every stage; row 11, the
    y-grouped blend's VJP, is its transpose where the pallas mode ran rows
    10 and 12, and no model path reaches it. Under view or depth sharding
    the JAX plan turns the banded backward off: row 11 where the pallas
    mode runs, else XLA's scatter."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for cfg in shape_configs():
        if cfg.kind != "train":
            continue
        imgs, cams, dv = _config_batch(cfg.bhw, cfg.seed)
        nsrc = cfg.views * imgs.shape[0]
        for stage, nd, c, hh, ww in _stage_shapes(imgs.shape[2], imgs.shape[3]):
            coords = stage_coords(cams, dv, stage, nd, hh, ww, cfg.views, cfg.parts)
            g = torch.randn(nsrc, nd // cfg.parts, hh, ww, c, generator=gen, device="cuda")
            if cfg.views < 4 or cfg.parts > 1:
                rows = ()
            else:
                rows = (7,) if ww % 128 == 0 and ww >= 384 else (6,)
            if c <= 16 and ww % 128 == 0:
                rows += (11,)  # the transpose of the pallas mode's blend there
            yield (f"{cfg.name}_stage{stage}", _times(cfg.runs, 1), (g, coords, (nsrc, hh, ww, c)),
                   rows)


def warp_bwd_scalar_cases():
    """The backward's scalar kernel, which no path runs: the train crop's
    stage-1 and stage-4 gradients with the cotangent one element off, then
    at SCALAR_WIDTHS' channel counts (the cotangent is f32 whatever the
    source: C 12, 6 and 3 take the float4, float2 and scalar reductions)."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    for stage, nd, c, hh, ww, coords, nsrc in _train640_stages((1, 4)):
        g = torch.randn(nsrc, nd, hh, ww, c, generator=gen, device="cuda")
        yield f"train640_stage{stage}_misaligned", {}, (misaligned(g), coords, (nsrc, hh, ww, c)), ()
        del g
        for _, cw in SCALAR_WIDTHS:
            g = torch.randn(nsrc, nd, hh, ww, cw, generator=gen, device="cuda")
            yield f"train640_stage{stage}_c{cw}", {}, (g, coords, (nsrc, hh, ww, cw)), ()
            del g


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
    """Per forward: the ViT's blocks on every view (12 of ViT-B's, frozen, no
    lse; the e2e flagship's 3 of heads of 24, which train: lse in a train
    step) and the 6 CTA blocks on every sample; a train step with lse and 6
    more CTA forwards, the replays of the checkpointed regularizer (or of
    the whole stage). Then a case no path runs: bf16 at head dim 32, the
    padded width of the heads of 24."""
    from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale

    gen = torch.Generator(device="cuda").manual_seed(2)
    for cfg in shape_configs():
        if cfg.model != "flagship" or cfg.views != 4 or cfg.parts > 1:
            continue
        runs = _plus(cfg.runs, cfg.shared)
        b, h, w = cfg.bhw
        v = TRAIN["v"]  # every config has 5 views
        n_vit, n_cta = _tokens(h, w)
        train = cfg.kind == "train"
        blocks, heads, dh, vit_trains = cfg.vit
        for part, (bb, n, nh, d, sc), lse, count in (
                ("vit", (b * v, n_vit, heads, dh, dh ** -0.5), train and vit_trains, blocks),
                ("cta", (b, n_cta, 4, 16, entropy_inv_scale(16, n_cta, 12185)), train,
                 12 if train else 6)):
            q, k, vv = (torch.randn(bb, n, nh, d, generator=gen, device="cuda")
                        .to(torch.bfloat16) for _ in range(3))
            yield f"{cfg.name}_{part}", _times(runs, count), (q, k, vv, sc, lse), (2,)
    q, k, vv = (torch.randn(2, 1000, 3, 32, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3))
    yield "dh32", {}, (q, k, vv, 32 ** -0.5, True), (2,)


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


# the e2e flagship's ViT attention in fp32 at its 512 x 640 crop, and at
# the padded width 32 (neither runs on a path): (B*V, N, heads, head dim)
F32_PADDED = (("dh24", (10, 321, 2, 24)), ("dh32", (2, 333, 3, 32)))


def flash_f32_cases():
    """The f32 forward at the dino_match path's shape (the fp32 ViT-B on 35
    x 46 patches and the class token, 12 blocks per image, 2 images), at the
    scene_convert path's (34 x 46 patches, 2 x 12 per match call:
    SCENE_DINO_RUNS), and at shapes no path runs: the tiny flagship's (the
    fp32 model of the reference phases), head dims 24 and 32, and q and k at
    std 3 (logits about 9x wider than at std 1, where fp32 logits lose the
    most)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = (DINO_MATCH["hw"][0] // 14) * (DINO_MATCH["hw"][1] // 14) + 1
    q, k, v = (torch.randn(1, n, 12, 64, generator=gen, device="cuda") for _ in range(3))
    yield "dino_match_vit", {"dino_match": 2 * DINO_MATCH["blocks"]}, (q, k, v, 64 ** -0.5,
                                                                       False), (2,)
    n = (SCENE_CONVERT["dino_hw"][0] // 14) * (SCENE_CONVERT["dino_hw"][1] // 14) + 1
    q, k, v = (torch.randn(1, n, 12, 64, generator=gen, device="cuda") for _ in range(3))
    yield "scene_convert_vit", SCENE_DINO_RUNS, (q, k, v, 64 ** -0.5, False), (2,)
    vit_scale, cta_scale = _tiny_scales()
    for part, (b, n, h, dh), sc, lse in (("tiny_vit", TINY_VIT, vit_scale, False),
                                         ("tiny_cta", TINY_CTA, cta_scale, True),
                                         *((name, shape, shape[3] ** -0.5, True)
                                           for name, shape in F32_PADDED)):
        q, k, v = (torch.randn(b, n, h, dh, generator=gen, device="cuda") for _ in range(3))
        yield part, {}, (q, k, v, sc, lse), (2,)
    q, k = (3 * torch.randn(2, 500, 3, 64, generator=gen, device="cuda") for _ in range(2))
    v = torch.randn(2, 500, 3, 64, generator=gen, device="cuda")
    yield "std3", {}, (q, k, v, 64 ** -0.5, True), (2,)


def flash_simt(kernel, q, k, v, scale, lse):
    """The f32 forward's SIMT kernel (the only one before the 3xTF32
    kernel) on the same values."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd_f32_simt

    return lambda: flash_attention_fwd_f32_simt(q, k, v, scale, lse)


def flash_tolerance(q, k, v, scale, lse, want):
    """The forward's rounding budget for out; lse at atol 1e-4."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (budget_tolerance,
                                                                      flash_fwd_budget)

    want = _tuple(want)
    tol = [budget_tolerance(want[0], flash_fwd_budget(q, k, v, scale))]
    if lse:
        tol.append(1e-4 + 1e-5 * want[1].abs())
    return tol


def _bwd_args(gen, shape, scale, dtype=torch.bfloat16):
    """q, k, v, dout of `shape` (q and k at std 1.5), lse and delta."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (attention_delta,
                                                                      flash_attention_plain)

    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda") * std
                     for std in (1.5, 1.5, 1, 1))
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
    return q, k, v, dout, lse, attention_delta(out, dout), scale


def flash_bwd_cases():
    """The CTA's backward at each train crop: 6 per step (one per block), one
    fused launch each; and the ViT's where it trains (the e2e flagship's 3
    blocks of heads of 24). q and k are drawn at std 1.5: at std 1 the CTA's
    scale leaves the attention nearly uniform over its 5-6k keys, O and
    delta near 0, and no check could see an error in delta. Then a case no
    path runs: head dim 32."""
    from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale

    gen = torch.Generator(device="cuda").manual_seed(5)
    for cfg in shape_configs():
        if cfg.kind != "train" or cfg.model != "flagship" or cfg.views != 4 or cfg.parts > 1:
            continue
        runs = _plus(cfg.runs, cfg.shared)
        b, h, w = cfg.bhw
        n_vit, n = _tokens(h, w)
        yield (f"{cfg.name}_cta", _times(runs, 6),
               _bwd_args(gen, (b, n, 4, 16), entropy_inv_scale(16, n, 12185)), (8,))
        blocks, heads, dh, vit_trains = cfg.vit
        if vit_trains:
            yield (f"{cfg.name}_vit", _times(runs, blocks),
                   _bwd_args(gen, (b * TRAIN["v"], n_vit, heads, dh), dh ** -0.5), (8,))
    yield "dh32", {}, _bwd_args(gen, (2, 1000, 3, 32), 32 ** -0.5), (8,)


def flash_bwd_fault(kernel, q, k, v, dout, lse, delta, scale):
    """delta = rowsum(dO * O) 8% low."""
    return kernel(q, k, v, dout, lse, 0.92 * delta, scale)


def flash_bwd_f32_cases():
    """The f32 SIMT backward at the tiny flagship's two flash shapes (the
    CTA's, which the fp32 model of reference_train runs, and the ViT's) and
    at head dims 24 and 32 (F32_PADDED); no path runs it."""
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import (attention_delta,
                                                                      flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(8)
    for part, (b, n, h, dh), scale in zip(("vit", "cta"), (TINY_VIT, TINY_CTA), _tiny_scales()):
        q, k, v, dout = (torch.randn(b, n, h, dh, generator=gen, device="cuda") for _ in range(4))
        out, lse = flash_attention_plain(q, k, v, scale, return_lse=True)
        yield f"tiny_{part}", {}, (q, k, v, dout, lse, attention_delta(out, dout), scale), (8,)
    for name, shape in F32_PADDED:
        yield name, {}, _bwd_args(gen, shape, shape[3] ** -0.5, torch.float32), (8,)


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


def _conv_runs(conv, cfg):
    """A conv case's runs at ShapeConfig cfg: a visibility net's follow the
    config's view split; the others run at a view-sharded config's shape
    only as its unsharded twin's (`shared` there), and not at its own; a
    depth-sharded config's convs all run at its twin's (`shared`, and
    `shared_vis` for its visibility nets)."""
    if cfg.parts > 1:
        return None
    if conv.startswith("visibility"):
        return _plus(cfg.runs, cfg.shared_vis)
    return _plus(cfg.runs, cfg.shared) if cfg.views == 4 else None


def _batched_conv(shapes, b, model, views=4):
    """The same convs on B samples (the batch of each grows B-fold), those
    of `model` (CasMVSNet has no FMT); a visibility net sees the `views`
    source views a rank warps (4, or 4 / n_cv under view sharding)."""
    return [(name, n, (b * (views if name.startswith("visibility") else bb), div, ci, co, k))
            for name, n, (bb, div, ci, co, k) in shapes
            if model == "flagship" or not name.startswith("fmt_")]


# the convs whose input needs a gradient on the train path, with their dx
# launches per step: not the encoder's 7x7 on the images, not each stage's
# first visibility conv on the detached entropy
CONV_DX_SHAPES = [sh for sh in CONV_SHAPES
                  if sh[0] != "encoder_7x7_3to8" and "_1to16" not in sh[0]]


def conv_cases():
    gen = torch.Generator(device="cuda").manual_seed(3)
    for cfg in shape_configs():
        b, h, w = cfg.bhw
        for conv, count, (bb, div, ci, co, k) in _batched_conv(CONV_SHAPES, b, cfg.model,
                                                               cfg.views):
            conv_runs = _conv_runs(conv, cfg)
            if conv_runs is None:
                continue
            if cfg.kind == "train" and cfg.remat == "stage" and conv.startswith("visibility"):
                count *= 2  # the stage's replay in the backward
            x = torch.randn(bb, h // div, w // div, ci, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kern = (torch.randn(k, k, ci, co, generator=gen, device="cuda")
                    * (k * k * ci) ** -0.5).to(torch.bfloat16)
            yield f"{cfg.name}_{conv}", _times(conv_runs, count), (x, kern), (3,)


# the tiny flagship's convs (TINY on the reference phase's 3 x 128 x 256
# batch, fp32) as (batch, H, W, Ci, k, Co): the encoder's 7x7 and 5x5, the
# decoder's heads, the FMT smoothing and a visibility net's three convs
TINY_CONV = [(3, 128, 256, 3, 7, 4), (3, 128, 256, 4, 5, 4), (3, 64, 128, 32, 3, 8),
             (3, 32, 64, 16, 3, 16), (3, 16, 32, 32, 3, 32), (2, 128, 256, 1, 3, 16),
             (2, 128, 256, 16, 3, 16), (2, 128, 256, 16, 3, 8)]


# the stride-1 convs of variants_reference_modules' FPNEncoder(norm="IN") at
# the flagship's widths (8, 16, 32, 64), fp32, on its 2 x 128 x 160 images
IN_FPN = dict(b=2, h=128, w=160, feat_chs=(8, 16, 32, 64))
IN_FPN_CONV = [(2, 128, 160, 3, 7, 8), (2, 128, 160, 8, 5, 8), (2, 64, 80, 16, 3, 16),
               (2, 32, 40, 32, 3, 32), (2, 16, 20, 64, 3, 64)]


def conv_f32_cases():
    """The SIMT kernel at the tiny flagship's conv shapes and at the IN
    FPN's; no path runs it (the fp32 models of the reference phases do)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for model, (b, h, w, ci, k, co) in _f32_convs():
        x = torch.randn(b, h, w, ci, generator=gen, device="cuda")
        kern = torch.randn(k, k, ci, co, generator=gen, device="cuda") * (k * k * ci) ** -0.5
        yield f"{model}_{k}x{k}_{ci}to{co}_{h}x{w}", {}, (x, kern), (3,)


def _f32_convs():
    return [("tiny", c) for c in TINY_CONV] + [("in_fpn", c) for c in IN_FPN_CONV]


def conv_fault(kernel, x, kern):
    """The top row of taps weighted 8% low."""
    kern = kern.clone()
    kern[0] *= 0.92
    return kernel(x, kern)


def conv_dx_cases():
    """dx = the conv kernel on the cotangent [B, H, W, Co] with the weights
    flipped and ci/co swapped, at each train conv whose input needs it."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    for cfg in shape_configs():
        if cfg.kind != "train":
            continue
        b, h, w = cfg.bhw
        for conv, count, (bb, div, ci, co, k) in _batched_conv(CONV_DX_SHAPES, b, cfg.model,
                                                               cfg.views):
            conv_runs = _conv_runs(conv, cfg)
            if conv_runs is None:
                continue
            g = torch.randn(bb, h // div, w // div, co, generator=gen,
                            device="cuda").to(torch.bfloat16)
            kern = (torch.randn(k, k, ci, co, generator=gen, device="cuda")
                    * (k * k * co) ** -0.5).to(torch.bfloat16)
            yield f"{cfg.name}_{conv}", _times(conv_runs, count), (g, kern), (9,)


def conv_dx_f32_cases():
    """The SIMT kernel's dx at the tiny flagship's convs whose input needs a
    gradient (not the 7x7 on the images, not a visibility net's first conv),
    and at the IN FPN's; no path runs it."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    for model, (b, h, w, ci, k, co) in _f32_convs():
        if k == 7 or ci == 1:
            continue
        g = torch.randn(b, h, w, co, generator=gen, device="cuda")
        kern = torch.randn(k, k, ci, co, generator=gen, device="cuda") * (k * k * co) ** -0.5
        yield f"{model}_{k}x{k}_{ci}to{co}_{h}x{w}", {}, (g, kern), (9,)


def conv_simt(kernel, x, kern):
    """The conv's SIMT kernel (the only one before the tensor-core kernel)
    on the same values: a copy of x off a 16-byte boundary takes it."""
    xm = misaligned(x)
    return lambda: kernel(xm, kern)


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
    """Peak rate of the products on t's type: the bf16 tensor cores, or for
    f32 the faster of the two routes that keep fp32 accuracy: 3xTF32 (three
    tf32 products for each, a third of the TF32 rate) or fp32 FMAs outside
    the tensor cores."""
    return BF16_FLOPS if t.dtype == torch.bfloat16 else max(TF32_FLOPS / 3, FP32_FLOPS)


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
    """Bytes of x, the weights and out, against the products at their type's
    peak."""
    b, hh, ww, ci = x.shape
    ky, kx, _, co = kern.shape
    return (nbytes(x, kern, out) / HBM_BYTES_S,
            2 * b * hh * ww * ky * kx * ci * co / _product_rate(x))


def conv_dx_bound(g, kern, out):
    from mvsformerplusplus_tpu_torch.ops.cuda.conv2d import dx_kernel

    return conv_bound(g, dx_kernel(kern), out)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def kernel_table():
    """name -> (source, TPU kernel it replaces, kernel, plain, cases, fault,
    library, bound, tolerance, earlier): `tolerance(*args, want)` gives the
    element-wise tolerance of each output, or None for ops.cuda.tolerance;
    `earlier(kernel, *args)`, where given, a call of the kernel the path ran
    before this one on the same values, timed beside it (`simt_ms`)."""
    from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention as fa, warp

    pallas = "mvsformerplusplus_tpu/ops/pallas/"
    return {
        "warp_bilinear": ("csrc/warp.cu", f"{pallas}warp_band.py:395; {pallas}warp_band.py:195; "
                          f"{pallas}warp_band.py:511; {pallas}warp_blend.py:132; "
                          f"{pallas}warp_blend.py:153",
                          warp.warp_bilinear, warp.warp_bilinear_plain, warp_cases, warp_fault,
                          warp_library, warp_bound, None, None),
        "warp_bilinear_bwd": ("csrc/warp_bwd.cu",
                              f"{pallas}warp_band.py:231; {pallas}warp_band.py:478; "
                              f"{pallas}warp_blend.py:217",
                              warp.warp_bilinear_bwd, warp.warp_bilinear_bwd_plain,
                              warp_bwd_cases, warp_bwd_fault, warp_bwd_library, warp_bwd_bound,
                              None, None),
        "warp_bilinear_scalar": ("csrc/warp.cu", f"{pallas}warp_band.py:395",
                                 warp.warp_bilinear, warp.warp_bilinear_plain, warp_scalar_cases,
                                 warp_fault, warp_library, warp_bound, None, None),
        "warp_bilinear_bwd_scalar": ("csrc/warp_bwd.cu", f"{pallas}warp_band.py:231",
                                     warp.warp_bilinear_bwd, warp.warp_bilinear_bwd_plain,
                                     warp_bwd_scalar_cases, warp_bwd_fault, warp_bwd_library,
                                     warp_bwd_bound, None, None),
        "flash_attention_fwd": ("csrc/flash_attention.cu", f"{pallas}flash_attention.py:131",
                                fa.flash_attention_fwd, fa.flash_attention_plain, flash_cases,
                                flash_fault, flash_library, flash_bound, flash_tolerance, None),
        "flash_attention_fwd_f32": ("csrc/flash_attention.cu", f"{pallas}flash_attention.py:131",
                                    fa.flash_attention_fwd, fa.flash_attention_plain,
                                    flash_f32_cases, flash_fault, flash_library, flash_bound,
                                    None, flash_simt),
        "flash_attention_bwd": ("csrc/flash_attention_bwd.cu", f"{pallas}flash_attention.py:263",
                                fa.flash_attention_bwd, fa.flash_attention_bwd_plain,
                                flash_bwd_cases, flash_bwd_fault, flash_bwd_library,
                                _flash_bwd_bound(5), flash_bwd_tolerance, None),
        "flash_attention_bwd_dkv_f32": ("csrc/flash_attention_bwd.cu",
                                        f"{pallas}flash_attention.py:263",
                                        fa.flash_attention_bwd_dkv,
                                        fa.flash_attention_bwd_dkv_plain, flash_bwd_f32_cases,
                                        flash_bwd_fault, flash_bwd_library, _flash_bwd_bound(4),
                                        None, None),
        "flash_attention_bwd_dq_f32": ("csrc/flash_attention_bwd.cu",
                                       f"{pallas}flash_attention.py:263",
                                       fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain,
                                       flash_bwd_f32_cases, flash_bwd_fault, flash_bwd_library,
                                       _flash_bwd_bound(3), None, None),
        "conv2d_same": ("csrc/conv2d.cu", f"{pallas}conv2d.py:176",
                        conv2d.conv2d_same, conv2d.conv2d_same_plain, conv_cases, conv_fault,
                        conv_library, conv_bound, None, conv_simt),
        "conv2d_same_dx": ("csrc/conv2d.cu", f"{pallas}conv2d.py:224",
                           conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain, conv_dx_cases,
                           conv_dx_fault, conv_dx_library, conv_dx_bound, None, conv_simt),
        "conv2d_same_f32": ("csrc/conv2d.cu", f"{pallas}conv2d.py:176",
                            conv2d.conv2d_same, conv2d.conv2d_same_plain, conv_f32_cases,
                            conv_fault, conv_library, conv_bound, None, None),
        "conv2d_same_dx_f32": ("csrc/conv2d.cu", f"{pallas}conv2d.py:224",
                               conv2d.conv2d_same_dx, conv2d.conv2d_same_dx_plain,
                               conv_dx_f32_cases, conv_dx_fault, conv_dx_library, conv_dx_bound,
                               None, None),
    }


def launch_counters():
    """Each kernel of kernel_table() -> (wrapper, the attribute counting its
    launches): the flash, warp and conv wrappers count each kernel they
    choose apart."""
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
            "conv2d_same": (conv2d.conv2d_same, "launches_mma"),
            "conv2d_same_dx": (conv2d.conv2d_same_dx, "launches_mma"),
            "conv2d_same_f32": (conv2d.conv2d_same, "launches_simt"),
            "conv2d_same_dx_f32": (conv2d.conv2d_same_dx, "launches_simt")}


def zero_counts(counters) -> None:
    """Every kernel's launch count and the host library's and numpy codec's
    call counts set to 0."""
    from mvsformerplusplus_tpu_torch.data import native

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    for table in (native.calls, native.plain_calls):
        table.update(dict.fromkeys(table, 0))


def read_host_counts(children=()) -> dict:
    """This process's calls of each host library entry point ("native") and
    of the numpy codec ("plain"), plus those spawned processes reported
    (`children`, each a read_host_counts())."""
    from mvsformerplusplus_tpu_torch.data import native

    counts = {"native": dict(native.calls), "plain": dict(native.plain_calls)}
    for child in children:
        for kind, table in counts.items():
            for k in table:
                table[k] += child[kind][k]
    return counts


def host_checks(host, decodes: int, png: bool = False) -> dict:
    """Every JPEG the path read went through the host library: as many
    native decodes (one scan each) as the path counted (`decodes`: its
    DecodedImages misses and fusion's reads), the numpy codec never called,
    and where the path trains on DTU PNGs (`png`) their rows unfiltered
    natively; no numpy plain version of the library (the codec, the
    resizes, the hue shift) ran."""
    n = host["native"]
    checks = {"jpeg_decodes_native": n["jpeg_reconstruct"] == n["jpeg_decode_scan"] == decodes,
              "plain_versions_unused": not any(host["plain"].values())}
    if png:
        checks["png_rows_native"] = n["png_unfilter"] > 0
    return checks


def read_counts(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


# the kernels only the fp32 model launches (the f32 flash kernels, the conv's
# SIMT one), and the warps' scalar kernels: no model path may launch them
# (the dino_match and scene_convert paths' fp32 ViT runs the f32 flash
# forward, checked there)
F32_ONLY = ("flash_attention_fwd_f32", "flash_attention_bwd_dkv_f32", "flash_attention_bwd_dq_f32")
CONV_SIMT = ("conv2d_same_f32", "conv2d_same_dx_f32")
WARP_SCALAR = ("warp_bilinear_scalar", "warp_bilinear_bwd_scalar")
OFF_PATH = F32_ONLY + CONV_SIMT + WARP_SCALAR


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


# each kernel's (source, TPU kernel, library, earlier, kernel-phase rows)
KERNEL_ROWS: dict = {}


def kernel_summary(name) -> dict:
    """A kernel's entry of the kernels line from its kernel-phase rows, each
    case's time x its launches per path run; built again after the paths
    ran, as scene_convert counts its case's launches in its own run."""
    src, replaces, library, earlier, rows = KERNEL_ROWS[name]
    paths = sorted({p for r in rows for p in r["launches_by_path"]})

    def total(key, path=None):
        if not paths:  # a kernel no path runs: each case once
            return sum(r[key] for r in rows)
        return sum(r[key] * n for r in rows for p, n in r["launches_by_path"].items()
                   if path in (None, p))

    return {
        "name": name, "route": "cuda", "source": f"mvsformerplusplus_tpu_torch/{src}",
        "replaces": replaces, "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: total(k) for k in ("ms", "plain_ms", "bound_ms")},
        "library_ms": total("library_ms") if library is not None else None,
        **({"simt_ms": total("simt_ms")} if earlier is not None else {}),
        "bound_by": max(rows, key=lambda r: r["bound_ms"] * sum(
            r["launches_by_path"].values()))["bound_by"],
        "times": ("summed over the runs of the paths it serves (a forward, a train step, "
                  "a command line's run): each case's time x its launches there"
                  if paths else "no path runs it: one launch of each case, summed"),
        "max_err_over_tol": max(r["err_over_tol"] for r in rows),
        "min_fault_err_over_tol": min(r["fault_err_over_tol"] for r in rows),
        "cases": {p: {r["case"]: r["launches_by_path"][p] for r in rows
                      if p in r["launches_by_path"]} for p in paths},
        "by_path": {p: {k: (total(k, p) if library is not None or k != "library_ms"
                            else None)
                        for k in ("ms", "plain_ms", "bound_ms", "library_ms")
                        + (("simt_ms",) if earlier is not None else ())}
                    for p in paths},
    }


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
    for name, (src, replaces, kernel, plain, cases, fault, library, bound, tolerance,
               earlier) in kernel_table().items():
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
            row["ms"] = device_ms(lambda: kernel(*args))
            row["wall_ms"] = time_ms(lambda: kernel(*args))
            row["plain_ms"] = device_ms(lambda: plain(*args), iters=2)
            row["library_ms"] = device_ms(library(*args)) if library is not None else None
            if earlier is not None:
                row["simt_ms"] = device_ms(earlier(kernel, *args))
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
        KERNEL_ROWS[name] = (src, replaces, library, earlier, rows)
        results[name] = kernel_summary(name)
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

def tiny_model(device, train=False, family="flagship"):
    """The small flagship (or CasMVSNet, or the variant flagship) in fp32
    with seeded weights, its regularizers checkpointed as on the train path;
    the variant's uncertainty heads tempered (testing.temper_log_var_heads)."""
    from mvsformerplusplus_tpu_torch.config import init_weights
    from mvsformerplusplus_tpu_torch.models.casmvs import CasMVSNet
    from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
    from mvsformerplusplus_tpu_torch.testing import temper_log_var_heads

    cls, kwargs = {"flagship": (DINOv2MVSNet, TINY), "casmvs": (CasMVSNet, TINY_CASMVS),
                   "variants": (DINOv2MVSNet, TINY_VARIANT)}[family]
    model = cls(**kwargs, remat_granularity="cost_reg", dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    temper_log_var_heads(model)
    return model.to(device).train(train)


def tiny_depth_types(family):
    return TINY_VARIANT["depth_type"] if family == "variants" else ("ce",) * 4


def run_reference_phase(family="flagship"):
    """The tiny model, fp32: kernels on the card vs plain versions on the CPU."""
    from mvsformerplusplus_tpu_torch.testing import well_conditioned

    batch = make_dtu_eval_batch(v=3, h=128, w=256, dfull=48, seed=1)
    outs = {}
    for device in ("cpu", "cuda"):
        model = tiny_model(device, family=family)
        with torch.inference_mode():
            out = model(*to_device(batch, device))
        outs[device] = {k: out[k].float().cpu() for k in ("refined_depth",
                                                            "photometric_confidence")}
        outs[device]["prob4"] = out["stage4"]["prob_volume"].float().cpu()
        outs[device]["dv4"] = out["stage4"]["depth_values"].float().cpu()
        outs[device]["log_var"] = [out[f"stage{i}"]["log_var"].float().cpu()
                                   for i in range(1, 5) if "log_var" in out[f"stage{i}"]]
    cpu, gpu = outs["cpu"], outs["cuda"]
    mask = torch.from_numpy(well_conditioned(cpu["dv4"], float(batch[2].max())))
    depth_rel = ((gpu["refined_depth"] - cpu["refined_depth"]).abs()
                 / cpu["refined_depth"].abs())[mask].max().item()
    conf_err = (gpu["photometric_confidence"] - cpu["photometric_confidence"]).abs().max().item()
    prob_err = (gpu["prob4"] - cpu["prob4"]).abs().max().item()
    lv_err = max([(g - c).abs().max().item() for g, c in zip(gpu["log_var"], cpu["log_var"])],
                 default=0.0)
    lv_stages = len(cpu["log_var"]) == len(gpu["log_var"]) == (3 if family == "variants" else 0)
    row = {"phase": PHASE_PREFIX[family] + "reference",
           "pixels_compared": float(mask.float().mean()),
           "depth_max_rel_err": depth_rel, "depth_rtol": 1e-3, "conf_max_abs_err": conf_err,
           "prob_max_abs_err": prob_err, "log_var_max_abs_err": lv_err,
           "log_var_stages": len(cpu["log_var"]), "atol": 1e-3}
    emit(row)
    if not (mask.float().mean() > 0.5 and depth_rel <= 1e-3 and conf_err <= 1e-3
            and prob_err <= 1e-3 and lv_err <= 1e-3 and lv_stages):
        raise SystemExit("the port on the card disagrees with its plain CPU path")


def run_reference_train_phase(family="flagship"):
    """One train step of the tiny model (fp32, remat of the regularizers)
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
        model = tiny_model(device, train=True, family=family)
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
        logs = train_step(model, opt, sched, batch, depth_types=tiny_depth_types(family))
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
    uncertainty = {f"stage{i}_uncertainty" for i in (3, 4)} if family == "variants" else set()
    same_keys = same_keys and uncertainty <= set(cpu["logs"]) and set(cpu["logs"]) == set(
        gpu["logs"])
    row = {"phase": PHASE_PREFIX[family] + "reference_train", "stage_depths_equal": depths_same,
           "loss_max_rel_err": loss_rel, "loss_rtol": 1e-4, "grad_err_over_tol": grad_rows[-1][0],
           "largest_grad": gmax, "worst_grads": grad_rows[-5:],
           "tensors_at_ulp_tolerance": sensitive, "bn_stats_err_over_tol": stat_ratio,
           "params_firm_max_abs_err": firm_err, "params_update_max_abs_err": update_err,
           "params_atol": 1e-6, "params_with_grad": len(cpu["grads"]),
           "same_params_and_losses": same_keys, "losses_cpu": cpu["logs"],
           "losses_cuda": gpu["logs"]}
    emit(row)
    if not (all(depths_same.values()) and same_keys and loss_rel <= 1e-4
            and grad_rows[-1][0] <= 1 and stat_ratio <= 1 and firm_err <= 1e-6
            and update_err <= 1e-6):
        raise SystemExit("the port's train step on the card disagrees with its plain CPU path")


def run_variant_modules_phase():
    """FPNEncoder(norm="IN") at the flagship's widths (IN_FPN: the conv
    kernel's fp32 SIMT variant) and a CostRegNet2D (torch's 3D convs) in
    train mode, fp32, on the card against the CPU: the outputs, and the
    gradients of every parameter and of the volume under a seeded random
    cotangent, each within 1e-3 of its tensor's largest entry + 1e-6 (the
    CPU's); the CostRegNet2D's running statistics at rtol 1e-4 / atol 2e-5."""
    from mvsformerplusplus_tpu_torch.config import init_weights
    from mvsformerplusplus_tpu_torch.models.cost_reg import CostRegNet2D
    from mvsformerplusplus_tpu_torch.models.layers import FPNEncoder

    rng = np.random.RandomState(3)
    cases = {"fpn_in": (lambda: FPNEncoder(IN_FPN["feat_chs"], norm="IN"),
                        rng.rand(IN_FPN["b"], IN_FPN["h"], IN_FPN["w"], 3), False),
             "cost_reg_2d": (lambda: CostRegNet2D(8), rng.randn(2, 8, 32, 40, 8), True)}
    row, ok = {"phase": "variants_reference_modules"}, True
    for name, (make, x, x_grad) in cases.items():
        runs = {}
        for device in ("cpu", "cuda"):
            model = make()
            init_weights(model, torch.Generator().manual_seed(4))
            model.to(device).train()
            xin = torch.from_numpy(x.astype(np.float32)).to(device).requires_grad_(x_grad)
            outs = model(xin)
            outs = list(outs) if isinstance(outs, tuple) else [outs]
            gen = torch.Generator().manual_seed(5)
            cots = [torch.randn(o.shape, generator=gen).to(device) for o in outs]
            sum((o * c).sum() for o, c in zip(outs, cots)).backward()
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            if x_grad:
                grads["input"] = xin.grad.cpu()
            runs[device] = ([o.detach().cpu() for o in outs], grads,
                            {k: v.cpu() for k, v in model.state_dict().items()
                             if k.endswith(("running_mean", "running_var"))})
        (co, cg, cs), (go, gg, gs) = runs["cpu"], runs["cuda"]
        out_ratio = max(((g - c).abs().max() / (1e-4 * c.abs().max() + 1e-6)).item()
                        for g, c in zip(go, co))
        grad_ratio = max(((gg[n] - g).abs().max() / (1e-3 * g.abs().max() + 1e-6)).item()
                         for n, g in cg.items())
        stat_ratio = max([((gs[k] - v).abs() / (2e-5 + 1e-4 * v.abs())).max().item()
                          for k, v in cs.items()], default=0.0)
        row[name] = {"out_err_over_tol": out_ratio, "grad_err_over_tol": grad_ratio,
                     "bn_stats_err_over_tol": stat_ratio, "grads": len(cg),
                     "outputs": [list(o.shape) for o in co]}
        ok = ok and out_ratio <= 1 and grad_ratio <= 1 and stat_ratio <= 1 and len(cg) > 10
    emit(row)
    if not ok:
        raise SystemExit("variants_reference_modules: the card disagrees with the CPU")


# each model family: its phases' prefix, config, layers timed by profile,
# and the kernels its forward and its train step launch (by counter, and by
# the name of the kernel in a trace); CasMVSNet launches no flash kernel
PHASE_PREFIX = {"flagship": "", "casmvs": "casmvs_", "variants": "variants_"}
FLASH = ("flash_attention_fwd", "flash_attention_bwd")
FLASH_NAMES = ("flash_fwd_mma_kernel", "flash_bwd_mma_kernel")


def family_spec(family):
    """The variant flagship is the flagship's config with VARIANT_OVERRIDES;
    its paths are not profiled, and its log_var maps are checked."""
    if family in ("flagship", "variants"):
        return dict(config=CONFIG, train=TRAIN, layers=LAYERS,
                    forward=("warp_bilinear", "flash_attention_fwd", "conv2d_same"),
                    forward_names=("flash_fwd_mma_kernel", "conv2d_mma_kernel",
                                   "warp_bilinear_vec_kernel"),
                    train_names=("flash_bwd_mma_kernel", "warp_bilinear_bwd_vec_kernel"),
                    absent=(), absent_names=(),
                    overrides=VARIANT_OVERRIDES if family == "variants" else None,
                    profile=family == "flagship")
    return dict(config=CASMVS_CONFIG, train=CAS_TRAIN, layers=CASMVS_LAYERS,
                forward=("warp_bilinear", "conv2d_same"),
                forward_names=("conv2d_mma_kernel", "warp_bilinear_vec_kernel"),
                train_names=("warp_bilinear_bwd_vec_kernel",), absent=FLASH,
                absent_names=FLASH_NAMES, overrides=None, profile=True)


def path_kernels_launched(launches, spec) -> bool:
    """Every kernel the path runs launched (none of the off-path ones, none
    of the family's absent ones: those are checked to be 0)."""
    return all(n > 0 for k, n in launches.items() if k not in OFF_PATH + spec["absent"])


def none_launched(launches, kernels) -> bool:
    """No kernel of `kernels` launched in a path's run: with F32_ONLY, every
    flash launch went through the tensor-core kernels; with CONV_SIMT, every
    conv and conv-dx launch; with WARP_SCALAR, every warp and warp-backward
    launch through the vector ones (that those did launch is checked by
    every_*kernel_launched)."""
    return not any(launches[k] for k in kernels)


def run_main_path(counters, family="flagship", iters=3):
    from mvsformerplusplus_tpu_torch.config import build_model, load_config

    spec = family_spec(family)
    # the device defaults to cuda and the dtype to bf16, as the eval CLI builds it
    model = build_model(load_config(spec["config"], spec["overrides"]))
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
            "every_forward_kernel_launched": all(launches[k] > 0 for k in spec["forward"]),
            "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
            "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
            "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
            "absent_kernels_not_launched": none_launched(launches, spec["absent"]),
        }
        if spec["overrides"]:  # the uncertainty head at the CostRegNet3D stages 3-4 only
            checks["log_var_finite_at_stages_3_4"] = all(
                list(out[f"stage{i}"]["log_var"].shape) == list(out[f"stage{i}"]["depth"].shape)
                and bool(torch.isfinite(out[f"stage{i}"]["log_var"]).all()) for i in (3, 4))
            checks["no_log_var_at_stages_1_2"] = all("log_var" not in out[f"stage{i}"]
                                                     for i in (1, 2))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del out
        t0 = time.perf_counter()
        ms = time_ms(lambda: model(imgs, cams, dv), iters=iters)
        wall_s = time.perf_counter() - t0
    row = {"phase": PHASE_PREFIX[family] + "main_path",
           "config": str(spec["config"].relative_to(REPO)),
           "shape": [1, 5, 1152, 1536, 3], "depths": 192, "dtype": "bfloat16",
           "launches": launches, "checks": checks, "ms_per_map": ms, "iters": iters,
           "timing_wall_s": wall_s, "peak_mem_gb": peak_gb,
           "depth_median": float(depth.median())}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"{row['phase']} checks failed: {checks}")
    if spec["profile"]:
        emit(profile_forward(model, (imgs, cams, dv), family))
    return launches


class SeededLoader:
    """The train protocol's batch (`dims`), made once on the card from a
    seed, with the JAX TrainLoader's interface: `epoch(e)` yields (batch,
    crop_hw). `mark(i)`, when given, is called on the host before step i is
    handed out (after step i - 1 was dispatched) and once more after the
    last."""

    def __init__(self, steps: int, mark=None, dims=TRAIN):
        from mvsformerplusplus_tpu_torch.train.trainer import to_device as batch_to

        self.batch = batch_to(make_train_batch(**dims), "cuda")
        self.hw = (dims["h"], dims["w"])
        self.steps, self.mark = steps, mark

    def steps_per_epoch(self) -> int:
        return self.steps

    def epoch(self, e):
        for i in range(self.steps):
            if self.mark is not None:
                self.mark(i)
            yield self.batch, self.hw
        if self.mark is not None:
            self.mark(self.steps)


def run_train_step(counters, family="flagship", iters=6):
    """The full-width train step through build_model(train=True) and the
    port's Trainer, in one epoch of 1 + `iters` steps: the first, counted
    and logged (its log read synchronises the host), then `iters` timed
    steps that log nothing, between CUDA events the loader records, with no
    host synchronisation inside the window."""
    from mvsformerplusplus_tpu_torch.config import build_model, load_config
    from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
    from mvsformerplusplus_tpu_torch.train.trainer import Trainer

    spec = family_spec(family)
    dims = spec["train"]
    cfg = load_config(spec["config"], spec["overrides"])
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

    loader = SeededLoader(steps=1 + iters, mark=mark, dims=dims)
    trainer = Trainer(model, loader, opt, sched, logging_every=1 + iters,
                      loss_kwargs=dict(clip_func=cfg["arch"]["loss"]["clip_func"],
                                       depth_types=tuple(cfg.get_path("arch.args.depth_type"))))
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
        "every_kernel_launched": path_kernels_launched(launches, spec),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
        "absent_kernels_not_launched": none_launched(launches, spec["absent"]),
    }
    if spec["overrides"]:
        heads = {f"cascade.stage{i}.cost_reg.{reg.final_name()}.weight" for i, reg in (
            (i, getattr(model.cascade, f"stage{i}").cost_reg) for i in (3, 4))}
        swiglu = {n for n in trainable if ".mlp.Dense_" in n}
        checks["uncertainty_terms_logged_finite"] = len(logs) == 1 and all(
            np.isfinite(logs[0].get(f"stage{i}_uncertainty", np.nan)) for i in (3, 4))
        checks["log_var_heads_two_channels_moved"] = all(
            model.get_parameter(n).shape[0] == 2 for n in heads) and heads <= moved
        checks["swiglu_in_vit_decoder_and_fmt_moved"] = (
            any(n.startswith("decoder_vit.") for n in swiglu)
            and any(n.startswith("fmt.") for n in swiglu) and swiglu <= moved)
    row = {"phase": PHASE_PREFIX[family] + "train_step",
           "config": str(spec["config"].relative_to(REPO)),
           "shape": [dims["b"], dims["v"], dims["h"], dims["w"], 3],
           "depths": dims["dfull"], "dtype": "bfloat16", "remat_granularity": "cost_reg",
           "launches_per_step": launches, "checks": checks, "ms_per_step": ms, "iters": iters,
           "first_step_ms": window[0].elapsed_time(window[1]), "peak_mem_gb": peak_gb,
           "params": {"trainable": len(trainable), "moved": len(moved),
                      "with_nonzero_grad_last_step": len(nonzero_grad),
                      "trainable_not_moved": sorted(trainable - moved)[:20],
                      "vit": sum(n.startswith("vit.") for n in params0)},
           "bn_stats": {"tensors": len(stats0), "moved": stats_moved},
           "logs": logs}
    emit(row)
    STEP_MS[family] = ms
    if not all(checks.values()):
        raise SystemExit(f"{row['phase']} checks failed: {checks}")
    if spec["profile"]:
        emit(profile_train(model, opt, sched, loader.batch, family))
    return launches


LAYERS = ("encoder", "vit", "decoder_vit", "decoder", "fmt", "cascade.stage1",
          "cascade.stage2", "cascade.stage3", "cascade.stage4")
CASMVS_LAYERS = ("encoder", "decoder", "cascade.stage1", "cascade.stage2", "cascade.stage3",
                 "cascade.stage4")
HAND_WRITTEN = ("warp_bilinear_vec_kernel", "warp_bilinear_bwd_vec_kernel",
                "warp_bilinear_scalar_kernel", "warp_bilinear_narrow_kernel",
                "warp_bilinear_bwd_scalar_kernel", "flash_fwd_mma_kernel",
                "flash_bwd_mma_kernel", "flash_fwd_3xtf32_kernel", "flash_fwd_f32_simt_kernel",
                "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel", "conv2d_mma_kernel",
                "conv2d_same_kernel")
# the hand-written kernels no model path may run: the f32 flash ones, the
# conv's SIMT one, the warps' scalar ones
OFF_PATH_KERNELS = ("flash_fwd_3xtf32_kernel", "flash_fwd_f32_simt_kernel",
                    "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel", "conv2d_same_kernel",
                    "warp_bilinear_scalar_kernel", "warp_bilinear_narrow_kernel",
                    "warp_bilinear_bwd_scalar_kernel")


def check_kernel_names(prof, phase, want, absent=()) -> None:
    """By name in the trace: the flash, conv and warp kernels that ran are
    the mma and vector ones named, and no off-path one (nor one `absent`
    from the model)."""
    ours = prof["hand_written_ms_per_call"]
    if not (all(ours[k] > 0 for k in want)
            and not any(ours[k] for k in OFF_PATH_KERNELS + tuple(absent))):
        raise SystemExit(f"{phase}: flash, conv or warp kernels in the trace are not the mma "
                         f"and vector ones: {ours}")


def layer_ms(model, inputs, layers=LAYERS) -> dict:
    """ms of each top-level layer's span on the device timeline over one
    forward (idle gaps inside a span included), from CUDA events recorded by
    forward hooks; `rest` is the forward's time outside those layers."""
    spans, hooks = {}, []
    for name in layers:
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
    out["rest"] = out["total"] - sum(out[n] for n in layers)
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


def profile_forward(model, inputs, family="flagship") -> dict:
    def forward():
        with torch.inference_mode():
            model(*inputs)

    spec, phase = family_spec(family), PHASE_PREFIX[family] + "profile"
    prof = profile_run(forward, iters=2)
    del prof["result"]
    check_kernel_names(prof, phase, spec["forward_names"], spec["absent_names"])
    return {"phase": phase, "layer_ms": layer_ms(model, inputs, spec["layers"]), **prof}


def profile_train(model, opt, sched, batch, family="flagship", iters=3) -> dict:
    """The traced window over `iters` more train steps; their last step's
    losses and gradient norm must be finite."""
    from mvsformerplusplus_tpu_torch.train.step import train_step

    prof = profile_run(lambda: train_step(model, opt, sched, batch), iters)
    logs = prof.pop("result")
    finite = all(bool(torch.isfinite(v).all()) for k, v in logs.items()
                 if k == "loss" or k == "grad_norm" or k.startswith("stage"))
    spec, phase = family_spec(family), PHASE_PREFIX[family] + "profile_train"
    if not finite:
        raise SystemExit(f"{phase}: a loss or the gradient norm is not finite")
    check_kernel_names(prof, phase, spec["forward_names"] + spec["train_names"],
                       spec["absent_names"])
    return {"phase": phase, **prof}


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


def cli_overrides(data: Path, scales, val_hw):
    """The -o overrides of a training CLI run on the scan at `data` (its
    train.txt for training and validation), its crops and validation size."""
    args = "data_loader;0;args;"
    out = []
    for expr in (f"{args}datapath={data}", f"{args}train_data_list={data / 'train.txt'}",
                 f"{args}val_data_list={data / 'train.txt'}",
                 f"{args}multi_scale_args;scales={json.dumps([list(hw) for hw in scales])}",
                 f"{args}height={val_hw[0]}", f"{args}width={val_hw[1]}"):
        out += ["-o", expr]
    return out


def read_scalars(save: Path):
    return [json.loads(ln) for ln in (save / "scalars.jsonl").read_text().splitlines()]


def panels(save: Path) -> dict:
    """{'train' and 'val': [(file name, decoded shape)]} of the run's
    depth panels, each PNG decoded with the port's reader."""
    from mvsformerplusplus_tpu_torch.data.io import read_png

    out = {"train": [], "val": []}
    for path in sorted((save / "images").glob("*.png")):
        out[path.name.split("_step")[0]].append((path.name, list(read_png(path).shape)))
    return out


def run_train_cli(counters, work: Path):
    """The training command line in process on the card
    (`python -m mvsformerplusplus_tpu_torch.train`'s main) with
    configs/mvsformerplusplus.json at full width, overriding only the data
    paths and lists, the batch size (2), the epochs (2), the crop scales
    (512 x 640 and 512 x 768) and the validation size (512 x 640), on one
    geometric DTU-format scan written by the port's own writers (5 views x
    7 lights at 576 x 800, its pair.txt cut to CLI["refs"] reference views),
    under `work` (casmvs_cli trains on it and
    blended_cli fine-tunes from its checkpoints). Then the same command
    with -r --epochs 3. Checks
    every logged loss and gradient norm and every validation metric finite,
    model_last.pth and model_best.pth written, model_last.pth restoring bit
    for bit into a fresh build_model(train=True), and the resumed run
    starting at epoch 2 with the step count continued and the learning rate
    of the uninterrupted 3-epoch schedule at that step; and the steps per
    crop bucket equal to the loader's schedule."""
    from mvsformerplusplus_tpu_torch.config import build_model, load_config
    from mvsformerplusplus_tpu_torch.data.io import read_pair_file, save_pair_file
    from mvsformerplusplus_tpu_torch.data.synthetic import make_geometric_dtu
    from mvsformerplusplus_tpu_torch.train import cli
    from mvsformerplusplus_tpu_torch.train.optim import warmup_cosine

    data, save = work / "dtu", work / "saved"
    t0 = time.perf_counter()
    make_geometric_dtu(data, n_views=5, n_lights=7, h=CLI["hw"][0], w=CLI["hw"][1], ndepth=192)
    pair = data / "Cameras" / "pair.txt"
    save_pair_file(pair, [(r, [(s_, 100.0) for s_ in srcs])
                          for r, srcs in read_pair_file(pair)[:CLI["refs"]]])
    write_s = time.perf_counter() - t0
    argv = (["-c", str(CONFIG), "--save_dir", str(save), "--batch_size", str(CLI["batch"]),
             "--epochs", "2"] + cli_overrides(data, CLI["scales"], CLI["val_hw"]))
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
    release()
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
    release()
    scalars = read_scalars(save)
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
        "scalars_per_logged_step_and_validation": [r["mode"] for r in scalars].count("train")
        == len(logged) and [r["mode"] for r in scalars].count("val") == len(val_stats),
        "every_kernel_launched": all(n > 0 for k, n in launches.items() if k not in OFF_PATH),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
    }
    row = {"phase": "train_cli", "config": str(CONFIG.relative_to(REPO)),
           "argv": argv[4:], "data": {"views": 5, "lights": 7, "refs": CLI["refs"], "hw": list(CLI["hw"]),
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


FUSE_ARGS = {"dpcd": ("ref_depth", "ref_conf", "src_depths", "ref_cam", "src_cams"),
             "pcd": ("ref_depth", "ref_conf", "src_depths", "src_confs", "ref_cam", "src_cams"),
             "gipuma": ("ref_depth", "ref_conf", "src_depths", "src_confs", "ref_cam",
                        "src_cams")}
GT_FUSE_REFS = (0, 1)


def _fuse_with_decisions(method, a):
    """(points, mask, per-view decisions [K, H, W]) of one fusion method on
    the tensors `a`: dpcd's strictest per-view consistency, pcd's per-view
    masks, gipuma's per-source support and the source pixel it takes (x
    and y, a floor), the decisions the kept points are averaged over."""
    from mvsformerplusplus_tpu_torch.fusion import fusion

    if method == "dpcd":
        pts, mask = fusion.dpcd_fuse(*(a[n] for n in FUSE_ARGS[method]))
        reproj = fusion.reproject_dynamic(a["ref_depth"], a["src_depths"], a["ref_cam"],
                                          a["src_cams"])
        return pts, mask, fusion.vis_filter_dynamic(a["ref_depth"], reproj)[1]
    if method == "pcd":
        pts, mask = fusion.pcd_fuse(*(a[n] for n in FUSE_ARGS[method]))
        reproj, in_range = fusion.reproject_static(a["ref_depth"], a["src_depths"],
                                                   a["ref_cam"], a["src_cams"])
        return pts, mask, fusion.vis_filter_static(a["ref_depth"], reproj, in_range, 1.0,
                                                   0.01, 4.0)[0]
    pts, mask, consistent, src_px = fusion.gipuma_fuse(*(a[n] for n in FUSE_ARGS[method]))
    return pts, mask, torch.cat([consistent.int(), src_px.permute(3, 0, 1, 2).flatten(0, 1)])


def gt_fusion_check(scan_dir: Path, out_dir: Path, gt_dir: Path) -> dict:
    """The scan's ground-truth depths (confidence 1) fused on the card and
    on the CPU (plain versions) with each method at its defaults, for the
    reference views GT_FUSE_REFS against their 4 sources (the CPU takes ~5
    s per view and method at this size). fp32 products in another order
    can flip a decision that sits on its threshold: the final mask or a
    per-view decision the kept point is averaged over (which moves the
    point by up to a view's share of the average). Reported: the share of
    pixels whose masks differ, the share whose mask or any per-view
    decision differs, the largest point distance over the kept cloud's
    extent where the masks agree and where every decision agrees, and the
    kept share. pair.txt from the scan, the cameras the eval CLI wrote."""
    from mvsformerplusplus_tpu_torch.data.io import (build_camera_stack, read_cam_file,
                                                     read_pair_file, read_pfm)

    pair = dict(read_pair_file(scan_dir / "pair.txt"))
    depth = {v: read_pfm(gt_dir / f"depth_map_{v:0>4}.pfm")[0] for v in pair}
    cam = {v: build_camera_stack(*read_cam_file(out_dir / "cams" / f"{v:0>8}_cam.txt")[:2])
           for v in pair}
    out = {}
    for method in FUSE_ARGS:
        flips = decision_flips = pixels = kept = 0
        dist_mask = dist_all = 0.0
        pts_cpu = []
        for ref in GT_FUSE_REFS:
            srcs = pair[ref]
            arrays = {"ref_depth": depth[ref], "ref_conf": np.ones_like(depth[ref]),
                      "src_depths": np.stack([depth[s] for s in srcs]),
                      "src_confs": np.ones((len(srcs),) + depth[ref].shape, np.float32),
                      "ref_cam": cam[ref], "src_cams": np.stack([cam[s] for s in srcs])}
            res = {}
            for device in ("cuda", "cpu"):
                r = _fuse_with_decisions(method, {k: torch.from_numpy(v).to(device)
                                                  for k, v in arrays.items()})
                res[device] = [t.cpu().numpy() for t in r]
            (p_gpu, m_gpu, d_gpu), (p_cpu, m_cpu, d_cpu) = res["cuda"], res["cpu"]
            same = m_gpu == m_cpu
            agree = same & (d_gpu == d_cpu).all(axis=0)
            flips += int((~same).sum())
            decision_flips += int((~agree).sum())
            pixels += m_cpu.size
            kept += int(m_cpu.sum())
            diff = np.abs(p_gpu - p_cpu).max(axis=-1)
            both = m_gpu & m_cpu
            dist_mask = max(dist_mask, float(diff[both].max()) if both.any() else 0.0)
            dist_all = max(dist_all, float(diff[both & agree].max()) if (both & agree).any()
                           else 0.0)
            pts_cpu.append(p_cpu[m_cpu])
        pts = np.concatenate(pts_cpu)
        extent = float(np.ptp(pts, axis=0).max()) if len(pts) else 0.0
        out[method] = {"refs": list(GT_FUSE_REFS), "mask_flip_share": flips / pixels,
                       "decision_flip_share": decision_flips / pixels,
                       "kept_share": kept / pixels, "points_cpu": len(pts), "extent": extent,
                       "max_point_dist_over_extent_masks_agree":
                           dist_mask / extent if extent else None,
                       "max_point_dist_over_extent": dist_all / extent if extent else None}
    return out


def run_eval_cli(counters, work: Path):
    """The eval command line in process on the card
    (`python -m mvsformerplusplus_tpu_torch.eval`'s main) with
    configs/mvsformerplusplus.json at full width, seeded weights, on a
    5-view geometric scan at 1152 x 1536 written by the port's own writers
    under `work` (JPEG at quality 97, GT depth PFMs; casmvs_cli reads it
    too): 5 depth maps at 192 depths with
    dpcd fusion and depth_metric.txt, then --skip_depth with pcd and with
    gipuma on the same outputs. Checks every output file, every depth finite
    and inside the cascade's hypothesis range (testing.inverse_depth_bounds),
    the confidence uint8, the GT-depth fusion on the card against the CPU
    (gt_fusion_check: both clouds non-empty, the mask or a per-view
    decision differing on at most 1e-4 of the pixels, points within 1e-4 of
    the cloud's extent where every decision agrees), every forward
    kernel launched and every warp launch a vector one. Records ms per map
    end to end (data, forward, writes), the forward's device ms per map, the
    decode and encode ms per image (inside the run, and alone on the main
    thread), the loader-wait share, fusion seconds per scan and points per
    cloud for each method, and peak memory."""
    from mvsformerplusplus_tpu_torch.data.io import read_image_u8
    from mvsformerplusplus_tpu_torch.data.jpeg import write_jpeg
    from mvsformerplusplus_tpu_torch.data.synthetic import make_geometric_eval_scan
    from mvsformerplusplus_tpu_torch.eval import cli

    phase_t0 = time.perf_counter()
    cfg = json.loads(CONFIG.read_text())["arch"]["args"]
    h, w = EVAL_CLI["hw"]
    root, out = work / "eval", work / "eval_out"
    t0 = time.perf_counter()
    make_geometric_eval_scan(root, "scan1", n_views=EVAL_CLI["views"], h=h, w=w,
                             ndepth=EVAL_CLI["depths"])
    write_s = time.perf_counter() - t0
    (root / "list.txt").write_text("scan1\n")
    image = root / "scan1" / "images" / "00000000.jpg"
    t0 = time.perf_counter()
    pixels = read_image_u8(image)
    decode_alone_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    write_jpeg(work / "alone.jpg", pixels)
    encode_alone_ms = (time.perf_counter() - t0) * 1e3
    base = ["--config", str(CONFIG), "--testpath", str(root), "--testlist",
            str(root / "list.txt"), "--outdir", str(out), "--num_view", str(EVAL_CLI["views"]),
            "--numdepth", str(EVAL_CLI["depths"]), "--max_h", str(h), "--max_w", str(w)]
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    runs = {"dpcd": cli.main(base + ["--filter_method", "dpcd", "--gt_depth_path",
                                     str(root / "gt_depths")])}
    clouds = {"dpcd": (out / "scan1.ply").exists()}
    for method in ("pcd", "gipuma"):
        (out / "scan1.ply").unlink(missing_ok=True)
        runs[method] = cli.main(base + ["--skip_depth", "--filter_method", method])
        clouds[method] = (out / "scan1.ply").exists()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    host = read_host_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    depth_run = runs["dpcd"]
    written = eval_outputs(out, cfg, EVAL_CLI["views"], EVAL_CLI["hw"], EVAL_CLI["depths"])
    files = written["output_files"] and (out / "depth_metric.txt").exists()
    conf_u8 = files and all(
        (c.dtype, c.shape) == (np.uint8, (h, w))
        for c in (np.load(out / "scan1" / "confidence" / f"{v:0>8}.npy")
                  for v in range(EVAL_CLI["views"])))
    gt = (gt_fusion_check(root / "scan1", out / "scan1", root / "gt_depths" / "scan1")
          if files else {})
    maps = depth_run["maps"]
    fwd = depth_run["forward_ms"]
    steady = np.diff(depth_run["map_done_s"]) * 1e3
    checks = {
        **written,
        "output_files": files,
        "ply_per_method": all(clouds.values()),
        "confidence_uint8": conf_u8,
        "maps_and_forwards": maps == EVAL_CLI["views"] and len(fwd) == maps,
        "gt_clouds_non_empty": bool(gt) and all(r["points_cpu"] > 0 for r in gt.values()),
        "gt_masks_card_vs_cpu": bool(gt) and all(r["decision_flip_share"] <= 1e-4
                                                 for r in gt.values()),
        "gt_points_card_vs_cpu": bool(gt) and all(
            r["max_point_dist_over_extent"] is not None
            and r["max_point_dist_over_extent"] <= 1e-4 for r in gt.values()),
        "every_forward_kernel_launched": all(
            launches[k] > 0 for k in ("warp_bilinear", "flash_attention_fwd", "conv2d_same")),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
        **host_checks(host, sum(r["decodes"] + r["fusion_decodes"] for r in runs.values())),
    }
    ms_per_map = depth_run["depth_s"] / maps * 1e3
    row = {"phase": "eval_cli", "config": str(CONFIG.relative_to(REPO)),
           "scan": {"views": EVAL_CLI["views"], "hw": [h, w], "depths": EVAL_CLI["depths"],
                    "write_s": write_s},
           "ms_per_map": ms_per_map, "ms_between_maps": steady.tolist(),
           "forward_ms": fwd, "forward_ms_per_map": float(np.mean(fwd)) if fwd else None,
           "decode_ms_per_image": depth_run["decode_s"] / max(depth_run["decodes"], 1) * 1e3,
           "decodes": depth_run["decodes"], "decode_share_of_ms_per_map":
               depth_run["decode_s"] / depth_run["depth_s"],
           "encode_ms_per_image": depth_run["encode_s"] / maps * 1e3,
           "decode_ms_alone": decode_alone_ms, "encode_ms_alone": encode_alone_ms,
           "loader_wait_share": depth_run["loader_wait_s"] / depth_run["depth_s"],
           "fusion_s_per_scan": {m: r["fusion_s"]["scan1"] for m, r in runs.items()},
           "points_per_cloud": {m: r["points"]["scan1"] for m, r in runs.items()},
           "fusion_decodes": {m: r["fusion_decodes"] for m, r in runs.items()},
           "gt_fusion": gt, "peak_mem_gb": peak_gb, "launches": launches, "host_calls": host,
           "checks": checks, "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"eval_cli checks failed: {checks}")
    return launches, row


def eval_outputs(out: Path, cfg: dict, views: int, hw, depths: int) -> dict:
    """The eval CLI's per-view outputs under out/scan1: every file written,
    every depth map finite, of shape `hw` and inside the cascade's
    hypothesis range (testing.inverse_depth_bounds of its cam's range)."""
    from mvsformerplusplus_tpu_torch.data.io import read_pfm
    from mvsformerplusplus_tpu_torch.testing import inverse_depth_bounds

    files, finite, in_range = True, True, True
    for v in range(views):
        ref = f"{v:0>8}"
        paths = [out / "scan1" / sub / name for sub, name in (
            ("depth_est", f"{ref}.pfm"), ("confidence", f"{ref}.npy"),
            ("cams", f"{ref}_cam.txt"), ("images", f"{ref}.jpg"))]
        files &= all(p.exists() for p in paths)
        if not files:
            break
        depth = read_pfm(paths[0])[0]
        dmin, dint = map(float, paths[2].read_text().split()[-2:])
        lo, hi = inverse_depth_bounds(dmin, dmin + (depths - 1) * dint, cfg["ndepths"],
                                      cfg["depth_interals_ratio"])
        finite &= bool(np.isfinite(depth).all()) and depth.shape == tuple(hw)
        in_range &= bool(((depth >= lo * (1 - 1e-5)) & (depth <= hi * (1 + 1e-5))).all())
    return {"output_files": files, "depth_finite": files and finite,
            "depth_in_hypothesis_range": files and in_range}


def run_casmvs_cli(counters, work: Path):
    """CasMVSNet through both command lines in process on the card: the
    training CLI with configs/casmvs.json at full width on train_cli's scan
    and crops, at batch 4 (one micro-batch a step), one epoch validating on
    the scan's 14 samples at 512 x 640; then the eval CLI with --ckpt of
    that run on eval_cli's 5-view 1152 x 1536 scan (5 maps, dpcd fusion).
    Checks the checkpoints, scalars.jsonl (a train record per logged step,
    a val record per validation), a train panel and a val panel decoded,
    finite losses and metrics, the steps per crop bucket and the
    validation maps as scheduled, the eval outputs (eval_outputs) and the
    cloud, every CasMVSNet kernel launched through the mma and vector
    kernels and no flash kernel. Records ms per step per crop bucket,
    validation ms per map, the eval CLI's ms per map and its forward's, and
    peak memory."""
    from mvsformerplusplus_tpu_torch.eval import cli as eval_cli
    from mvsformerplusplus_tpu_torch.train import cli as train_cli

    phase_t0 = time.perf_counter()
    spec = family_spec("casmvs")
    cfg = json.loads(CASMVS_CONFIG.read_text())["arch"]["args"]
    save, out, scan = work / "casmvs_saved", work / "casmvs_eval_out", work / "eval"
    argv = (["-c", str(CASMVS_CONFIG), "--save_dir", str(save), "--batch_size",
             str(CAS_CLI["batch"]), "--epochs", str(CAS_CLI["epochs"])]
            + cli_overrides(work / "dtu", CLI["scales"], CLI["val_hw"]))
    h, w = EVAL_CLI["hw"]
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_cli.main(argv)
    train_s = time.perf_counter() - t0
    logged, epoch_stats, val_stats = trainer.logged, trainer.epoch_stats, trainer.val_stats
    is_casmvs = type(trainer.model).__name__ == "CasMVSNet"
    del trainer
    release()
    t0 = time.perf_counter()
    stats = eval_cli.main(["--config", str(CASMVS_CONFIG), "--testpath", str(scan), "--testlist",
                           str(scan / "list.txt"), "--outdir", str(out), "--num_view",
                           str(EVAL_CLI["views"]), "--numdepth", str(EVAL_CLI["depths"]),
                           "--max_h", str(h), "--max_w", str(w), "--ckpt",
                           str(save / "checkpoints"), "--filter_method", "dpcd"])
    eval_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts(counters)
    host = read_host_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    release()
    scalars, images = read_scalars(save), panels(save)
    buckets = _bucket_totals(epoch_stats)
    steps = schedule_steps(CLI["samples"], CLI["scales"], CAS_CLI["batch"], CAS_CLI["epochs"])
    modes = [r["mode"] for r in scalars]
    checks = {
        "model_is_casmvs": is_casmvs,
        "checkpoint_files": all((save / "checkpoints" / n).exists()
                                for n in ("model_last.pth", "model_best.pth", "meta.json")),
        "losses_and_grad_norms_finite": bool(logged) and all(
            np.isfinite(v) for e in logged for k, v in e.items()
            if k in ("loss", "grad_norm") or k.startswith("stage")),
        "val_metrics_finite": len(val_stats) == CAS_CLI["epochs"] and all(
            np.isfinite(v) for s_ in val_stats for v in s_["metrics"].values()),
        "scalars_train_and_val": modes.count("train") == len(logged)
        and modes.count("val") == len(val_stats),
        "train_and_val_panels": bool(images["train"]) and bool(images["val"]),
        "steps_per_bucket_as_scheduled": {hw: b["steps"] for hw, b in buckets.items()}
        == {f"{a}x{b}": n for (a, b), n in steps.items() if n},
        "val_maps_as_counted": sum(s_["maps"] for s_ in val_stats)
        == CLI["samples"] * CAS_CLI["epochs"],
        **eval_outputs(out, cfg, EVAL_CLI["views"], EVAL_CLI["hw"], EVAL_CLI["depths"]),
        "eval_maps": stats["maps"] == EVAL_CLI["views"],
        "ply": (out / "scan1.ply").exists(),
        "every_kernel_launched": path_kernels_launched(launches, spec),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
        "no_flash_kernel": none_launched(launches, FLASH),
        **host_checks(host, stats["decodes"] + stats["fusion_decodes"], png=True),
    }
    row = {"phase": "casmvs_cli", "config": str(CASMVS_CONFIG.relative_to(REPO)),
           "argv": argv[4:], "buckets": buckets, "epochs": epoch_stats,
           "val_ms_per_map": [s_["ms_per_map"] for s_ in val_stats],
           "val_metrics": [s_["metrics"] for s_ in val_stats],
           "scalars": {m: modes.count(m) for m in sorted(set(modes))}, "panels": images,
           "eval_ms_per_map": stats["depth_s"] / max(stats["maps"], 1) * 1e3,
           "eval_forward_ms_per_map": float(np.mean(stats["forward_ms"]))
           if stats["forward_ms"] else None,
           "eval_decode_ms_per_image": stats["decode_s"] / max(stats["decodes"], 1) * 1e3,
           "fusion_s": stats["fusion_s"], "points": stats["points"], "peak_mem_gb": peak_gb,
           "run_s": {"train": train_s, "eval": eval_s}, "launches": launches,
           "host_calls": host, "checks": checks,
           "logged": logged, "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"casmvs_cli checks failed: {checks}")
    return launches


def run_blended_cli(counters, work: Path):
    """The BlendedMVS fine-tune in process on the card: a BlendedMVS-layout
    scan of BLENDED["views"] views at 1536 x 2048 (data/synthetic.make_blended_scan,
    JPEG through the port's encoder), then the training CLI with
    configs/mvsformerplusplus_ft.json at full width, --finetune
    --dtu_model_path train_cli's checkpoints (the config's reset_sche: a
    fresh optimizer and schedule), --debug, one epoch of 512 x 640 crops at
    batch 4, validating the views whole at 1536 x 2048. Checks the
    Blended datasets and the "blended" interval scale, finite losses and
    validation metrics, scalars.jsonl's train, val and debug records, each
    module's gradient norm finite (the frozen ViT's 0) and every non-finite
    count 0, the panels, the steps and validation maps as scheduled, each
    view decoded once per dataset, every flagship kernel launched through
    the mma and vector kernels. Records ms per step, validation ms per map,
    decode ms per image, peak memory."""
    from mvsformerplusplus_tpu_torch.data.mvs_dataset import BlendedTrainDataset
    from mvsformerplusplus_tpu_torch.data.synthetic import make_blended_scan
    from mvsformerplusplus_tpu_torch.train import cli

    phase_t0 = time.perf_counter()
    data, save = work / "blended", work / "blended_saved"
    h, w = BLENDED["hw"]
    t0 = time.perf_counter()
    make_blended_scan(data, "blended1", n_views=BLENDED["views"], h=h, w=w, ndepth=192)
    write_s = time.perf_counter() - t0
    argv = (["-c", str(FT_CONFIG), "--save_dir", str(save), "--finetune", "--dtu_model_path",
             str(work / "saved" / "checkpoints"), "--debug", "--batch_size",
             str(BLENDED["batch"]), "--epochs", str(BLENDED["epochs"])]
            + cli_overrides(data, BLENDED["scales"], BLENDED["hw"]))
    zero_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    run_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts(counters)
    host = read_host_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    datasets = {"train": trainer.train_loader.dataset, "val": trainer.val_loader.dataset}
    decodes = {k: (d.views.decodes, d.views.decode_s) for k, d in datasets.items()}
    blended = all(isinstance(d, BlendedTrainDataset) for d in datasets.values())
    logged, epoch_stats, val_stats = trainer.logged, trainer.epoch_stats, trainer.val_stats
    interval_norm = trainer.interval_norm
    del trainer, datasets
    release()
    scalars, images = read_scalars(save), panels(save)
    modes = [r["mode"] for r in scalars]
    debug = [r for r in scalars if r["mode"] == "debug"]
    buckets = _bucket_totals(epoch_stats)
    steps = schedule_steps(BLENDED["views"], BLENDED["scales"], BLENDED["batch"],
                           BLENDED["epochs"])
    trained = ("encoder", "decoder", "decoder_vit", "fmt", "cascade")
    checks = {
        "blended_datasets": blended,
        "interval_norm_blended": interval_norm == "blended",
        "losses_and_grad_norms_finite": bool(logged) and all(
            np.isfinite(v) for e in logged for k, v in e.items()
            if k in ("loss", "grad_norm") or k.startswith("stage")),
        "val_metrics_finite": len(val_stats) == BLENDED["epochs"] and all(
            np.isfinite(v) for s_ in val_stats for v in s_["metrics"].values()),
        "scalars_train_val_debug": modes.count("train") == modes.count("debug") == len(logged)
        and modes.count("val") == len(val_stats),
        "gnorm_finite": bool(debug) and all(
            np.isfinite(r[m]) and r[m] > 0 for r in debug for m in trained)
        and all(r["vit"] == 0 for r in debug),
        "nonfinite_zero": all(v == 0 for e in logged for k, v in e.items()
                              if k.startswith("nonfinite/"))
        and all(any(k.startswith("nonfinite/") for k in e) for e in logged),
        "train_and_val_panels": bool(images["train"]) and bool(images["val"]),
        "steps_as_scheduled": {hw: b["steps"] for hw, b in buckets.items()}
        == {f"{a}x{b}": n for (a, b), n in steps.items() if n},
        "val_maps_as_counted": sum(s_["maps"] for s_ in val_stats)
        == BLENDED["views"] * BLENDED["epochs"],
        "each_view_decoded_once_per_dataset": all(n == BLENDED["views"]
                                                  for n, _ in decodes.values()),
        "every_kernel_launched": path_kernels_launched(launches, family_spec("flagship")),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
        **host_checks(host, sum(n for n, _ in decodes.values())),
    }
    n_dec = sum(n for n, _ in decodes.values())
    row = {"phase": "blended_cli", "config": str(FT_CONFIG.relative_to(REPO)),
           "argv": argv[4:], "data": {"views": BLENDED["views"], "hw": [h, w], "write_s": write_s},
           "buckets": buckets, "epochs": epoch_stats,
           "val_ms_per_map": [s_["ms_per_map"] for s_ in val_stats],
           "val_metrics": [s_["metrics"] for s_ in val_stats],
           "decodes": {k: n for k, (n, _) in decodes.items()},
           "decode_ms_per_image": sum(t for _, t in decodes.values()) / max(n_dec, 1) * 1e3,
           "scalars": {m: modes.count(m) for m in sorted(set(modes))}, "debug": debug,
           "panels": images, "peak_mem_gb": peak_gb, "run_s": run_s, "launches": launches,
           "host_calls": host, "checks": checks, "logged": logged,
           "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"blended_cli checks failed: {checks}")
    return launches


# ------------------------------------------------------------- across ranks

# the optimizer of the dist_step comparison: AdamW's first step at lr 1e-3
# moves every trained entry (the reference phases' settings)
DIST_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, freeze_vit=True)
# dist_step's one-rank steps: the reference, then its sensitivity probes (the
# same batch twice more, the images a bf16 ulp up and down)
DIST_PROBES = (("ref", 0), ("rerun", 0), ("rerun2", 0), ("ulp_up", 1), ("ulp_down", -1))


def child_counts(counters, children) -> dict:
    """Kernel launches reported by spawned processes (ops.cuda.launch_counts
    of each), summed under this script's counter names."""
    return {name: sum(c[f"{fn.__name__}.{attr}"] for c in children)
            for name, (fn, attr) in counters.items()}


def _add(a, b):
    return {k: a[k] + b[k] for k in a}


def bf16_ulp(x, step):
    """x rounded to bf16 and moved `step` bf16 ulps (its bit pattern +
    step)."""
    b = x.to(torch.bfloat16).contiguous()
    return (b.view(torch.int16) + step).view(torch.bfloat16).float()


def step_result(model, logs):
    return dict(logs={k: float(v) for k, v in logs.items()
                      if k in ("loss", "grad_norm") or k.startswith("stage")},
                grads={n: p.grad.float().cpu() for n, p in model.named_parameters()
                       if p.grad is not None},
                state={k: v.cpu() for k, v in model.state_dict().items()})


def _rel_l2(a, b, keys) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys)
    return (num / max(sum(float((b[k].double() ** 2).sum()) for k in keys), 1e-30)) ** 0.5


def compare_steps(ref, probes, got, before) -> dict:
    """One layout's step (`got`, each rank's) against the one-rank step
    `ref` on the same global batch. The full-width bf16 step is chaotic
    under rounding: the card's atomics reorder sums from run to run, and a
    CE stage hands its argmax depth on, so a change in the last bit moves
    later stages' hypotheses at near-tied pixels (random weights give many).
    The reference_train phase's rule (a tolerance, or twice the step's
    measured sensitivity where larger) is therefore applied with the
    sensitivity measured by `probes`, one-rank steps run again on the same
    batch and on images a bf16 ulp up and down, each statistic's tolerance
    twice the largest probe's distance from `ref`: the per-stage losses
    (or 1e-4 relative where larger); all the gradients together (their
    relative L2 distance, or 1e-3); all the running statistics together
    (relative L2, or 1e-4); the parameters after AdamW where |g| is above
    its tensor's tolerance (1e-3 of its largest entry + 1e-5 of the largest
    gradient, or twice the probes' largest distance) within 1e-6, and
    everywhere AdamW's first step on the rank's own gradient (1e-6); every
    rank the same state. Each tensor's own distance over its tolerance is
    reported (worst_grads), not held to 1: with hundreds of tensors some
    fall past twice a few samples of the noise by chance."""
    grads = list(ref["grads"])
    stats = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    loss_ratio = 0.0
    for k, v in ref["logs"].items():
        if k == "grad_norm":
            continue
        tol = max(1e-4 * abs(v), 2 * max(abs(p["logs"][k] - v) for p in probes))
        loss_ratio = max(loss_ratio, max(abs(r["logs"][k] - v) for r in got) / tol)
    grad_tol = max(1e-3, 2 * max(_rel_l2(p["grads"], ref["grads"], grads) for p in probes))
    stat_tol = max(1e-4, 2 * max(_rel_l2(p["state"], ref["state"], stats) for p in probes))
    tol, rows = {}, []
    for n, g in ref["grads"].items():
        tol[n] = max(1e-3 * g.abs().max().item() + 1e-5 * gmax,
                     2 * max((p["grads"][n] - g).abs().max().item() for p in probes))
        rows.append((max((r["grads"][n] - g).abs().max().item() for r in got) / tol[n], n))
    rows.sort()
    firm_err, update_err = 0.0, 0.0
    lr, eps = DIST_OPT["lr"], 1e-8
    for n, g in ref["grads"].items():
        firm = g.abs() > tol[n]
        for r in got:
            if firm.any():
                firm_err = max(firm_err, (r["state"][n] - ref["state"][n])[firm].abs().max().item())
            gg = r["grads"][n]
            step = r["state"][n] - before[n]
            update_err = max(update_err, (step + lr * gg / (gg.abs() + eps)).abs().max().item())
    same = all(torch.equal(r["state"][k], v) for r in got[1:] for k, v in got[0]["state"].items())
    return {"loss_err_over_tol": loss_ratio,
            "grads_rel_l2": max(_rel_l2(r["grads"], ref["grads"], grads) for r in got),
            "grads_rel_l2_tol": grad_tol,
            "bn_stats_rel_l2": max(_rel_l2(r["state"], ref["state"], stats) for r in got),
            "bn_stats_rel_l2_tol": stat_tol, "worst_grads": rows[-3:],
            "params_firm_max_abs_err": firm_err, "params_update_max_abs_err": update_err,
            "ranks_hold_the_same_state": same,
            "same_params_with_grad": all(set(r["grads"]) == set(ref["grads"]) for r in got)}


def dist_ways_rank(ctx, ways, batch, opt_kwargs, loss_kwargs, timed):
    """One rank of dist_step: testing.train_step_rank for each (make_model,
    mesh) of `ways` in turn (one process start for several layouts), then
    this process's kernel launches."""
    from mvsformerplusplus_tpu_torch.ops.cuda import launch_counts
    from mvsformerplusplus_tpu_torch.testing import train_step_rank

    return [train_step_rank(ctx, make, batch, mesh, None, opt_kwargs, loss_kwargs, timed)
            for make, mesh in ways] + [launch_counts()]


def run_dist_step(counters):
    """The flagship's train step (configs/mvsformerplusplus.json, bf16, the
    train_step phase's global batch: B=2, 5 views, 512 x 640, 192 depths) on
    one rank in this process, and its sensitivity probes (DIST_PROBES); then,
    from the same seeded weights and optimizer, through
    parallel.dist.launch (testing.train_step_rank) four ways, each compared
    with the one-rank step (compare_steps): two gloo ranks on the card at
    --mesh 2,1 (one sample each), two gloo ranks at --mesh 1,2 (shard_views:
    two source views each), two gloo ranks at --mesh 1,2 with shard_depth
    (half the hypotheses of every stage each: the entropy's softmax over D
    across the ranks and the volume's slices gathered through gloo's host
    path before the regularizers), and the NCCL path at world 1. Each way runs
    DIST["timed"] more steps for its ms per step and peak memory per rank;
    the children report their kernel launches."""
    import functools

    from mvsformerplusplus_tpu_torch.config import build_model, load_config
    from mvsformerplusplus_tpu_torch.parallel.dist import backend_for, launch
    from mvsformerplusplus_tpu_torch.train.optim import make_optimizer
    from mvsformerplusplus_tpu_torch.train.step import train_step
    from mvsformerplusplus_tpu_torch.train.trainer import to_device as batch_to

    phase_t0 = time.perf_counter()
    cfg = load_config(CONFIG)
    loss_kwargs = dict(clip_func=cfg["arch"]["loss"]["clip_func"])
    batch = make_train_batch(**TRAIN)
    zero_counts(counters)
    model = build_model(cfg, dtype=torch.bfloat16, train=True)
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    one = {}
    for run, ulps in DIST_PROBES:
        model.load_state_dict(before)
        b = batch_to(batch, "cuda")
        if ulps:
            b["imgs"] = bf16_ulp(b["imgs"], ulps)
        opt, sched = make_optimizer(model, **DIST_OPT)
        one[run] = step_result(model, train_step(model, opt, sched, b, **loss_kwargs))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    del model, opt, sched, b
    release()
    rows, children = {}, []

    def make(mesh, split):
        return functools.partial(build_model, cfg, torch.bfloat16, "cpu", 0, True,
                                 **({f"shard_{split}": True} if split else {}))

    for ways, ranks in (((("gloo_2x1", (2, 1), None), ("gloo_1x2", (1, 2), "views"),
                          ("gloo_1x2_depth", (1, 2), "depth")), 2),
                        ((("nccl_1x1", (1, 1), None),), 1)):
        backend = backend_for("cuda", ranks)  # two ranks on the one card: gloo
        t0 = time.perf_counter()
        got = launch(dist_ways_rank, ranks,
                     ([(make(mesh, split), mesh) for _, mesh, split in ways], batch, DIST_OPT,
                      loss_kwargs, DIST["timed"]), device="cuda")
        children += [r[-1] for r in got]
        for i, (way, mesh, split) in enumerate(ways):
            way_ranks = [r[i] for r in got]
            rows[way] = {"ranks": ranks, "mesh": list(mesh), "split": split, "backend": backend,
                         "ms_per_step": [r["ms_per_step"] for r in way_ranks],
                         "peak_mem_gb": [r["peak_mem_gb"] for r in way_ranks],
                         "logs": way_ranks[0]["logs"], "launch_s": time.perf_counter() - t0,
                         **compare_steps(one["ref"], [one[r] for r, _ in DIST_PROBES[1:]],
                                         way_ranks, before)}
        del got
    launches = _add(launches, child_counts(counters, children))
    checks = {f"{way}_{k}": ok for way, r in rows.items() for k, ok in (
        ("losses", r["loss_err_over_tol"] <= 1),
        ("grads", r["grads_rel_l2"] <= r["grads_rel_l2_tol"]),
        ("bn_stats", r["bn_stats_rel_l2"] <= r["bn_stats_rel_l2_tol"]),
        ("params_firm", r["params_firm_max_abs_err"] <= 1e-6),
        ("params_update", r["params_update_max_abs_err"] <= 1e-6),
        ("ranks_same_state", r["ranks_hold_the_same_state"]),
        ("same_params_with_grad", r["same_params_with_grad"]))}
    checks.update({
        "every_kernel_launched": path_kernels_launched(launches, family_spec("flagship")),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR)})
    row = {"phase": "dist_step", "config": str(CONFIG.relative_to(REPO)),
           "global_shape": [TRAIN["b"], TRAIN["v"], TRAIN["h"], TRAIN["w"], 3],
           "depths": TRAIN["dfull"], "dtype": "bfloat16", "timed_steps": DIST["timed"],
           "one_rank_logs": {r: one[r]["logs"] for r, _ in DIST_PROBES},
           "probes_grads_rel_l2": {r: _rel_l2(one[r]["grads"], one["ref"]["grads"],
                                              list(one["ref"]["grads"]))
                                   for r, _ in DIST_PROBES[1:]},
           "ways": rows, "launches": launches,
           "checks": checks, "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"dist_step checks failed: {checks}")
    return launches


def run_train_cli_mesh(counters, work: Path):
    """The training command line with --mesh 2,1 (two gloo ranks sharing
    the card; the batch of 4 is the process's, 2 samples per rank) on
    train_cli's scan and crops: one epoch with validation (the 14 samples
    split 7 + 7 over the data ranks), then -r to a second. Checks one set
    of checkpoints, scalars.jsonl written once (a record per logged step
    and validation, not one per rank), the resumed run at epoch 1 with the
    step count continued, both ranks' losses, validation metrics and final
    weights (a SHA-1 of the state) equal, everything finite, the steps per
    crop bucket as scheduled. The ranks report their kernel launches."""
    from mvsformerplusplus_tpu_torch.train import cli

    phase_t0 = time.perf_counter()
    data, save = work / "dtu", work / "saved_mesh"
    argv = (["-c", str(CONFIG), "--save_dir", str(save), "--batch_size", str(CLI_MESH["batch"]),
             "--epochs", "1", "--mesh", "2,1"] + cli_overrides(data, CLI["scales"], CLI["val_hw"]))
    runs, run_s = [], []
    for extra in ([], ["-r", "--epochs", str(CLI_MESH["epochs"])]):
        t0 = time.perf_counter()
        runs.append(cli.main(argv + extra))
        run_s.append(time.perf_counter() - t0)
    launches = child_counts(counters, [r["launches"] for ranks in runs for r in ranks])
    ck = save / "checkpoints"
    scalars = read_scalars(save)
    logged = [r["logged"] for r in runs[0]], [r["logged"] for r in runs[1]]
    vals = [[v["metrics"] for v in r["val_stats"]] for ranks in runs for r in ranks]
    buckets = _bucket_totals([e for ranks in runs for e in ranks[0]["epoch_stats"]])
    steps = schedule_steps(CLI["samples"], CLI["scales"], CLI_MESH["batch"], CLI_MESH["epochs"])
    spe = sum(steps.values()) // CLI_MESH["epochs"]
    resumed = runs[1][0]
    checks = {
        "two_ranks_each_run": [len(r) for r in runs] == [2, 2],
        "checkpoint_files": all((ck / n).exists() for n in (
            "model_last.pth", "model_best.pth", "meta.json", "checkpoint-epoch0.pth",
            "checkpoint-epoch1.pth")),
        "one_scalar_log": [r["mode"] for r in scalars].count("train")
        == len(logged[0][0]) + len(logged[1][0])
        and [r["mode"] for r in scalars].count("val") == CLI_MESH["epochs"],
        "ranks_log_the_same_losses": all(a == b for a, b in logged),
        "ranks_same_validation": vals[0] == vals[1] and vals[2] == vals[3],
        "val_maps_split_over_ranks": [sum(v["maps"] for v in r["val_stats"])
                                      for ranks in runs for r in ranks] == [7, 7, 7, 7],
        "resumed_step_count_continued": resumed["logged"][0]["step"] == spe + 1
        and all(r["global_step"] == CLI_MESH["epochs"] * spe for r in runs[1]),
        "ranks_same_final_weights": all(r["state_sha1"] == runs[i][0]["state_sha1"]
                                        for i, ranks in enumerate(runs) for r in ranks),
        "losses_finite": all(np.isfinite(v) for e in logged[0][0] + logged[1][0]
                             for k, v in e.items()
                             if k in ("loss", "grad_norm") or k.startswith("stage")),
        "val_metrics_finite": all(np.isfinite(x) for v in vals for m in v for x in m.values()),
        "steps_per_bucket_as_scheduled": {hw: b["steps"] for hw, b in buckets.items()}
        == {f"{h}x{w}": n for (h, w), n in steps.items() if n},
        "every_kernel_launched": all(n > 0 for k, n in launches.items() if k not in OFF_PATH),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
    }
    row = {"phase": "train_cli_mesh", "config": str(CONFIG.relative_to(REPO)),
           "argv": argv[4:], "mesh": [2, 1], "steps_per_epoch": spe, "buckets": buckets,
           "epochs_by_rank": [[r["epoch_stats"] for r in ranks] for ranks in runs],
           "val_ms_per_map_by_rank": [[v["ms_per_map"] for v in r["val_stats"]]
                                      for ranks in runs for r in ranks],
           "run_s": run_s, "launches": launches, "checks": checks,
           "logged": logged[0][0] + logged[1][0], "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"train_cli_mesh checks failed: {checks}")
    return launches


def eval_worker(argv):
    """One eval command line process (spawned): its stats, pid, kernel
    launches and host library calls."""
    import os

    from mvsformerplusplus_tpu_torch.eval import cli
    from mvsformerplusplus_tpu_torch.ops.cuda import launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_counts({})
    t0 = time.perf_counter()
    stats = cli.main(argv)
    return {"stats": stats, "pid": os.getpid(), "wall_s": time.perf_counter() - t0,
            "launches": launch_counts(), "host": read_host_counts()}


def run_eval_queue(counters, work: Path):
    """eval_cli's scan copied into EVAL_QUEUE["scans"] scans; their depth
    maps by two eval command line processes with --schedule queue sharing
    the card (each cuda:0), then by one process over the same list (no
    fusion in either). Checks every scan claimed once (one g0 claim file,
    no stolen generation) and done, the workers' maps adding up, and every
    depth map of the queue's run equal to the one process's (bitwise on all
    but at most 1e-4 of the pixels, those within 1e-3). Records maps/s at 2
    and at 1 worker, by the wall clock from starting the processes to their
    end (process start and model build included) and by the workers' own
    depth time, as a reading."""
    import multiprocessing
    import shutil

    from mvsformerplusplus_tpu_torch.data.io import read_pfm

    phase_t0 = time.perf_counter()
    h, w = EVAL_CLI["hw"]
    root = work / "eval"
    names = [f"scan{i + 1}" for i in range(EVAL_QUEUE["scans"])]
    for name in names[1:]:
        for d in (root, root / "gt_depths"):
            if not (d / name).exists():
                shutil.copytree(d / "scan1", d / name)
    (root / "list_queue.txt").write_text("".join(f"{n}\n" for n in names))
    base = ["--config", str(CONFIG), "--testpath", str(root), "--testlist",
            str(root / "list_queue.txt"), "--num_view", str(EVAL_CLI["views"]),
            "--numdepth", str(EVAL_CLI["depths"]), "--max_h", str(h), "--max_w", str(w),
            "--filter_method", "none"]
    ctx = multiprocessing.get_context("spawn")
    runs = {}
    for way, workers, extra in (("queue", EVAL_QUEUE["workers"], ["--schedule", "queue"]),
                                ("one", 1, [])):
        out = work / f"eval_{way}"
        t0 = time.perf_counter()
        with ctx.Pool(workers) as pool:
            res = pool.map(eval_worker, [base + ["--outdir", str(out)] + extra] * workers)
        runs[way] = {"out": out, "workers": res, "wall_s": time.perf_counter() - t0}
    workers = [r for run in runs.values() for r in run["workers"]]
    launches = child_counts(counters, [r["launches"] for r in workers])
    host = read_host_counts([r["host"] for r in workers])
    claims = work / "eval_queue" / ".claims"
    claim_files = sorted(p.name for p in claims.iterdir())
    pids = {f"pid{r['pid']}": r["stats"]["maps"] for r in runs["queue"]["workers"]}
    owners = [(claims / f"{n}.claim.g0").read_text() for n in names]
    differ, bitwise = 0.0, True
    for name in names:
        for v in range(EVAL_CLI["views"]):
            a, b = (read_pfm(runs[way]["out"] / name / "depth_est" / f"{v:0>8}.pfm")[0]
                    for way in ("queue", "one"))
            bitwise &= bool(np.array_equal(a, b))
            far = np.abs(a - b) > 1e-3 * np.abs(b)
            differ = max(differ, float(far.mean()))
    maps = EVAL_QUEUE["scans"] * EVAL_CLI["views"]
    readings = {way: {"workers": len(run["workers"]), "maps": maps,
                      "maps_per_s_wall": maps / run["wall_s"],
                      "maps_per_s_depth": maps / max(r["stats"]["depth_s"]
                                                     for r in run["workers"]),
                      "wall_s": run["wall_s"],
                      "depth_s": [r["stats"]["depth_s"] for r in run["workers"]],
                      "maps_by_worker": [r["stats"]["maps"] for r in run["workers"]],
                      "forward_ms_per_map": float(np.mean([x for r in run["workers"]
                                                           for x in r["stats"]["forward_ms"]]))}
                for way, run in runs.items()}
    checks = {
        "claims_once_and_done": claim_files == sorted(f"{n}.{x}" for n in names
                                                      for x in ("claim.g0", "done")),
        "each_scan_one_worker": all(o in pids for o in owners)
        and all(pids[p] == EVAL_CLI["views"] * owners.count(p) for p in pids),
        "maps_add_up": sum(pids.values()) == maps and runs["one"]["workers"][0]["stats"]["maps"]
        == maps,
        "depths_equal_one_process": differ <= 1e-4,
        "every_forward_kernel_launched": all(
            launches[k] > 0 for k in ("warp_bilinear", "flash_attention_fwd", "conv2d_same")),
        "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
        "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
        "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
        **host_checks(host, sum(r["stats"]["decodes"] + r["stats"]["fusion_decodes"]
                                for r in workers)),
    }
    row = {"phase": "eval_queue", "config": str(CONFIG.relative_to(REPO)),
           "scans": EVAL_QUEUE["scans"], "views": EVAL_CLI["views"], "hw": [h, w],
           "readings": readings, "depths_bitwise_equal": bitwise,
           "depth_pixels_differing_share": differ, "launches": launches, "host_calls": host,
           "decode_ms_per_image": sum(r["stats"]["decode_s"] for r in workers) * 1e3
           / max(sum(r["stats"]["decodes"] for r in workers), 1), "checks": checks,
           "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"eval_queue checks failed: {checks}")
    return launches


def render_e2e_data(root: str) -> None:
    """The e2e_protocol phase's data, rendered in a process of its own while
    the card runs the earlier phases (it needs no card): the analytic scene
    with its 4096-texel textures, the train set and the eval scan at
    1152 x 1536 (tools/e2e_protocol.py build_data, which records the
    resolution in render.json); the seconds it took in render_s.txt."""
    sys.path.insert(0, str(REPO))
    from mvsformerplusplus_tpu_torch.tools.e2e_protocol import build_data

    t0 = time.perf_counter()
    build_data(Path(root))
    (Path(root) / "render_s.txt").write_text(str(time.perf_counter() - t0))


def start_render(target, root: Path, threads: int):
    """target(root) in a spawned process with `threads` BLAS threads (the
    environment variables only for the child): render_e2e_data with two,
    render_scene_data with one."""
    import multiprocessing
    import os

    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: str(threads) for k in saved})
    try:
        proc = multiprocessing.get_context("spawn").Process(target=target, args=(str(root),),
                                                            daemon=True)
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return proc


def render_scene_data(root: str) -> None:
    """The scene_convert phase's scenes (SCENE_CONVERT), rendered and written
    in a process of its own while the card runs the earlier phases: the NeRF
    scene and the COLMAP project of the analytic scene (its 1024-texel
    textures) under root, each view's true depth (min, median, max) and
    the seconds it took in scenes.json. At the lowest CPU priority: the
    paths timed meanwhile keep the host's cores."""
    import os

    os.nice(19)
    sys.path.insert(0, str(REPO))
    from mvsformerplusplus_tpu_torch.data import synthetic

    sc = SCENE_CONVERT
    root = Path(root)
    t0 = time.perf_counter()
    scene = synthetic.GeometricScene(0)
    _, nerf = synthetic.make_nerf_scene(root / "nerf_scene", sc["nerf_frames"], *sc["nerf_hw"],
                                        rgba=sc["nerf_rgba"], scene=scene)
    formats = [sc["colmap_formats"].get(v, "png") for v in range(sc["colmap_views"])]
    _, colmap = synthetic.make_colmap_scene(root / "colmap_scene", sc["colmap_views"],
                                            *sc["colmap_hw"], n_points=sc["colmap_points"],
                                            formats=formats, scene=scene)

    def stats(depths):
        return [[float(d[d > 0].min()), float(np.median(d[d > 0])), float(d[d > 0].max())]
                for d in depths]

    (root / "scenes.json").write_text(json.dumps(
        {"nerf": stats(nerf), "colmap": stats(colmap), "seconds": time.perf_counter() - t0}))


def tb_events(save: Path) -> dict:
    """The TensorBoard mirror under save/tb against what the run logged:
    every TFRecord's length and data CRC (utils/tfevents.masked_crc32c) and
    the event count, one file_version event, one per scalar of every
    scalars.jsonl record and one per panel of every PNG under images/ (its
    panels side by side, each of the crop's 5:4 aspect)."""
    import struct

    from mvsformerplusplus_tpu_torch.utils.tfevents import masked_crc32c

    files = sorted((save / "tb").glob("events.out.tfevents.*"))
    events, crc_ok = 0, True
    for f in files:
        data, i = f.read_bytes(), 0
        while i < len(data):
            (n,) = struct.unpack("<Q", data[i:i + 8])
            crc_ok &= struct.unpack("<I", data[i + 8:i + 12])[0] == masked_crc32c(data[i:i + 8])
            crc_ok &= (struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0]
                       == masked_crc32c(data[i + 12:i + 12 + n]))
            i += 16 + n
            events += 1
    scalars = sum(len(r) - 3 for r in read_scalars(save))
    panels = 0
    for png in (save / "images").glob("*.png"):
        w, h = struct.unpack(">II", png.read_bytes()[16:24])
        panels += w * 4 // (h * 5)
    return {"files": len(files), "events": events, "crc_ok": bool(crc_ok),
            "expected": 1 + scalars + panels, "scalars": scalars, "panels": panels}


def run_e2e_protocol(counters, root: Path, renderer) -> dict:
    """The port's end-to-end accuracy protocol (tools/e2e_protocol.py) on the
    card at the DTU eval protocol, through its run_model, which runs the
    training and eval command lines in process: CasMVSNet (CASMVS_ARCH) for
    E2E["casmvs_epochs"] epochs, then the flagship (FLAGSHIP_ARCH, its ViT
    of heads of 24 trained from scratch) for one, each a path of its own
    ("e2e_casmvs", "e2e_flagship"), with trainer.tensorboard on. The data
    is the renderer process's (render_e2e_data); the metrics read the
    scene's quads, which its texture size does not change. Prints every
    filter's depth and cloud metrics beside the JAX package's artifact
    (docs/e2e_protocol_metrics.json, a TPU run of 8 epochs). Checks:
    CasMVSNet's pcd run within tests/test_e2e_protocol.py's gates (abs
    depth error < 40 mm, thres20mm < 0.40, thres8mm < 0.55, more than 10 000
    points, accuracy mean < 6 and median < 4 mm, completeness median < 6
    mm); for both, the depth maps and a cloud per filter, every metric
    finite, the TB mirror's records and count, every kernel of the model's
    paths launched, through the mma and vector kernels (and no flash kernel
    for CasMVSNet)."""
    from mvsformerplusplus_tpu_torch.data.synthetic import GeometricScene
    from mvsformerplusplus_tpu_torch.tools import e2e_protocol as e2e

    t0 = time.perf_counter()
    renderer.join(timeout=1200)
    if renderer.is_alive() or renderer.exitcode != 0:
        raise SystemExit(f"e2e_protocol: the renderer process failed ({renderer.exitcode})")
    wait_s = time.perf_counter() - t0
    stamp = (root / "render.json").stat().st_mtime_ns
    scene = GeometricScene(0, tex_res=16)
    _, tr, ev = e2e.build_data(root, scene)
    reused = (root / "render.json").stat().st_mtime_ns == stamp
    jax_art = json.loads((REPO / "docs" / "e2e_protocol_metrics.json").read_text())
    gates = dict(abs_depth_error=40.0, thres20mm_error=0.40, thres8mm_error=0.55,
                 accuracy_mean_mm=6.0, accuracy_median_mm=4.0, completeness_median_mm=6.0)
    by_path, failed = {}, {}
    for name, path, epochs in (("casmvs", "e2e_casmvs", E2E["casmvs_epochs"]),
                               ("flagship", "e2e_flagship", E2E["flagship_epochs"])):
        spec = family_spec(name)
        zero_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = e2e.run_model(name, e2e.ARCHS[name], root, scene, tr, ev, epochs, device="cuda",
                            tensorboard=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts(counters)
        host = read_host_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        release()
        mroot = root / name
        tb = tb_events(mroot / "saved")
        filters = [f for f, _ in e2e.FILTERS]
        depth_keys = ("abs_depth_error", "thres20mm_error", "thres8mm_error", "mean_error")
        checks = {
            "render_reused": reused,
            "depth_maps": len(list((mroot / "out" / "scan1" / "depth_est").glob("*.pfm")))
            == E2E["views"],
            "cloud_per_filter": all("n_points" in res[f] for f in filters),
            "metrics_finite": all(np.isfinite(res[f][k]) for f in filters for k in depth_keys)
            and all(np.isfinite(v) for f in filters for k, v in res[f].items()
                    if k.endswith("_mm")),
            "tb_records": tb["crc_ok"] and tb["files"] == 1 and tb["events"] == tb["expected"],
            "every_kernel_launched": path_kernels_launched(launches, spec),
            "flash_through_mma_kernels": none_launched(launches, F32_ONLY),
            "conv_through_mma_kernel": none_launched(launches, CONV_SIMT),
            "warp_through_vec_kernels": none_launched(launches, WARP_SCALAR),
            **host_checks(host, sum(res[f]["image_decodes"] for f in filters), png=True),
        }
        if name == "casmvs":
            pcd = res["pcd"]
            checks["no_flash_kernel"] = none_launched(launches, FLASH)
            checks["pcd_points"] = pcd["n_points"] > 10_000
            checks.update({f"pcd_{k}_under_{v}": pcd.get(k, float("inf")) < v
                           for k, v in gates.items()})
        row = {"phase": "e2e_protocol", "model": name, "path": path, "epochs": epochs,
               "protocol": {"hw": list(E2E["hw"]), "depths": 192, "views": E2E["views"],
                            "crops": [list(c) for c in E2E["crops"]],
                            "samples": E2E["samples"]},
               "results": res, "jax_artifact": jax_art.get(name),
               "render_s_in_its_process": float((root / "render_s.txt").read_text()),
               "render_wait_s": wait_s, "run_s": run_s, "peak_mem_gb": peak_gb,
               "tb": tb, "launches": launches, "host_calls": host, "checks": checks}
        emit(row)
        for f in filters:
            print(f"e2e_protocol {name} {f} {json.dumps(res[f])}", flush=True)
        by_path[path] = launches
        if not all(checks.values()):
            failed[name] = {k: v for k, v in checks.items() if not v}
    if failed:
        raise SystemExit(f"e2e_protocol checks failed: {failed}")
    return by_path


def reference_vit_state_dict(gen, dim=768, depth=12, grid=37, mlp=3072):
    """Seeded DINOv2 weights under the original checkpoint's key names and
    layouts (ViT-B/14 by default): the state dict a .pth holds."""
    def randn(*shape, std=0.02):
        return torch.randn(shape, generator=gen) * std

    sd = {"patch_embed.proj.weight": randn(dim, 3, 14, 14), "patch_embed.proj.bias": randn(dim),
          "cls_token": randn(1, 1, dim), "pos_embed": randn(1, grid * grid + 1, dim),
          "norm.weight": 1 + randn(dim), "norm.bias": randn(dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[f"{p}{norm}.weight"], sd[f"{p}{norm}.bias"] = 1 + randn(dim), randn(dim)
        for name, (o, n) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                             ("mlp.fc1", (mlp, dim)), ("mlp.fc2", (dim, mlp))):
            sd[f"{p}{name}.weight"], sd[f"{p}{name}.bias"] = randn(o, n), randn(o)
        sd[f"{p}ls1.gamma"], sd[f"{p}ls2.gamma"] = 1 + randn(dim), 1 + randn(dim)
    return sd


def run_vit_pth_phase(work: Path) -> None:
    """arch.args.vit_path as the original DINOv2 .pth at full ViT-B width
    (768 channels, 12 blocks, heads of 64): a .pth this phase writes from
    seeded weights under the reference key names, and the converted .npz of
    the same weights (convert.vit_state_dict_to_flax), loaded into the
    flagship of configs/mvsformerplusplus.json on the card through the eval
    CLI's weight loader and the training CLI's; every ViT tensor bit-equal
    across the three loads, each load's count the converter's, and the
    .pth's weights the model's (one tensor checked in its layout)."""
    import argparse

    from mvsformerplusplus_tpu_torch.config import build_model, load_config
    from mvsformerplusplus_tpu_torch.convert import vit_state_dict_to_flax
    from mvsformerplusplus_tpu_torch.eval import cli as eval_cli
    from mvsformerplusplus_tpu_torch.train import cli as train_cli

    t0 = time.perf_counter()
    sd = reference_vit_state_dict(torch.Generator().manual_seed(21))
    torch.save(sd, work / "dinov2_vitb14.pth")
    flat = vit_state_dict_to_flax(sd, 12)
    np.savez(work / "dinov2_vitb14.npz", **flat)
    cfg = load_config(CONFIG)

    def vit_state(model):
        return {k: v.detach().cpu() for k, v in model.state_dict().items()
                if k.startswith("vit.")}

    loads, moved, train_count = {}, {}, None
    for name, path in (("eval_cli_pth", "dinov2_vitb14.pth"),
                       ("eval_cli_npz", "dinov2_vitb14.npz"),
                       ("train_cli_pth", "dinov2_vitb14.pth")):
        model = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=1)
        before = {k: v.clone() for k, v in vit_state(model).items()}
        if name.startswith("eval"):
            c = load_config(CONFIG)
            c.set_path("arch.args.vit_path", str(work / path))
            eval_cli._load_weights(model, c, argparse.Namespace(ckpt_npz=None, ckpt=None))
        else:
            train_count = train_cli.load_pretrained_vit(model, work / path)
        loads[name] = vit_state(model)
        moved[name] = sum(not torch.equal(before[k], v) for k, v in loads[name].items())
        del model
        release()
    ref = loads["eval_cli_pth"]
    qkv = ref["vit.blocks_0.attn.qkv.weight"]
    checks = {
        "bit_equal_pth_npz_train": all(
            ref.keys() == other.keys() and all(torch.equal(ref[k], other[k]) for k in ref)
            for other in (loads["eval_cli_npz"], loads["train_cli_pth"])),
        "every_vit_tensor_loaded": train_count == len(flat) and len(set(moved.values())) == 1
        and moved["eval_cli_pth"] > 0,
        "qkv_is_the_checkpoints": torch.equal(qkv, sd["blocks.0.attn.qkv.weight"].to(qkv.dtype)),
    }
    row = {"phase": "vit_pth", "tensors": len(flat), "vit_tensors_moved": moved,
           "pth_mb": (work / "dinov2_vitb14.pth").stat().st_size / 1e6,
           "phase_s": time.perf_counter() - t0, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"vit_pth checks failed: {checks}")


def blocky_image(seed, h, w):
    """Piecewise-constant 14-px cells of random colour (uint8 [h, w, 3])."""
    cells = np.random.RandomState(seed).randint(0, 255, (h // 14, w // 14, 3), np.uint8)
    return np.kron(cells, np.ones((14, 14, 1), np.uint8))


def dino_shift(match_fn, h, w, shift):
    """(pts_a, pts_b, the least of the shares of the matches at the shift in
    x and at 0 in y, within half a patch) of match_fn on a blocky h x w
    image against itself shifted `shift` px right."""
    img = blocky_image(1, h, w)
    pa, pb = match_fn(img, np.roll(img, shift, axis=1))
    if not len(pa):
        return pa, pb, 0.0
    dx, dy = pb[:, 0] - pa[:, 0] - shift, pb[:, 1] - pa[:, 1]
    return pa, pb, float(min(np.mean(np.abs(dx) < 7.5), np.mean(np.abs(dy) < 7.5)))


def same_matches(got, want):
    return len(got[0]) == len(want[0]) and all(
        np.abs(g - c).max() <= 0.05 for g, c in zip(got[:2], want[:2]))


def run_dino_match(counters, work: Path) -> dict:
    """The DINOv2 matcher (tools/dino_match.py) at full ViT-B width on the
    card: a seeded fp32 ViT-B (config.init_weights), a blocky image against
    itself shifted DINO_MATCH["shift"] px right. First, outside the counted
    run, the JAX tool's test at its size (long_side its image's longest
    side) and gates: 20 matches or more, 70% of them at the shift in x and
    at 0 in y. Then the counted run at the tool's default working size
    (long_side 644), under utils/profiler.trace: 70% of its matches at the
    shift (a random ViT's tokens are alike, so the ratio gate keeps few of
    them there; the count is printed). Checks both runs' points against
    the same matcher on the CPU (the same matches within 0.05 px), every
    launch of the counted run the f32 flash kernel's (the fp32 ViT; by
    counter and by name in the trace) and the profiler's device memory
    stats."""
    from mvsformerplusplus_tpu_torch.config import init_weights
    from mvsformerplusplus_tpu_torch.models.dino import DinoVisionTransformer
    from mvsformerplusplus_tpu_torch.tools.dino_match import make_dino_matcher
    from mvsformerplusplus_tpu_torch.utils import profiler

    vit = DinoVisionTransformer()
    with torch.no_grad():
        init_weights(vit, torch.Generator().manual_seed(3))
    shift = DINO_MATCH["shift"]
    th, tw = DINO_MATCH["test_hw"]
    test_cpu = dino_shift(make_dino_matcher(model=vit.eval(), device="cpu", long_side=tw),
                          th, tw, shift)
    h, w = DINO_MATCH["hw"]
    cpu = dino_shift(make_dino_matcher(model=vit.eval(), device="cpu"), h, w, shift)
    vit.cuda()
    test_card = dino_shift(make_dino_matcher(model=vit, device="cuda", long_side=tw),
                           th, tw, shift)
    card = make_dino_matcher(model=vit, device="cuda")
    dino_shift(card, h, w, shift)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    zero_counts(counters)
    trace_dir = work / "dino_match_trace"
    t0 = time.perf_counter()
    with profiler.trace(trace_dir):
        with profiler.annotate("dino_match"):
            got = dino_shift(card, h, w, shift)
    match_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(counters)
    mem = profiler.device_memory_stats()
    traces = list(trace_dir.glob("*.pt.trace.json"))
    names = {e.get("name", "") for t in traces
             for e in json.loads(t.read_text()).get("traceEvents", [])}
    checks = {
        "test_size_matches": len(test_card[0]) >= 20,
        "test_size_shift_recovered": test_card[2] > 0.7,
        "test_size_card_matches_cpu": same_matches(test_card, test_cpu),
        "shift_recovered": got[2] > 0.7,
        "card_matches_cpu": same_matches(got, cpu),
        "only_the_f32_flash_kernel": launches["flash_attention_fwd_f32"]
        == 2 * DINO_MATCH["blocks"] and not any(
            n for k, n in launches.items() if k != "flash_attention_fwd_f32"),
        "trace_names_the_kernel": len(traces) == 1 and any(
            "flash_fwd_3xtf32_kernel" in n for n in names) and "dino_match" in names,
        "memory_stats": 0 < mem["bytes_in_use"] <= mem["peak_bytes_in_use"]
        <= mem["bytes_limit"],
    }
    row = {"phase": "dino_match", "hw": [h, w], "patches": [h // 14, w // 14],
           "matches": len(got[0]), "shift_share": got[2], "test_hw": [th, tw],
           "test_matches": len(test_card[0]), "test_shift_share": test_card[2],
           "match_ms_traced": match_ms, "memory": mem, "launches": launches, "checks": checks}
    emit(row)
    del vit, card
    release()
    if not all(checks.values()):
        raise SystemExit(f"dino_match checks failed: {checks}")
    return launches


def _depth_rows(scan: Path, truth) -> list:
    """Per view of a converted scan: its cam file's [depth_min, depth_max]
    beside the true depth's min, median and max (`truth`)."""
    from mvsformerplusplus_tpu_torch.data.io import read_cam_file

    out = []
    for i, true in enumerate(truth):
        _, _, dmin, _, extra = read_cam_file(scan / "cams" / f"{i:0>8}_cam.txt")
        out.append([dmin, extra["depth_max"], *true])
    return out


def _holds_medians(rows) -> bool:
    return all(dmin <= med <= dmax for dmin, dmax, _, med, _ in rows)


def run_scene_convert(counters, work: Path, scene_root: Path, scene_renderer) -> dict:
    """The port's scene converters at sizes users convert (SCENE_CONVERT),
    each through its command line's main, as a user runs them: the NeRF
    scene with ORB on the host (nerf2mvsnet), again with --matcher dino
    --vit_path (the vit_pth phase's seeded ViT-B .pth) on the card, the
    COLMAP model with --convert_format (colmap2mvsnet), then the eval
    command line --dataset custom with seeded weights on 2 reference views
    of the converted scan. Before the counted run: the ORB of the
    committed fixtures (tests/data/make_orb_fixtures.py: cv2's keypoints and
    descriptors of two images) against the native ORB, and ORB ms per image
    and Hamming kNN ms per pair on the NeRF frames. Checks: the fixtures
    equal; no kernel launched by the ORB and COLMAP conversions; the dino
    conversion's launches the f32 flash kernel's alone, 2 x 12 per match
    call; every view's converted depth range of the ORB and COLMAP scans
    holding its median true depth; the dino scan's files (its ranges are
    not checked: random weights match at random); the eval's 2 maps and its
    PLY (its points counted: random weights rarely agree across views); no
    plain version of the host library called in the counted run.
    The scenes were rendered and written by `scene_renderer` under
    scene_root (render_scene_data) while the earlier phases ran."""
    from mvsformerplusplus_tpu_torch.data import io as dio
    from mvsformerplusplus_tpu_torch.data import native, orb
    from mvsformerplusplus_tpu_torch.eval import cli as eval_cli
    from mvsformerplusplus_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
    from mvsformerplusplus_tpu_torch.tools import colmap2mvsnet, dino_match, nerf2mvsnet

    phase_t0 = time.perf_counter()
    sc = SCENE_CONVERT
    scene_renderer.join()
    wait_s = time.perf_counter() - phase_t0
    if scene_renderer.exitcode != 0:
        raise SystemExit(f"the scene_convert renderer failed (exit {scene_renderer.exitcode})")
    nerf, colmap = scene_root / "nerf_scene", scene_root / "colmap_scene"
    truth = json.loads((scene_root / "scenes.json").read_text())

    checks = {}
    for name in ("photo_1152x1536_progressive_q75.jpg", "orb_texture_301x419.png"):
        feats = orb.detect_and_compute(native.rgb_to_gray(dio.imread_rgb(FIXTURES / name)),
                                       4000)
        checks[f"orb_fixture_{name}"] = (
            np.array_equal(feats.rows(), np.load(FIXTURES / f"{name}.orb.npy"))
            and np.array_equal(feats.descriptors, np.load(FIXTURES / f"{name}.orb_desc.npy")))
    grays = [native.rgb_to_gray(dio.imread_rgb(nerf / "train" / f"r_{i}.png")) for i in (0, 1)]
    fa, orb_ms = _best_ms(lambda: orb.detect_and_compute(grays[0], 4000), 3)
    fb = orb.detect_and_compute(grays[1], 4000)
    _, knn_ms = _best_ms(lambda: orb.knn_match2(fa.descriptors, fb.descriptors), 3)

    real_make = dino_match.make_dino_matcher
    calls = [0]

    def counted_matcher(*args, **kw):
        fn = real_make(*args, **kw)

        def match_fn(a, b):
            calls[0] += 1
            return fn(a, b)
        return match_fn

    vit_pth = work / "dinov2_vitb14.pth"
    ev_root, ev_out = work / "scene_eval", work / "scene_eval_out"
    (ev_root / "scan1").mkdir(parents=True)
    zero_counts(counters)
    seconds, steps = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        steps[name] = read_counts(counters)
        return result

    step("nerf_orb", lambda: nerf2mvsnet.main(["--scene_dir", str(nerf), "--out_dir",
                                               str(work / "nerf_orb")]))
    dino_match.make_dino_matcher = counted_matcher
    try:
        step("nerf_dino", lambda: nerf2mvsnet.main(
            ["--scene_dir", str(nerf), "--out_dir", str(work / "nerf_dino"), "--matcher", "dino",
             "--vit_path", str(vit_pth)]))
    finally:
        dino_match.make_dino_matcher = real_make
    step("colmap", lambda: colmap2mvsnet.main(["--dense_folder", str(colmap),
                                               "--convert_format"]))
    # 2 references, each the other's first source, over the converted scan
    pairs = dio.read_pair_file(colmap / "pair.txt")
    a = 0
    b = pairs[0][1][0]
    refs = [(a, [b] + [s for s in pairs[a][1] if s != b]),
            (b, [a] + [s for s in pairs[b][1] if s != a])]
    for sub in ("images", "cams"):
        (ev_root / "scan1" / sub).symlink_to(colmap / sub)
    with open(ev_root / "scan1" / "pair.txt", "w") as f:
        f.write(f"{len(refs)}\n")
        for ref, srcs in refs:
            f.write(f"{ref}\n{len(srcs)} " + " ".join(f"{s} 1.0" for s in srcs) + "\n")
    (ev_root / "list.txt").write_text("scan1\n")
    stats = step("eval_cli", lambda: eval_cli.main(
        ["--config", str(CONFIG), "--dataset", "custom", "--testpath", str(ev_root),
         "--testlist", str(ev_root / "list.txt"), "--outdir", str(ev_out), "--num_view", "5",
         "--numdepth", "192", "--max_h", "1152", "--max_w", "1536", "--filter_method",
         "gipuma", "--fusion_view", "1", "--num_consistent", "1"]))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    host = read_host_counts()
    SCENE_DINO_RUNS["scene_convert"] = 2 * DINO_MATCH["blocks"] * calls[0]

    vit = dino_match._vit_from(vit_pth, None, torch.device("cuda"))
    img0, img1 = (dio.imread_rgb(nerf / "train" / f"r_{i}.png") for i in (0, 1))
    match = dino_match.make_dino_matcher(model=vit, device="cuda")
    _, match_ms = _best_ms(lambda: match(img0, img1), 3)
    n = (sc["dino_hw"][0] // 14) * (sc["dino_hw"][1] // 14) + 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, n, 12, 64, generator=gen, device="cuda") for _ in range(3))
    flash_ms = device_ms(lambda: flash_attention_fwd(q, k, v, 64 ** -0.5))
    del vit, match, q, k, v

    zero = {k: 0 for k in launches}
    orb_rows = _depth_rows(work / "nerf_orb", truth["nerf"])
    colmap_rows = _depth_rows(colmap, truth["colmap"])
    dino_launches = {k: steps["nerf_dino"][k] - steps["nerf_orb"][k] for k in launches}
    ply = ev_out / "scan1.ply"
    checks.update({
        "orb_conversion_launches_nothing": steps["nerf_orb"] == zero,
        "colmap_conversion_launches_nothing": steps["colmap"] == steps["nerf_dino"],
        "dino_calls": calls[0] > 0,
        "dino_f32_flash_alone": dino_launches["flash_attention_fwd_f32"]
        == 2 * DINO_MATCH["blocks"] * calls[0]
        and not any(n for k, n in dino_launches.items() if k != "flash_attention_fwd_f32"),
        "orb_ranges_hold_medians": _holds_medians(orb_rows),
        "colmap_ranges_hold_medians": _holds_medians(colmap_rows),
        "dino_scan_files": all((work / "nerf_dino" / "cams" / f"{i:0>8}_cam.txt").exists()
                               and (work / "nerf_dino" / "images" / f"{i:0>8}.jpg").exists()
                               for i in range(sc["nerf_frames"]))
        and len(dio.read_pair_file(work / "nerf_dino" / "pair.txt")) == sc["nerf_frames"],
        "colmap_scan_files": all((colmap / "images" / f"{i:0>8}.jpg").exists()
                                 for i in range(sc["colmap_views"])),
        "eval_maps": stats["maps"] == sc["eval_refs"],
        "eval_depths_finite": all(np.isfinite(dio.read_pfm(
            ev_out / "scan1" / "depth_est" / f"{r:0>8}.pfm")[0]).all() for r, _ in refs),
        "eval_ply": ply.exists() and ply.read_bytes().startswith(b"ply"),
        "eval_every_forward_kernel": all(launches[k] > steps["colmap"][k] for k in (
            "warp_bilinear", "flash_attention_fwd", "conv2d_same")),
        "plain_versions_unused": not any(host["plain"].values()),
    })
    row = {"phase": "scene_convert", "config": {k: (list(v) if isinstance(v, tuple) else v)
                                                for k, v in sc.items()},
           "render_write_s": truth["seconds"], "renderer_wait_s": wait_s,
           "converter_s": seconds,
           "orb_ms_per_image": orb_ms, "orb_keypoints": len(fa),
           "hamming_knn_ms_per_pair": knn_ms, "dino_match_calls": calls[0],
           "dino_ms_per_pair": match_ms, "flash_f32_ms": flash_ms,
           "eval_ms_per_map": stats["depth_s"] / max(stats["maps"], 1) * 1e3,
           "eval_points": stats["points"].get("scan1", 0),
           "depth_ranges": {"nerf_orb": orb_rows, "colmap": colmap_rows,
                            "nerf_dino": _depth_rows(work / "nerf_dino", truth["nerf"])},
           "depth_range_columns": ["depth_min", "depth_max", "true_min", "true_median",
                                   "true_max"],
           "launches": launches, "host_calls": host, "checks": checks,
           "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"scene_convert checks failed: {checks}")
    return launches


# the host_codec phase: the host library (data/native.py) against the numpy
# codec at the eval scans' 1152 x 1536, the BlendedMVS 1536 x 2048 and DTU's
# 1200 x 1600, on images it writes; then the input-pipeline bench at its
# defaults (2 scans x 5 views x 7 lights at 1200 x 1600, B=2, 4 workers)
# for `bench_steps` steps at train_step's measured ms per step
HOST_CODEC = dict(sizes=((1152, 1536), (1536, 2048), (1200, 1600)), bench_steps=20,
                  bench_scans=2, native_reps=3)
# OpenCV's share, as the data paths call it: the training resize's area
# shrink at the protocol's smallest scale and a fractional one, the DINOv2
# matcher's uint8 shrink of a 1260 x 1932 photo to its 420 x 644 working
# size (3 x 3 cells), the hue shift of the protocol's smallest crop, the
# linear resize of scripts/test_dtu.sh, test_tt_inter.sh and test_eth3d.sh
RESAMPLE = dict(area_scales=(0.55, 0.6133), train_hw=(1200, 1600), hue_crop=(512, 640),
                match_u8=((1260, 1932), (420, 644)),
                linear=(((1200, 1600), (1152, 1536)), ((1080, 1920), (1024, 1920)),
                        ((4032, 6048), (1024, 1600))))
# the files PIL wrote (tests/data/make_image_fixtures.py), each with PIL's
# pixels beside it as .npy; the large progressive JPEG's pixels by SHA-256;
# then the arithmetic-coded and lossless JPEG files libjpeg-turbo wrote
# (faults F4) and the PNM, GIF, WebP and JPEG 2000 files PIL wrote (F5),
# the latter with PIL's convert("RGB") pixels (read_image_u8's)
FIXTURES = REPO / "tests" / "data"
F3_FIXTURES = ("progressive_420_q90.jpg", "cmyk_q90.jpg", "ycck_q90.jpg", "gray16.png",
               "rgb16_adam7.png", "gray4_adam7.png")
F4_FIXTURES = ("arith_420_q85.jpg", "arith_444_dac_r3.jpg", "arith_progressive_q85.jpg",
               "lossless_p1.jpg", "lossless_p7_pt2_r61.jpg", "lossless_gray_p4.jpg")
F5_FIXTURES = ("p6_1000.ppm", "p2_100.pgm", "p4.pbm", "interlaced_trans.gif", "lossy_q75.webp",
               "lossless.webp", "lossy_alpha.webp", "anim.webp", "irreversible_tiles.jp2",
               "reversible_rlcp.j2k", "gray16.jp2")
# each train_step path's measured ms per step, by family (run_train_step)
STEP_MS: dict = {}


def photo(seed: int, h: int, w: int) -> np.ndarray:
    """A uint8 RGB image with a photograph's mix of smooth shading, edges and
    sensor noise: low-frequency gradients, a blocky texture and noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float32)
    shade = np.stack([np.sin(x / 97 + c) * np.cos(y / 71 - c) for c in range(3)], -1) * 60 + 120
    cells = rng.rand(h // 24 + 1, w // 24 + 1, 3).astype(np.float32)
    blocks = np.kron(cells, np.ones((24, 24, 1), np.float32))[:h, :w] * 60 - 30
    noise = rng.randn(h, w, 3).astype(np.float32) * 4
    return np.clip(shade + blocks + noise, 0, 255).astype(np.uint8)


def _best_ms(fn, reps: int):
    """(the result of fn, its least wall ms over reps calls)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def host_stage_ms(h: int, w: int) -> dict:
    """Wall ms of each host stage of one DTU training view at h x w
    (MVSTrainDataset.get_sample's order): reading and decoding the Paeth PNG
    (uint8 to float32 included), the area shrink at the protocol's smallest
    crop (512 x 640 over a 0.55 scale) as get_sample makes it, in the
    crop's window only, checked against the same crop of the whole shrink,
    the colour jitter, the native crop + normalise; the next host stage to
    port is the largest."""
    from mvsformerplusplus_tpu_torch.data import native
    from mvsformerplusplus_tpu_torch.data.io import read_image, write_png
    from mvsformerplusplus_tpu_torch.data.mvs_dataset import resize_image
    from mvsformerplusplus_tpu_torch.data.transforms import (apply_color_jitter,
                                                             sample_jitter_params)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        path = Path(tmp) / "view.png"
        write_png(path, photo(7, h, w), row_filter=4)
        jitter = sample_jitter_params(np.random.RandomState(0))
        img, read_ms = _best_ms(lambda: read_image(path), 2)
    view, window_ms = _best_ms(lambda: resize_image(img, 0.55, (3, 5, 512, 640)), 2)
    if not np.array_equal(view, resize_image(img, 0.55)[3:3 + 512, 5:5 + 640]):
        raise SystemExit("host_codec: the windowed area shrink differs from the whole's crop")
    jittered, jitter_ms = _best_ms(lambda: apply_color_jitter(view, jitter, include_gamma=False),
                                   2)
    _, norm_ms = _best_ms(lambda: native.crop_normalize(jittered, 0, 0, 512, 640,
                                                        jitter["gamma"]), 2)
    return {"read_png_to_f32": read_ms, "area_shrink_window": window_ms,
            "color_jitter": jitter_ms, "crop_normalize_native": norm_ms}


def host_resample(reps: int):
    """The host library's resizes and hue shift against data/image.py's
    numpy versions at RESAMPLE's sizes: ({name: {"native": ms, "numpy":
    ms}}, {check: equal})."""
    from mvsformerplusplus_tpu_torch.data import image, native

    rows, checks = {}, {}

    def pair(name, native_fn, plain_fn):
        got, native_ms = _best_ms(native_fn, reps)
        want, plain_ms = _best_ms(plain_fn, 1)
        checks[name] = bool(got.dtype == want.dtype and np.array_equal(got, want))
        rows[name] = {"native": native_ms, "numpy": plain_ms}

    h, w = RESAMPLE["train_hw"]
    img = photo(3, h, w).astype(np.float32) / 255.0
    for s in RESAMPLE["area_scales"]:
        nh, nw = int(h * s), int(w * s)
        pair(f"resize_area_{h}x{w}_to_{nh}x{nw}", lambda: native.resize_area(img, nh, nw),
             lambda: image.resize_area(img, nh, nw))
    (mh, mw), (nh, nw) = RESAMPLE["match_u8"]
    photo_u8 = photo(5, mh, mw)
    pair(f"resize_area_u8_{mh}x{mw}_to_{nh}x{nw}", lambda: native.resize_area(photo_u8, nh, nw),
         lambda: image.resize_area(photo_u8, nh, nw))
    depth = np.random.RandomState(4).uniform(425, 935, (h, w)).astype(np.float32)
    nh, nw = int(h * 0.55), int(w * 0.55)
    pair(f"resize_nearest_depth_{h}x{w}_to_{nh}x{nw}",
         lambda: native.resize_nearest(depth, nh, nw), lambda: image.resize_nearest(depth, nh, nw))
    ch, cw = RESAMPLE["hue_crop"]
    crop = np.ascontiguousarray(img[:ch, :cw])
    pair(f"hue_shift_{ch}x{cw}", lambda: native.hue_shift(crop, 5),
         lambda: image.hue_shift(crop, 5))
    del img, depth, crop, photo_u8
    for i, ((sh, sw), (dh, dw)) in enumerate(RESAMPLE["linear"]):
        src = photo(10 + i, sh, sw).astype(np.float32) / 255.0
        pair(f"resize_linear_{sh}x{sw}_to_{dh}x{dw}", lambda: native.resize_linear(src, dh, dw),
             lambda: image.resize_linear(src, dh, dw))
        del src
    return rows, checks


def host_fixtures(reps: int):
    """The committed files PIL (or libjpeg-turbo) wrote, each decoded
    natively and (JPEG and PNG) by numpy against PIL's stored pixels, and
    the large progressive JPEG's native
    decode (pixels hashed) against the baseline file of the same image and
    quality: ({name: ms}, {check: equal})."""
    import hashlib

    from mvsformerplusplus_tpu_torch.data import io as dio
    from mvsformerplusplus_tpu_torch.data import jpeg, native

    rows, checks = {}, {}
    for name in F3_FIXTURES + F4_FIXTURES + F5_FIXTURES:
        path = FIXTURES / name
        want = np.load(FIXTURES / (name + ".npy"))
        if name in F5_FIXTURES:  # no numpy twin: the host library's decoders only
            sides = {"native": lambda: dio.read_image_u8(path)}
        elif name.endswith(".jpg"):
            data = path.read_bytes()
            sides = {"native": lambda: jpeg.decode_native(data), "numpy": lambda: jpeg.decode(data)}
        else:
            sides = {"native": lambda: dio.read_png(path),
                     "numpy": lambda: dio.read_png(path, plain=True)}
        rows[name] = {}
        for side, fn in sides.items():
            got, ms = _best_ms(fn, reps if side == "native" else 1)
            checks[f"{name}_{side}"] = bool(got.dtype == want.dtype and np.array_equal(got, want))
            rows[name][side] = ms
    (big, meta), = json.loads((FIXTURES / "image_fixtures.json").read_text()).items()
    data = (FIXTURES / big).read_bytes()
    before = native.calls["jpeg_decode_progressive"]
    pixels, prog_ms = _best_ms(lambda: jpeg.decode_native(data), reps)
    checks["large_progressive_scans_native"] = native.calls["jpeg_decode_progressive"] > before
    checks["large_progressive_pil_pixels"] = (
        list(pixels.shape) == meta["shape"]
        and hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest() == meta["sha256"])
    baseline = jpeg.encode_native(photo(0, *meta["shape"][:2]), meta["quality"])
    _, base_ms = _best_ms(lambda: jpeg.decode_native(baseline), reps)
    rows[big] = {"native_progressive": prog_ms, "native_baseline": base_ms,
                 "progressive_bytes": len(data), "baseline_bytes": len(baseline)}
    # the same photo as lossy WebP and 9/7 JPEG 2000 at the eval scans' size
    for name, meta in json.loads((FIXTURES / "large_format_fixtures.json").read_text()).items():
        pixels, ms = _best_ms(lambda: dio.read_image_u8(FIXTURES / name), reps)
        digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
        checks[f"{name}_pil_pixels"] = list(pixels.shape) == meta["shape"] and \
            digest == meta["sha256"]
        rows[name] = {"native": ms, "bytes": (FIXTURES / name).stat().st_size}
    return rows, checks


def run_host_codec(host_build_s: float, step_ms: float) -> dict:
    """The host library against the numpy codec, each size of HOST_CODEC on
    an image this phase makes (photo): the JPEG encoder (quality 95, the
    native bytes equal to the numpy bytes), the decoder on those bytes
    (pixel-equal) and the row unfilter of a Paeth-filtered PNG of the same
    image (equal), ms per image for each (the native side the least of
    native_reps calls, zlib's inflate apart); the host stages of one DTU
    training view (host_stage_ms); then the ported input-pipeline bench
    (tools/bench_input_pipeline.py) at its defaults with `step_ms`, the
    flagship's train_step ms per step, as the simulated device step, its
    JSON line as it printed it. Between them, OpenCV's share
    (host_resample) and the committed files PIL wrote (host_fixtures).
    Checks the equalities, the bench's keys and that no plain version ran
    in the bench, whose resizes and hue shifts are native."""
    import zlib

    from mvsformerplusplus_tpu_torch.data import io as dio
    from mvsformerplusplus_tpu_torch.data import jpeg, native
    from mvsformerplusplus_tpu_torch.tools import bench_input_pipeline as bench

    phase_t0 = time.perf_counter()
    reps = HOST_CODEC["native_reps"]
    sizes, checks = {}, {}
    for i, (h, w) in enumerate(HOST_CODEC["sizes"]):
        img = photo(i, h, w)
        data, enc_native = _best_ms(lambda: jpeg.encode_native(img), reps)
        plain_bytes, enc_plain = _best_ms(lambda: jpeg.encode(img), 1)
        pixels, dec_native = _best_ms(lambda: jpeg.decode_native(data), reps)
        plain_pixels, dec_plain = _best_ms(lambda: jpeg.decode(data), 1)
        png = dio.encode_png(img, row_filter=4)
        idat = png[png.index(b"IDAT") + 4:-16]  # encode_png writes one IDAT chunk
        raw, inflate_ms = _best_ms(lambda: np.frombuffer(zlib.decompress(idat), np.uint8), reps)
        rows = raw.reshape(h, w * 3 + 1)
        png_native, unf_native = _best_ms(lambda: native.png_unfilter(rows, 3), reps)
        png_plain, unf_plain = _best_ms(lambda: dio._unfilter(rows[:, 0], rows[:, 1:], 3), 1)
        key = f"{h}x{w}"
        checks[f"jpeg_bytes_equal_{key}"] = data == plain_bytes
        checks[f"jpeg_pixels_equal_{key}"] = bool(np.array_equal(pixels, plain_pixels))
        checks[f"png_rows_equal_{key}"] = (bool(np.array_equal(png_native, png_plain))
                                           and bool(np.array_equal(png_native.reshape(h, w, 3),
                                                                   img)))
        sizes[key] = {"jpeg_bytes": len(data),
                      "jpeg_decode_ms": {"native": dec_native, "numpy": dec_plain},
                      "jpeg_encode_ms": {"native": enc_native, "numpy": enc_plain},
                      "png_paeth_ms": {"zlib_inflate": inflate_ms, "native_unfilter": unf_native,
                                       "numpy_unfilter": unf_plain,
                                       "native_total": inflate_ms + unf_native}}
    resample, resample_checks = host_resample(reps)
    fixtures, fixture_checks = host_fixtures(reps)
    checks.update(resample_checks)
    checks.update(fixture_checks)
    stages = host_stage_ms(1200, 1600)
    zero_counts({})
    argv = ["--steps", str(HOST_CODEC["bench_steps"]), "--scans", str(HOST_CODEC["bench_scans"]),
            "--step-ms", f"{step_ms:.1f}"]
    t0 = time.perf_counter()
    result = bench.main(argv)
    bench_s = time.perf_counter() - t0
    host = read_host_counts()
    checks["bench_keys"] = set(result) >= {"producer_ms_per_batch", "stall_ms_per_step",
                                           "overlap_efficiency", "keeps_up", "p95_wait_ms"}
    checks["bench_png_native"] = (host["native"]["png_unfilter"] > 0
                                  and not any(host["plain"].values()))
    checks["bench_resample_native"] = all(host["native"][k] > 0 for k in (
        "resize_area", "resize_nearest", "hue_shift"))
    row = {"phase": "host_codec", "host_build_s": host_build_s, "sizes": sizes,
           "resample_ms": resample, "fixtures_ms": fixtures, "stages_ms_1200x1600": stages, "bench_argv": argv, "bench": result,
           "bench_s": bench_s, "bench_scans": HOST_CODEC["bench_scans"], "host_calls": host,
           "checks": checks, "phase_s": time.perf_counter() - phase_t0}
    emit(row)
    if not all(checks.values()):
        raise SystemExit(f"host_codec checks failed: {checks}")
    return row


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


# the conv's counted opcodes: the tensor cores (HMMA), ldmatrix (LDSM),
# cp.async (LDGSTS); LDG also counts LDGSTS, LDS also LDSM
CONV_SASS_OPS = ("HMMA", "LDSM", "LDGSTS", "LDG", "LDS", "STS", "STG", "FFMA", "IMAD")
# the flash forward's: the tensor cores (HMMA; m16n8k8 tf32 is
# HMMA.1688.F32.TF32), ldmatrix, cp.async, the exponentials (MUFU) and the
# FP32 and integer pipes' ops that the 3xTF32 splits and the softmax add
FLASH_SASS_OPS = ("HMMA", "HMMA.1688.F32.TF32", "LDSM", "LDGSTS", "LDS", "STG", "MUFU", "FFMA",
                  "FADD", "FMUL", "FMNMX", "LOP3", "IADD3", "IMAD")


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

    from mvsformerplusplus_tpu_torch.data import native

    t0 = time.perf_counter()
    host_build = concurrent.futures.ThreadPoolExecutor(1).submit(native.build)
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    host_build.result()
    host_build_s = time.perf_counter() - t0
    flash_sass = sass_counts(kernels, "flash_attention", FLASH_SASS_OPS)
    emit({"phase": "build", "seconds": build_s, "host_library": str(native.lib_path().name),
          "host_build_s": host_build_s,
          "ptxas": {name: ptxas_by_kernel(log) for name, log in logs.items()},
          "sass": {**{name: sass_counts(kernels, name) for name in ("warp", "warp_bwd")},
                   "conv2d": sass_counts(kernels, "conv2d", CONV_SASS_OPS),
                   "flash_attention": flash_sass}})
    tf32_mma = [counts["HMMA.1688.F32.TF32"] for name, counts in flash_sass.items()
                if "flash_fwd_3xtf32_kernel" in name] if isinstance(flash_sass, dict) else []
    if len(tf32_mma) != 4 or not all(tf32_mma):
        raise SystemExit(f"the f32 flash forward's SASS at its 4 head dims has no tf32 "
                         f"tensor-core op: {tf32_mma}")

    e2e_root = Path(tempfile.mkdtemp(prefix="chip_smoke_e2e_"))
    scene_root = Path(tempfile.mkdtemp(prefix="chip_smoke_scenes_"))
    renderer = start_render(render_e2e_data, e2e_root, 2)
    scene_renderer = start_render(render_scene_data, scene_root, 1)
    try:
        return run_phases(card, kind, e2e_root, renderer, host_build_s, scene_root,
                          scene_renderer)
    finally:
        for proc in (renderer, scene_renderer):
            if proc.is_alive():
                proc.terminate()
            proc.join()
        shutil.rmtree(e2e_root, ignore_errors=True)
        shutil.rmtree(scene_root, ignore_errors=True)


def run_phases(card, kind, e2e_root, renderer, host_build_s, scene_root,
               scene_renderer) -> int:
    """Every phase after the build, the e2e_protocol data rendered meanwhile
    by `renderer` under e2e_root and scene_convert's by `scene_renderer`
    under scene_root; the last lines as main's docstring says."""
    counters = launch_counters()
    results = run_kernel_phase(counters)
    assert set(counters) == set(results)
    for family in ("flagship", "casmvs", "variants"):
        run_reference_phase(family)
        run_reference_train_phase(family)
    run_variant_modules_phase()
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        for path, run in (("main_path", lambda: run_main_path(counters)),
                          ("train_step", lambda: run_train_step(counters)),
                          ("train_cli", lambda: run_train_cli(counters, work)),
                          ("eval_cli", lambda: run_eval_cli(counters, work)),
                          ("casmvs_main_path", lambda: run_main_path(counters, "casmvs")),
                          ("casmvs_train_step", lambda: run_train_step(counters, "casmvs")),
                          ("variants_main_path", lambda: run_main_path(counters, "variants")),
                          ("variants_train_step", lambda: run_train_step(counters, "variants")),
                          ("casmvs_cli", lambda: run_casmvs_cli(counters, work)),
                          ("blended_cli", lambda: run_blended_cli(counters, work)),
                          ("dist_step", lambda: run_dist_step(counters)),
                          ("train_cli_mesh", lambda: run_train_cli_mesh(counters, work)),
                          ("eval_queue", lambda: run_eval_queue(counters, work))):
            by_path[path] = run()
            release()
        by_path.update(run_e2e_protocol(counters, e2e_root, renderer))
        release()
        run_vit_pth_phase(work)
        by_path["dino_match"] = run_dino_match(counters, work)
        release()
        by_path["scene_convert"] = run_scene_convert(counters, work, scene_root,
                                                     scene_renderer)
    results = {name: kernel_summary(name) for name in results}
    run_host_codec(host_build_s, STEP_MS["flagship"])
    by_path["eval_cli"], eval_row = by_path["eval_cli"]
    for name, res in results.items():
        res["launches_by_path"] = {path: by_path[path][name] for path in by_path}
        res["launches"] = sum(res["launches_by_path"].values())
        for path, n in res["launches_by_path"].items():
            checked = sum(res["cases"].get(path, {}).values())
            if checked != n:
                raise SystemExit(f"{name}: the kernel phase checks {checked} launches per run of "
                                 f"{path} at its shapes, the {path} run made {n}")
    print(card, flush=True)
    emit({"metric": "eval_cli_depth_maps_per_sec", "value": 1e3 / eval_row["ms_per_map"],
          "unit": "depth maps/s end to end through the eval CLI (1152x1536, 5 views, 192 "
                  "depths, bf16, data + forward + writes, 1 card)",
          "extra": {k: eval_row[k] for k in ("ms_per_map", "forward_ms_per_map",
                                             "decode_ms_per_image", "encode_ms_per_image",
                                             "loader_wait_share", "fusion_s_per_scan",
                                             "points_per_cloud", "peak_mem_gb")},
          "device_kind": kind, "nvidia_smi": card})
    emit({"kernels": list(results.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
