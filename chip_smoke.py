#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  device     the card (and its name and power limit from nvidia-smi, as a
             plain line of its own);
  build      nvcc builds of csrc/*.cu into build/kernels/ (all in parallel);
  kernel     each hand-written kernel against its plain PyTorch version at
             every shape the DTU-eval flagship gives it, element by element
             within ops.cuda.tolerance, and the same check against a planted
             fault, which it must reject; the kernel's, the plain version's
             and one library call's time (CUDA events) and the least time the
             card could take;
  reference  the port on the card (kernels, fp32) against the port on the CPU
             (plain versions, fp32) on a small flagship;
  main_path  the full-width flagship forward at DTU eval (1 x 5 x 1152 x 1536,
             192 depths, bf16, weights drawn from a seed) through
             build_model / load_config, with every kernel's launch count, the
             output checks, ms per depth map and peak memory;
  profile    device ms per top-level layer (CUDA events in forward hooks) and
             torch.profiler over one more forward: device time by kernel,
             the hand-written kernels' share, the device's idle share.
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
# Each `*_cases` yields (case, launches per forward, args) for every shape the
# flagship forward at DTU eval gives the kernel; a case's launches per forward
# are how often the main path calls the kernel at that shape, so they sum to
# the kernel's launch count there. Each `*_fault` plants an arithmetic fault
# (as a change of the inputs) that the kernel-vs-plain check must reject.

def warp_cases():
    """The four stage shapes of the flagship warp (source views batched)."""
    from mvsformerplusplus_tpu_torch.ops.geometry import compose_projection, plane_sweep_coords
    from mvsformerplusplus_tpu_torch.ops.sampling import init_inverse_range

    imgs, cams, dv = to_device(make_dtu_eval_batch(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for i, (c, nd) in enumerate(((64, 32), (32, 16), (16, 8), (8, 4))):
        hh, ww = 1152 // 2 ** (3 - i), 1536 // 2 ** (3 - i)
        projs = compose_projection(cams[f"stage{i + 1}"])
        hypo = init_inverse_range(dv, nd, hh, ww)
        coords, _ = plane_sweep_coords(projs[0, 1:], projs[0, :1].expand(4, 4, 4),
                                       hypo.expand(4, -1, -1, -1), hh, ww)
        src = torch.randn(4, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
        yield f"stage{i + 1}", 1, (src, coords)


def warp_fault(src, coords):
    """Sample positions off by 1/256 pixel."""
    return src, coords + 1 / 256


def flash_cases():
    """The 12 ViT blocks (1729 tokens: 36 x 48 patches of the 504 x 672 input,
    and the class token) and the 6 CTA blocks (the stage-1 volume, 32 x 144 x
    192, down by (2, 4, 4) to 27648 tokens)."""
    from mvsformerplusplus_tpu_torch.ops.attention import entropy_inv_scale

    gen = torch.Generator(device="cuda").manual_seed(2)
    n_vit = (1152 * 7 // 16 // 14) * (1536 * 7 // 16 // 14) + 1
    n_cta = (32 // 2) * (144 // 4) * (192 // 4)
    for name, count, (b, n, h, dh, sc) in (
            ("vit", 12, (5, n_vit, 12, 64, 64 ** -0.5)),
            ("cta", 6, (1, n_cta, 4, 16, entropy_inv_scale(16, n_cta, 12185)))):
        q, k, v = (torch.randn(b, n, h, dh, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        yield name, count, (q, k, v, sc)


def flash_fault(q, k, v, scale):
    """The softmax scale 8% low."""
    return q, k, v, 0.92 * scale


# (case, launches per forward, (batch, divisor of 1152 x 1536, Ci, Co, k)):
# the FPN encoder's stride-1 convs and the decoder's heads on the 5 views, the
# visibility net of each stage on the 4 source views, and the FMT smoothing
# convs, run once per view at batch 1
CONV_SHAPES = ([("encoder_7x7_3to8", 1, (5, 1, 3, 8, 7)), ("encoder_5x5_8to8", 1, (5, 1, 8, 8, 5)),
                ("encoder_16to16", 2, (5, 2, 16, 16, 3)), ("encoder_32to32", 2, (5, 4, 32, 32, 3)),
                ("encoder_64to64", 2, (5, 8, 64, 64, 3)), ("decoder_64to32", 1, (5, 4, 64, 32, 3)),
                ("decoder_64to16", 1, (5, 2, 64, 16, 3)), ("decoder_64to8", 1, (5, 1, 64, 8, 3))]
               + [(f"visibility{s + 1}_{ci}to{co}", 1, (4, 2 ** (3 - s), ci, co, 3))
                  for s in range(4) for ci, co in ((1, 16), (16, 16), (16, 8))]
               + [(f"fmt_smooth_{c}", 5, (1, c // 8, c, c, 3)) for c in (32, 16, 8)])


def conv_cases():
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, count, (b, div, ci, co, k) in CONV_SHAPES:
        x = torch.randn(b, 1152 // div, 1536 // div, ci, generator=gen,
                        device="cuda").to(torch.bfloat16)
        kern = (torch.randn(k, k, ci, co, generator=gen, device="cuda")
                * (k * k * ci) ** -0.5).to(torch.bfloat16)
        yield name, count, (x, kern)


def conv_fault(x, kern):
    """The top row of taps weighted 8% low."""
    kern = kern.clone()
    kern[0] *= 0.92
    return x, kern


def warp_library(src, coords):
    b, h, w, c = src.shape
    d = coords.shape[1]
    img = src.float().permute(0, 3, 1, 2)
    grid = torch.stack([coords[..., 0] / ((w - 1) / 2) - 1, coords[..., 1] / ((h - 1) / 2) - 1],
                       dim=-1).reshape(b, d * coords.shape[2], coords.shape[3], 2)
    return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)


def flash_library(q, k, v, scale):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)


def conv_library(x, kern):
    xc, wc = x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous()
    return lambda: F.conv2d(xc, wc, padding=kern.shape[0] // 2)


def warp_bound(src, coords, out):
    """Each input read once and the output written once, against 4 corners x
    (weight multiply + fma) fp32 operations per output element."""
    return nbytes(src, coords, out) / HBM_BYTES_S, 12 * out.numel() / FP32_FLOPS


def flash_bound(q, k, v, scale, out):
    """Bytes of q, k, v and out, against the two products on bf16 tensor cores
    and the N*M exponentials on the SFUs, whichever takes longer."""
    b, n, h, dh = q.shape
    m = k.shape[1]
    return (nbytes(q, k, v, out) / HBM_BYTES_S,
            max(4 * b * h * n * m * dh / BF16_FLOPS, b * h * n * m / EXP_S))


def conv_bound(x, kern, out):
    b, hh, ww, ci = x.shape
    ky, kx, _, co = kern.shape
    return (nbytes(x, kern, out) / HBM_BYTES_S,
            2 * b * hh * ww * ky * kx * ci * co / BF16_FLOPS)


def kernel_table():
    from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention, warp

    return {
        "warp_bilinear": ("csrc/warp.cu", "mvsformerplusplus_tpu/ops/pallas/warp_band.py:395",
                          warp.warp_bilinear, warp.warp_bilinear_plain, warp_cases, warp_fault,
                          warp_library, warp_bound),
        "flash_attention_fwd": ("csrc/flash_attention.cu",
                                "mvsformerplusplus_tpu/ops/pallas/flash_attention.py:131",
                                flash_attention.flash_attention_fwd,
                                flash_attention.flash_attention_plain, flash_cases, flash_fault,
                                flash_library, flash_bound),
        "conv2d_same": ("csrc/conv2d.cu", "mvsformerplusplus_tpu/ops/pallas/conv2d.py:176",
                        conv2d.conv2d_same, conv2d.conv2d_same_plain, conv_cases, conv_fault,
                        conv_library, conv_bound),
    }


def err_over_tol(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 where they agree."""
    w = want.float()
    return ((got.float() - w).abs() / (atol + rtol * w.abs())).max().item()


def run_kernel_phase():
    """Each kernel against its plain version at every shape the main path
    gives it, element by element within `ops.cuda.tolerance`; each case's
    planted fault must fail the same check. The kernel's summary sums each
    case's times and bound times its launches per forward."""
    from mvsformerplusplus_tpu_torch.ops.cuda import tolerance

    results = {}
    for name, (src, replaces, kernel, plain, cases, fault, library,
               bound) in kernel_table().items():
        rows = []
        for case, count, args in cases():
            want = plain(*args)
            rtol, atol = tolerance(want)
            got = kernel(*args)
            ratio = err_over_tol(got, want, rtol, atol)
            fault_ratio = err_over_tol(kernel(*fault(*args)), want, rtol, atol)
            bytes_s, ops_s = bound(*args, got)
            row = {"phase": "kernel", "kernel": name, "case": case,
                   "launches_per_forward": count,
                   "shapes": [list(a.shape) for a in args if isinstance(a, torch.Tensor)],
                   "max_abs_err": (got.float() - want.float()).abs().max().item(),
                   "max_abs_ref": want.float().abs().max().item(), "rtol": rtol, "atol": atol,
                   "err_over_tol": ratio, "fault_err_over_tol": fault_ratio,
                   "bound_ms": max(bytes_s, ops_s) * 1e3,
                   "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
            del got, want
            row["ms"] = time_ms(lambda: kernel(*args))
            row["plain_ms"] = time_ms(lambda: plain(*args), iters=2)
            row["library_ms"] = time_ms(library(*args))
            emit(row)
            if not ratio <= 1:
                raise SystemExit(f"{name}[{case}] disagrees with its plain version: "
                                 f"error {ratio} x its tolerance")
            if not fault_ratio > 1:
                raise SystemExit(f"{name}[{case}]: the check passes a planted fault "
                                 f"({fault.__doc__})")
            rows.append(row)
            del args
            torch.cuda.empty_cache()
        results[name] = {
            "name": name, "route": "cuda", "source": f"mvsformerplusplus_tpu_torch/{src}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] * r["launches_per_forward"] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * r["launches_per_forward"])[
                "bound_by"],
            "times": "per forward: each case's time x its launches per forward",
            "max_err_over_tol": max(r["err_over_tol"] for r in rows),
            "min_fault_err_over_tol": min(r["fault_err_over_tol"] for r in rows),
            "cases": {r["case"]: r["launches_per_forward"] for r in rows},
        }
    return results


# ------------------------------------------------------------------- model runs

def well_conditioned(dv: torch.Tensor, far: float) -> torch.Tensor:
    """Pixels whose hypotheses are all positive and below 4x the far depth:
    elsewhere the soft-argmax over 1/inv hypotheses amplifies rounding."""
    return ((dv > 0) & (dv < 4 * far)).all(dim=1)


def run_reference_phase():
    """Tiny flagship, fp32: kernels on the card vs plain versions on the CPU."""
    from mvsformerplusplus_tpu_torch.config import init_weights
    from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet

    batch = make_dtu_eval_batch(v=3, h=128, w=256, dfull=48, seed=1)
    outs = {}
    for device in ("cpu", "cuda"):
        model = DINOv2MVSNet(**TINY, dtype=torch.float32)
        init_weights(model, torch.Generator().manual_seed(0))
        model = model.to(device).eval()
        with torch.inference_mode():
            out = model(*to_device(batch, device))
        outs[device] = {k: out[k].float().cpu() for k in ("refined_depth",
                                                            "photometric_confidence")}
        outs[device]["prob4"] = out["stage4"]["prob_volume"].float().cpu()
        outs[device]["dv4"] = out["stage4"]["depth_values"].float().cpu()
    cpu, gpu = outs["cpu"], outs["cuda"]
    mask = well_conditioned(cpu["dv4"], float(batch[2].max()))
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


def run_main_path(counters, iters=3):
    from mvsformerplusplus_tpu_torch.config import build_model, load_config

    model = build_model(load_config(CONFIG), dtype=torch.bfloat16)  # device defaults to cuda
    imgs, cams, dv = to_device(make_dtu_eval_batch(), "cuda")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = model(imgs, cams, dv)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
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
            "every_kernel_launched": all(n > 0 for n in launches.values()),
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


LAYERS = ("encoder", "vit", "decoder_vit", "decoder", "fmt", "cascade.stage1",
          "cascade.stage2", "cascade.stage3", "cascade.stage4")


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


def profile_forward(model, inputs, top=20) -> dict:
    """torch.profiler over one forward: device time by kernel name, the share
    of each hand-written kernel, and the device's idle share of the wall time
    (one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ours = {k: sum(ms for name, (ms, _) in by_name.items() if k in name)
            for k in ("warp_bilinear_kernel", "flash_fwd_kernel", "conv2d_same_kernel")}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"phase": "profile", "layer_ms": layer_ms(model, inputs),
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "hand_written_ms": ours,
            "top_kernels": [{"name": k[:160], "ms": ms, "count": n} for k, (ms, n) in ranked]}


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
    from mvsformerplusplus_tpu_torch.ops.cuda import conv2d, flash_attention, warp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    results = run_kernel_phase()
    run_reference_phase()
    counters = {"warp_bilinear": warp.warp_bilinear,
                "flash_attention_fwd": flash_attention.flash_attention_fwd,
                "conv2d_same": conv2d.conv2d_same}
    launches = run_main_path(counters)
    for name, n in launches.items():
        results[name]["launches"] = n
        checked = sum(results[name]["cases"].values())
        if checked != n:
            raise SystemExit(f"{name}: the kernel phase checks {checked} launches per forward "
                             f"at the main path's shapes, the main path made {n}")
    print(card, flush=True)
    emit({"kernels": list(results.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
