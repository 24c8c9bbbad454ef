"""Device time of the bench's eval forward by kernel and by category, on
the card (counterpart of the trace mode of the repo's tools/profile_eval.py,
which traces the JAX package on a TPU).

    python -m mvsformerplusplus_tpu_torch.tools.profile_eval [--top N] [--outdir DIR]

Builds the bench's eval model and batch (mvsformerplusplus_tpu_torch.bench:
DINOv2MVSNet in bf16 at the DTU eval protocol, weights from a seed), times
a first forward and a steady one on the host clock, then traces one more
in a CUDA-only torch.profiler window (utils.profiler.profile_run) and
prints:
- the `--top` device kernels by time, with their calls;
- the category rollup (utils.profiler.rollup): each hand-written kernel
  family (warp, warp backward, flash, flash backward, conv), then cuDNN
  convolutions, GEMMs, reductions and softmax, copies and transposes,
  elementwise and other;
- the device's busy ms and its idle share of the CUDA-event wall;
- the program's spans in the traced forward (utils.profiler.spans): host ms
  and device ms by span path and by part (utils.profiler.PARTS), the
  device ms between each span's events, idle time inside included.
`--outdir` keeps the Chrome trace (ui.perfetto.dev reads it). CUDA only:
without a card it raises.

Not ported: `--components`, which times the JAX package's TPU warp plans
(folded, banded, fused) one build_volume at a time. The port has one exact
warp (ops/cuda/warp.py) and no plans to choose between.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from .. import bench
from ..utils.profiler import PARTS, profile_run, rollup, spans


def traced(fn, trace_path=None) -> dict:
    """A first call and a steady call of fn on the host clock, then
    profile_run over one more with every kernel kept and their rollup; its
    result under "result"."""
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    prof = profile_run(fn, 1, top=None, trace_path=trace_path)
    prof["categories_ms_per_call"] = rollup(prof["top_kernels_per_call"])
    prof["span_ms"] = span_ms([r for r in spans() if r["start"] >= t0])
    prof["first_call_s"], prof["steady_ms"] = times[0], times[1] * 1e3
    return prof


def span_ms(records) -> dict:
    """Host and device ms per root span of `records` (a forward), by span
    path and by part: {"forwards", "paths" {path: [host, device]}, "parts"
    {part: [host, device]}}; device ms None where a span has no events."""
    forwards = sum(r["parent"] is None for r in records) or 1
    paths, parts = {}, {}
    for r in records:
        host = (r["end"] - r["start"]) * 1e3 / forwards
        dev = (None if r["device_start"] is None
               else (r["device_end"] - r["device_start"]) * 1e3 / forwards)
        for table, key in ((paths, r["path"]), (parts, PARTS.get(r["name"]))):
            if key is not None:
                h, d = table.get(key, (0.0, 0.0))
                table[key] = [h + host, None if d is None or dev is None else d + dev]
    return {"forwards": forwards, "paths": paths, "parts": parts}


def profile_eval(model, inputs, trace_path=None) -> dict:
    """traced() over the eval forward of `model` on `inputs` (imgs, cams,
    depth_values on the card)."""
    def forward():
        with torch.inference_mode():
            return model(*inputs)["refined_depth"]

    prof = traced(forward, trace_path)
    prof["finite"] = bool(torch.isfinite(prof.pop("result").float()).all())
    return prof


def report(prof: dict, top: int, call: str) -> None:
    """Print a traced() result: the top kernels, the rollup, the device's
    busy ms and idle share, per `call`."""
    busy = prof["device_busy_ms_per_call"]
    print(f"first call {prof['first_call_s']:.2f} s, steady {prof['steady_ms']:.1f} ms "
          f"(host clock)")
    print(f"\n== top {top} device kernels by time per {call} (busy {busy:.2f} ms) ==")
    for k in prof["top_kernels_per_call"][:top]:
        print(f"{k['ms']:9.3f} ms {100 * k['ms'] / busy:5.1f}%  x{k['count']:>6g}  "
              f"{k['name'][:100]}")
    print("\n== category rollup ==")
    for cat, ms in sorted(prof["categories_ms_per_call"].items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.3f} ms {100 * ms / busy:5.1f}%  {cat}")
    print(f"\ndevice busy {busy:.2f} ms per {call} of {prof['wall_ms_per_call']:.2f} ms "
          f"(CUDA events), idle share {prof['device_idle_share']:.3f}", flush=True)
    spans_ = prof.get("span_ms")
    if spans_ and spans_["paths"]:
        for title, table in (("span path", spans_["paths"]), ("part", spans_["parts"])):
            print(f"\n== host ms / device ms per {call} by {title} ==")
            for key, (host, dev) in table.items():
                dev = "-" if dev is None else f"{dev:9.3f}"
                print(f"{host:9.3f} {dev:>9} ms  {key}")


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--outdir", default=None, help="write the Chrome trace here")
    return ap


def trace_file(outdir, name: str):
    if outdir is None:
        return None
    Path(outdir).mkdir(parents=True, exist_ok=True)
    return Path(outdir) / f"{name}.pt.trace.json"


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    device = bench.check_device("cuda")
    model = bench.build(False, device=device)
    imgs, cams, dv = bench.make_dtu_eval_batch()
    inputs = (torch.from_numpy(imgs).to(device),
              {k: torch.from_numpy(c).to(device) for k, c in cams.items()},
              torch.from_numpy(dv).to(device))
    prof = profile_eval(model, inputs, trace_file(args.outdir, "profile_eval"))
    report(prof, args.top, "forward")
    return 0 if prof["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
