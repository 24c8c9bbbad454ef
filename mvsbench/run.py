"""Run one cell of the benchmark once and print its result line.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. The cell names a
configuration and a traffic mix (harness.py); the mix names its loop, which
sets up, measures for `--seconds` and checks what it served against the
plain reference. With `--trace 0` the last line of standard output carries
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a device trace of the window and the reference's counts. The numbers
compared for `correct`, each with its limit, end standard error and the
result line. Without CUDA, or with fewer cards than the cell asks for, the
run exits with 3 and prints no result; a run after which jax, flax or the
JAX package are loaded exits with 4. The process keeps the program's own
thread and core settings: the benchmark measures the host set-up that the
program's entry points give their users.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path.cwd()
# every cache the program or a library keeps goes inside the checkout, at a
# fixed path, so a later run of the cell finds what the first one built
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from . import harness  # noqa: E402
from .harness import HERE, Refused  # noqa: E402


class Context:
    """What a loop gets: the cell's files, the seed and window, and the
    run's clock, device, memory, tracing and counting services."""

    def __init__(self, bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", precision: str = "fp32"):
        self.bench, self.cell = bench, cell
        self.config = harness.load_json(HERE / "configs" / f"{cell['config']}.json")
        self.traffic = harness.load_json(HERE / "traffic" / f"{cell['traffic']}.json")
        path = HERE / "limits" / f"{cell['name']}.json"
        self.limits = harness.load_json(path) if path.is_file() else {}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.precision = precision
        self.setup_peak = 0

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> float:
        self.sync()
        return harness.process_age_s()

    def window_start(self) -> None:
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def tracing(self):
        if not (self.trace and self.cuda):
            return contextlib.nullcontext()
        from .trace import Tracer

        return Tracer()

    def warm_tracer(self, fn) -> None:
        """In a traced run, one call of fn under a profiler whose trace is
        dropped: the profiler's first session starts slowly, and not in the
        window."""
        if self.trace and self.cuda:
            from .trace import Tracer

            with Tracer():
                fn()

    def summarise(self, tracer, t0, t1, spans) -> dict:
        from .trace import summarise

        return summarise(tracer, t0, t1, spans)

    def free(self) -> None:
        import gc

        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def count(self, record) -> None:
        """The reference's products and calls of one map at the cell's
        shapes, and the card's peaks and the kernel families, into
        `record`."""
        from .counts import reference_pass

        t = self.traffic
        shapes = {"b": 1, "v": t["views"], "h": t["height"],
                  "w": t["width"], "d": t["ndepths"]}
        record.products_per_unit, record.calls = reference_pass(
            self.config["config"]["arch"]["args"], shapes)
        if self.cuda:
            peaks = harness.load_json(HERE / "peaks.json")
            record.peaks = peaks.get(torch.cuda.get_device_name(self.device))
        record.families = harness.load_json(HERE / "kernel_families.json")


def device_info(ctx: Context, peak: int, traced: dict | None) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
            "count": 1, "memory_peak_bytes": int(peak)}
    if traced is not None:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    try:
        info["power_limit_w"] = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def execute(ctx: Context) -> tuple:
    """Run the cell: (result line, the checks) as the loop reports them."""
    loop = harness.load_module(HERE / "loops" / f"{ctx.traffic['loop']}.py",
                               f"mvsbench.loops.{ctx.traffic['loop']}")
    out = loop.run(ctx)
    bench, cell, record = ctx.bench, ctx.cell, out["record"]
    e2e_defs = [m for m in bench["end_to_end"] if harness.applies(m, cell, ())]
    e2e_names = [m["name"] for m in e2e_defs]
    if ctx.trace:
        defs = [m for m in bench["per_layer"] if harness.applies(m, cell, e2e_names)]
        metrics = {}
        for m in defs:
            value = harness.read_metric(m["name"], record)
            if value is not None:
                metrics[m["name"]] = value
    else:
        defs = e2e_defs
        metrics = {m["name"]: out["e2e"][m["name"]] for m in defs if m["name"] in out["e2e"]}
    units = {m["name"]: m["unit"] for m in defs}
    peak = max(ctx.setup_peak, int(out["e2e"].get("peak_mem_gb", 0) * 1e9))
    traced = None
    if ctx.trace and record.trace is not None:
        traced = record.trace
    checks = out["checks"]
    correct = all(ok for *_, ok in checks)
    breakdown = None
    if traced is not None:
        from .trace import breakdown as make_breakdown

        breakdown = make_breakdown(traced)
    info = device_info(ctx, peak, traced) if ctx.cuda else {"platform": "cpu", "kind": "cpu",
                                                             "count": 0,
                                                             "memory_peak_bytes": 0}
    line = harness.result_line(correct, out["attempted"], out["failed"], metrics, units, info,
                               checks, breakdown)
    return line, checks


def main(argv=None, device: str = "cuda") -> int:
    """The command; `device` "cpu" (the tests') skips the look for a card
    and runs the same path on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = harness.load_json(ROOT / "BENCHMARK.json")
        cell = harness.find_cell(bench, args.workload)
        if device == "cuda" and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < cell["chips"]):
            print(f"mvsbench: the cell needs {cell['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 3
        import mvsformerplusplus_tpu_torch  # noqa: F401  (the program under test)

        ctx = Context(bench, cell, args.seed, args.seconds, bool(args.trace), device=device)
        line, checks = execute(ctx)
    except (Refused, ImportError) as e:
        print(f"mvsbench: {e}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"mvsbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    print(harness.checks_text(checks), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
