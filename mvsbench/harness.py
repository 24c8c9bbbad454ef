"""What every run shares: the cell's files found by name, the process clock,
the device check, the per-layer metric readers and the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration,
found as `configs/<config>.json`, and a traffic mix, found as
`traffic/<traffic>.json`; the mix names its loop, `loops/<loop>.py`. A
per-layer metric is read by `metrics/<name>.py`, whose `read(run)` returns
its value or None where the run has nothing for it to read. Each cell's
output limits are `limits/<workload>.json`. Adding any of these is adding a
file.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mvsformerplusplus_tpu")


class Refused(Exception):
    """A run that cannot report a result (no card, a missing file)."""


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: dict, e2e_names) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`, or, with
    no list, in every cell (an end-to-end metric) or every cell reporting
    the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, run) -> float | None:
    """The per-layer metric `name` of a traced run, by its reader."""
    reader = load_module(HERE / "metrics" / f"{name}.py", f"mvsbench_metric_{name}")
    return reader.read(run)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def checks_text(checks: list) -> str:
    """[(name, value, limit, ok)] as the lines printed at the end of stderr."""
    return "\n".join(f"check {n}: {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}"
                     for n, v, lim, ok in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, units: dict,
                device: dict, checks: list, breakdown=None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    return json.dumps(line)
