"""The device trace of a traced run's window: torch.profiler tracing CUDA
activity only (no host op recording, so the host's pace is what it is
untraced, as the program's own profile_run traces it), read into the
device's busy time (the union of its kernels' and copies' intervals), the
kernels by name, and the idle gaps, each named by the benchmark span the
host was in when the device went idle.

The trace's clock is tied to the host's by a marker: a short spin kernel
launched right after a synchronize at a known host time.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

MARKER = "spin_kernel"


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)


def summarise(tracer: Tracer, t0: float, t1: float, spans) -> dict:
    """The window [t0, t1] (host clock) of the trace: {"busy_s", "window_s",
    "kernels" {name: [seconds, count]}, "launches" (kernel count),
    "idle_by_span" {span: seconds}}."""
    events = [e for e in tracer.prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    marks = [e for e in events if MARKER in e.name]
    if not marks:
        raise RuntimeError("trace: the marker kernel is not in the trace")
    offset = min(e.time_range.start for e in marks) / 1e6 - tracer.t_mark
    ivals, kernels, launches = [], defaultdict(lambda: [0.0, 0]), 0
    for e in events:
        a = e.time_range.start / 1e6 - offset
        b = e.time_range.end / 1e6 - offset
        if MARKER in e.name or b <= t0 or a >= t1:
            continue
        a, b = max(a, t0), min(b, t1)
        ivals.append((a, b))
        k = kernels[e.name]
        k[0] += b - a
        k[1] += 1
        if not e.name.startswith("Memcpy") and not e.name.startswith("Memset"):
            launches += 1
    ivals.sort()
    busy, gaps, end = 0.0, [], t0
    for a, b in ivals:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((end, t1))
    return {"busy_s": busy, "window_s": t1 - t0, "kernels": dict(kernels),
            "launches": launches, "idle_by_span": _by_span(gaps, spans)}


def _by_span(gaps, spans) -> dict:
    """Idle seconds by the span the host was in at each gap's start
    ("other" outside every span)."""
    spans = sorted(spans, key=lambda s: s[1])
    out, i = defaultdict(float), 0
    for a, b in gaps:
        while i < len(spans) and spans[i][2] < a:
            i += 1
        name = "other"
        for n, s0, s1 in spans[i:i + 8]:
            if s0 <= a <= s1:
                name = n
                break
        out[name] += b - a
    return dict(out)


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, (s, _) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
