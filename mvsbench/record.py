"""What a run records for the per-layer metric readers: the benchmark's own
host spans around the calls into the program, the window's work, and, in a
traced run, the device trace and the reference's product and call counts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Run:
    kind: str  # the loop: "eval"
    units: int = 0  # maps completed in the window
    window_s: float = 0.0
    latencies: List[float] = field(default_factory=list)  # each map's, in seconds
    tail_min: int = 100  # the fewest maps a window needs for its 90th percentile
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    trace: Optional[dict] = None  # trace.summarise()'s result (traced runs)
    products_per_unit: Optional[float] = None  # the reference's, 2 per multiply-add
    calls: Optional[list] = None  # the reference's calls of the kernels' functions
    dtype_bytes: int = 2  # bytes of an element of the configuration's compute type
    peaks: Optional[dict] = None  # the card's row of peaks.json
    families: Optional[dict] = None  # kernel_families.json

    def span(self, name: str):
        return _Span(self, name)

    def span_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)


class _Span:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.run.spans.append((self.name, self.t0, time.perf_counter()))
