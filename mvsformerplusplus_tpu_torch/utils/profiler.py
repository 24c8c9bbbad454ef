"""Tracing and timing (counterpart of mvsformerplusplus_tpu/utils/profiler.py,
which wraps jax.profiler).

- `trace(logdir)`: torch.profiler over the block, the card's kernels
  included where CUDA is available; writes a Chrome trace
  (<logdir>/<host>_<pid>.<time>.pt.trace.json) that TensorBoard's profiler
  plugin and ui.perfetto.dev read.
- `annotate(name)`: the program's span. Off any torch profiler session it
  is one check and a shared no-op. Inside one (`trace`, `profile_run`, any
  torch.profiler window, CUDA-only ones too) it records, in `SPANS`, the
  span's name, its dotted path through the spans it nests in, its parent and
  the root span it belongs to (one forward's spans share a root), its host
  start and end on `time.perf_counter()` and, on CUDA, a pair of timing
  events on the current stream (none while the stream captures a graph); a
  CPU-activity session's trace holds it as a named range. A gradient
  checkpoint's replay records nothing (`quiet`, models/layers.remat).
- `spans()`: the recorded spans, each with its device start and end on the
  host clock (None on the CPU).
- `Stopwatch`: wall-clock timing that waits for the device: `time_fn`
  synchronises the devices of its outputs' tensors where JAX calls
  block_until_ready.
- `device_memory_stats()`: bytes in use, their peak and the card's memory,
  from torch.cuda.memory_stats and mem_get_info; zeros on the CPU, as the
  JAX version gives where a device reports no memory stats.
- `profile_run(fn, iters)`: a CUDA-only torch.profiler window over `iters`
  calls of fn: device time and count by kernel, the hand-written kernels'
  share (`HAND_WRITTEN`), the device's busy ms and idle share of the
  CUDA-event wall; `rollup` sums its kernels by category (`category`:
  each hand-written kernel family, then the library's kinds).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                                    str(logdir))):
        yield


SPAN_CAPACITY = 65536  # about 30 spans a map: four 51-s windows of maps
_profiler_enabled = torch.autograd._profiler_enabled
# a named range in a CPU-activity session's trace, near free in any other
_named_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                       torch.profiler.record_function)


class _Record:
    __slots__ = ("id", "name", "path", "parent", "root", "start", "end", "events", "range")


class SpanRing:
    """The newest `capacity` spans (`annotate`), in the order they opened.
    Each thread nests its own spans; a thread inside `quiet` records none.
    A record whose span is evicted hands its events to the next one."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.records = collections.deque(maxlen=capacity)
        self.ids = itertools.count()
        self.free = []  # event pairs of evicted records
        self.local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
            self.local.quiet = 0
        return stack

    def _events(self):
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        if self.free:
            return self.free.pop()
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def open(self, name: str) -> Optional[_Record]:
        stack = self._stack()
        if self.local.quiet:
            return None
        parent = stack[-1] if stack else None
        rec = _Record()
        rec.id, rec.name, rec.end = next(self.ids), name, None
        if parent is None:
            rec.path, rec.parent, rec.root = name, None, rec.id
        else:
            rec.path, rec.parent, rec.root = f"{parent.path}.{name}", parent.id, parent.root
        rec.events = self._events()
        if len(self.records) == self.records.maxlen and self.records[0].events is not None:
            self.free.append(self.records[0].events)
        self.records.append(rec)
        stack.append(rec)
        rec.range = _named_range(rec.path)
        rec.range.__enter__()
        rec.start = time.perf_counter()
        if rec.events is not None:
            rec.events[0].record()
        return rec

    def close(self, rec: Optional[_Record]) -> None:
        if rec is None:
            return
        if rec.events is not None:
            rec.events[1].record()
        rec.end = time.perf_counter()
        rec.range.__exit__(None, None, None)
        rec.range = None
        self._stack().pop()

    @contextlib.contextmanager
    def quiet(self):
        """No span of this thread is recorded inside."""
        self._stack()
        self.local.quiet += 1
        try:
            yield
        finally:
            self.local.quiet -= 1

    def resolve(self) -> List[dict]:
        """The closed spans, oldest first: {"id", "name", "path", "parent",
        "root", "start", "end", "device_start", "device_end"}, in seconds on
        the host clock. The device times come from one synchronize and an
        anchor event recorded right after it on the idle card, whose host
        time is known; they are None for a span recorded without events."""
        recs = [r for r in self.records if r.end is not None]
        anchor = t_anchor = None
        if any(r.events is not None for r in recs):
            torch.cuda.synchronize()
            anchor = torch.cuda.Event(enable_timing=True)
            t_anchor = time.perf_counter()
            anchor.record()
            anchor.synchronize()
        out = []
        for r in recs:
            d0 = d1 = None
            if r.events is not None:
                d0 = t_anchor - r.events[0].elapsed_time(anchor) / 1e3
                d1 = t_anchor - r.events[1].elapsed_time(anchor) / 1e3
            out.append({"id": r.id, "name": r.name, "path": r.path, "parent": r.parent,
                        "root": r.root, "start": r.start, "end": r.end,
                        "device_start": d0, "device_end": d1})
        return out


SPANS = SpanRing()


class _Span:
    __slots__ = ("ring", "name", "rec")

    def __init__(self, ring: SpanRing, name: str):
        self.ring, self.name = ring, name

    def __enter__(self):
        self.rec = self.ring.open(self.name)
        return self

    def __exit__(self, *exc):
        self.ring.close(self.rec)


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The program's span `name` (the module docstring): the shared no-op
    `_OFF` when no torch profiler session is on."""
    if not _profiler_enabled():
        return _OFF
    return _Span(SPANS, name)


def quiet():
    """Inside, this thread records no span (a checkpoint's replay)."""
    return SPANS.quiet()


def spans() -> List[dict]:
    """The recorded spans (SpanRing.resolve)."""
    return SPANS.resolve()


# the forward's parts by the names of their spans
PARTS = {"encoder": "fpn", "decoder": "fpn", "vit": "vit", "decoder_vit": "sva", "fmt": "fmt",
         "volume": "volume", "cost_reg": "cost_reg", "hypotheses": "heads", "heads": "heads",
         "cascade.confidence": "heads"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def block_until_ready(out):
    """Wait for the card(s) that hold `out`'s tensors (nested in dicts,
    lists and tuples); returns `out`."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


class Stopwatch:
    """Wall-clock timing that waits for the device."""

    def __init__(self):
        self.times: Dict[str, list] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        """Wall-clock a block. The block itself must wait for its device work
        (end with block_until_ready(out)); use `time_fn` for the form that
        waits for the outputs."""
        t0 = time.time()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.time() - t0)

    def time_fn(self, name: str, fn, *args, iters: int = 5, warmup: int = 1):
        """fn(*args) `warmup` times, then `iters` timed calls; returns the last
        output and the mean seconds per call, which it also records."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
        block_until_ready(out)
        t0 = time.time()
        for _ in range(iters):
            out = fn(*args)
        block_until_ready(out)
        dt = (time.time() - t0) / iters
        self.times.setdefault(name, []).append(dt)
        return out, dt

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.times.items()}


def device_memory_stats(device=None) -> Dict[str, int]:
    """{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} of a card
    (default: the current one); zeros without CUDA or for a CPU device."""
    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(device)[1]}


# the hand-written kernels by name (csrc/*.cu), by family
FAMILIES = {
    "warp": ("warp_bilinear_vec_kernel", "warp_bilinear_scalar_kernel",
             "warp_bilinear_narrow_kernel"),
    "warp backward": ("warp_bilinear_bwd_vec_kernel", "warp_bilinear_bwd_scalar_kernel"),
    "flash": ("flash_fwd_mma_kernel", "flash_fwd_3xtf32_kernel"),
    "flash backward": ("flash_bwd_mma_kernel", "flash_bwd_3xtf32_kernel"),
    "conv": ("conv2d_mma_kernel", "conv2d_tf32_kernel", "conv2d_pack_tf32_kernel"),
}
# the ones profile_run times one by one (the f32 conv's weight packing aside)
HAND_WRITTEN = ("warp_bilinear_vec_kernel", "warp_bilinear_bwd_vec_kernel",
                "warp_bilinear_scalar_kernel", "warp_bilinear_narrow_kernel",
                "warp_bilinear_bwd_scalar_kernel", "flash_fwd_mma_kernel",
                "flash_bwd_mma_kernel", "flash_fwd_3xtf32_kernel", "flash_bwd_3xtf32_kernel",
                "conv2d_mma_kernel", "conv2d_tf32_kernel")
# the library's kernels by a lower-case substring of their name, the first
# kind that matches (a cuDNN convolution's implicit GEMM is a convolution,
# a dtype conversion's elementwise kernel a copy)
LIBRARY_KINDS = (
    ("cuDNN convolutions", ("cudnn", "convolve", "convolution", "conv2d", "conv3d", "fprop",
                            "dgrad", "wgrad", "winograd", "implicit_gemm")),
    ("GEMMs", ("gemm", "cutlass", "cublas", "matmul", "xmma", "splitk")),
    ("reductions and softmax", ("reduce", "softmax", "norm", "cub::", "scan", "argmax")),
    ("copies and transposes", ("copy", "transpose", "memcpy", "memset", "cat", "index",
                               "gather", "scatter", "nchwtonhwc", "nhwctonchw")),
    ("elementwise", ("elementwise", "pointwise", "fill", "triton")),
)
CATEGORIES = tuple(FAMILIES) + tuple(kind for kind, _ in LIBRARY_KINDS) + ("other",)


def _kernel_name(name: str) -> str:
    """A trace's kernel name up to its template arguments."""
    return name.split("<")[0]


def category(name: str) -> str:
    """The category of a kernel named `name` in a trace: the family of a
    hand-written kernel (matched as profile_run matches HAND_WRITTEN), else
    the first LIBRARY_KINDS entry with a substring in it, else "other"."""
    head = _kernel_name(name)
    for family, kernels in FAMILIES.items():
        if any(k in head for k in kernels):
            return family
    low = name.lower()
    for kind, keys in LIBRARY_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def rollup(kernels) -> Dict[str, float]:
    """[{"name", "ms", ...}] -> ms by category (every one of CATEGORIES)."""
    out = dict.fromkeys(CATEGORIES, 0.0)
    for k in kernels:
        out[category(k["name"])] += k["ms"]
    return out


def profile_run(fn, iters, top=20, trace_path=None) -> dict:
    """torch.profiler tracing CUDA activity only (no host op recording)
    over `iters` calls of fn: device time by kernel name (the `top` longest,
    or all with top None), the share of each hand-written kernel, and the
    device's idle share of the CUDA-event wall time around the same calls
    (one stream, so kernels do not overlap). With `trace_path`, the Chrome
    trace is written there. Returns the last call's result under "result"."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            result = fn()
        end.record()
        torch.cuda.synchronize()
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    wall_ms = start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ours = {k: sum(ms for name, (ms, _) in by_name.items() if k in _kernel_name(name)) / iters
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
