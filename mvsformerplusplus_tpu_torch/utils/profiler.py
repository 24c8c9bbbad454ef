"""Tracing and timing (counterpart of mvsformerplusplus_tpu/utils/profiler.py,
which wraps jax.profiler).

- `trace(logdir)`: torch.profiler over the block, the card's kernels
  included where CUDA is available; writes a Chrome trace
  (<logdir>/<host>_<pid>.<time>.pt.trace.json) that TensorBoard's profiler
  plugin and ui.perfetto.dev read.
- `annotate(name)`: a named range in that trace (record_function).
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

import contextlib
import time
from typing import Dict

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


def annotate(name: str):
    """Label a region of the trace."""
    return torch.profiler.record_function(name)


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
