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
