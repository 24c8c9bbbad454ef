"""utils/profiler.py on torch against the JAX utils/profiler.py's contract,
on the CPU: trace() writes a Chrome trace that holds an annotate() range
and the ops inside it; Stopwatch.measure and time_fn record their times as
the JAX Stopwatch does (time_fn returns the last output and the mean
seconds per call); device_memory_stats() gives the JAX version's keys,
zeros on the CPU where JAX's CPU device reports none. The card's side
(CUDA activity in the trace, the allocator's numbers) is chip_smoke.py's
dino_match phase's."""
import json

import jax
import torch

from mvsformerplusplus_tpu.utils import profiler as jprofiler
from mvsformerplusplus_tpu_torch.utils import profiler


def test_trace_holds_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with profiler.trace(tmp_path):
        with profiler.annotate("e2e_step"):
            (x @ x).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "e2e_step" in names and "aten::mm" in names


def test_stopwatch_matches_the_jax_contract():
    for sw in (profiler.Stopwatch(), jprofiler.Stopwatch()):
        with sw.measure("block"):
            sum(range(1000))
        calls = []
        out, dt = sw.time_fn("fn", lambda a: calls.append(a) or a * 2, 3, iters=4, warmup=2)
        assert out == 6 and dt >= 0 and len(calls) == 6
        assert set(sw.summary()) == {"block", "fn"} and len(sw.times["fn"]) == 1


def test_time_fn_waits_for_nested_tensor_outputs():
    out, dt = profiler.Stopwatch().time_fn(
        "model", lambda x: {"depth": x + 1, "stages": [x * 2, (x, "tag")]}, torch.ones(3))
    assert torch.equal(out["depth"], torch.full((3,), 2.0)) and dt >= 0
    assert profiler.block_until_ready(out) is out


def test_device_memory_stats_keys_and_cpu_zeros():
    want = jprofiler.device_memory_stats(jax.devices("cpu")[0])
    got = profiler.device_memory_stats("cpu")
    assert set(got) == set(want)
    assert got == {k: 0 for k in want}

