"""spans.py and the 28 readers of the program's spans by part, on the CPU at
tiny widths: the tiny flagship's forwards under a CPU profiler, two of them
inside the benchmark's spans and one before; every host reading is read,
the parts' host ms sum to no more than the window's root forwards a map,
the `.tt` readers give the `.eval` readings, and device ms are None (no
events on the CPU). None where the program has no spans(), where no forward
lies in the window, and where no profiler session was on."""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvsbench import harness, spans
from mvsbench.record import Run
from mvsbench.tests.test_mvsbench_reference import _inputs
from mvsbench.tests.tiny import REPO, tiny_config

from mvsformerplusplus_tpu_torch.config import Config, build_model  # noqa: E402
from mvsformerplusplus_tpu_torch.utils import profiler  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
PARTS = sorted(set(spans.PARTS.values()))
READERS = [m["name"] for m in BENCH["per_layer"] if m["layer"] in PARTS]


@pytest.fixture
def ring(monkeypatch):
    r = profiler.SpanRing()
    monkeypatch.setattr(profiler, "SPANS", r)
    return r


def served(traced: bool, maps: int = 2) -> Run:
    """A run whose window holds `maps` tiny forwards in "dispatch" spans,
    after one forward outside it; under a CPU profiler when `traced`."""
    model = build_model(Config(tiny_config()["config"]), dtype=torch.float32, device="cpu")
    imgs, cams, dv, _ = _inputs()
    run = Run("eval")
    session = profile(activities=[ProfilerActivity.CPU]) if traced else None
    with torch.inference_mode():
        if session is not None:
            session.__enter__()
        try:
            model(imgs, cams, dv)
            for _ in range(maps):
                with run.span("dispatch"):
                    model(imgs, cams, dv)
        finally:
            if session is not None:
                session.__exit__(None, None, None)
    run.units = maps
    return run


def test_every_part_has_its_readers():
    assert sorted(READERS) == sorted(f"{p}_{c}.{s}" for p in PARTS
                                     for c in ("host_ms", "device_ms") for s in ("eval", "tt"))
    assert [m["name"] for m in BENCH["per_layer"][-len(READERS):]] == READERS
    for m in BENCH["per_layer"][-len(READERS):]:
        cell, moves = (("mvsformerpp.dtu_eval", "maps_per_s") if m["name"].endswith(".eval")
                       else ("mvsformerpp.tt_eval", "peak_mem_gb"))
        assert (m["workloads"], m["moves"], m["unit"], m["better"]) == ([cell], moves, "ms/map",
                                                                        "lower")
        assert m["source"] == ("host_clock" if "_host_ms." in m["name"] else "device_trace")


def test_parts_read_in_the_window(ring):
    run = served(traced=True)
    parts = spans.by_part(run)
    assert parts["forwards"] == run.units == 2 and parts["device_ms"] is None
    got = {n: harness.read_metric(n, run) for n in READERS}
    for p in PARTS:
        assert got[f"{p}_host_ms.eval"] > 0 and got[f"{p}_host_ms.tt"] == got[f"{p}_host_ms.eval"]
        assert got[f"{p}_device_ms.eval"] is None and got[f"{p}_device_ms.tt"] is None
    records = profiler.spans()
    roots = [r for r in records if r["parent"] is None]
    assert len(roots) == 3  # the one before the window is not read
    root_ms = sum(r["end"] - r["start"] for r in roots[1:]) * 1e3 / run.units
    assert sum(got[f"{p}_host_ms.eval"] for p in PARTS) <= root_ms


def test_none_without_spans_api(ring, monkeypatch):
    run = served(traced=True)
    monkeypatch.delattr(profiler, "spans")
    assert all(harness.read_metric(n, run) is None for n in READERS)


def test_none_without_a_profiler_session(ring):
    run = served(traced=False)
    assert len(ring.records) == 0
    assert all(harness.read_metric(n, run) is None for n in READERS)


def test_none_without_forwards_in_the_window(ring):
    run = served(traced=True)
    t_end = max(r["end"] for r in profiler.spans())
    run.spans = [("dispatch", t_end + 1.0, t_end + 2.0)]
    assert all(harness.read_metric(n, run) is None for n in READERS)
