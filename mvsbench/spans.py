"""The program's own spans inside its forward, read by part: host and
device ms a map of the FPN, the ViT, the SVA decoder, the FMT, the cost
volumes, the regularizers and the heads.

The program records its spans while any torch profiler session is on, the
traced run's CUDA-only one included (`utils.profiler.annotate`), and
`utils.profiler.spans()` gives them with their host start and end and their
device start and end, both on the host's `time.perf_counter()` clock, the
clock of the benchmark's own spans. Read are the root `forward` spans whose
host start lies in the window (the benchmark's spans, which the loop clears
before the window, from their first start to their last end), and every
span under them. A part's host ms is the sum of its spans' durations; its
device ms the sum of the device time between each span's events, the card's
idle time inside the span included: where the two are close, the host sets
the part's pace. Both are over the window's maps.

None where the program has no `spans()`, where no root forward lies in the
window, and, for device ms, where the spans carry no events (the CPU).
"""
from __future__ import annotations

# the parts by the names of their spans (a stage's children by their own names)
PARTS = {"encoder": "fpn", "decoder": "fpn", "vit": "vit", "decoder_vit": "sva", "fmt": "fmt",
         "volume": "volume", "cost_reg": "cost_reg", "hypotheses": "heads", "heads": "heads",
         "cascade.confidence": "heads"}


def program_spans():
    """The program's resolved spans, or None where it has no spans()."""
    try:
        from mvsformerplusplus_tpu_torch.utils import profiler
    except ImportError:
        return None
    spans = getattr(profiler, "spans", None)
    return None if spans is None else spans()


def window_forwards(run, records) -> list:
    """The records under the root forwards whose host start lies in the
    window of the benchmark's spans."""
    if not run.spans:
        return []
    t0 = min(s[1] for s in run.spans)
    t1 = max(s[2] for s in run.spans)
    roots = {r["id"] for r in records
             if r["parent"] is None and r["name"] == "forward" and t0 <= r["start"] <= t1}
    return [r for r in records if r["root"] in roots]


def by_part(run) -> dict | None:
    """{"forwards", "host_ms" {part: ms a map}, "device_ms" {part: ms a
    map} or None}, read once a run; None where there is nothing to read."""
    if "program_parts" not in vars(run):
        run.program_parts = _read(run)
    return run.program_parts


def _read(run) -> dict | None:
    if run.kind != "eval" or not run.units:
        return None
    records = program_spans()
    if records is None:
        return None
    inside = window_forwards(run, records)
    if not inside:
        return None
    host = dict.fromkeys(PARTS.values(), 0.0)
    device = dict.fromkeys(PARTS.values(), 0.0)
    timed = True
    for r in inside:
        part = PARTS.get(r["name"])
        if part is None:
            continue
        host[part] += r["end"] - r["start"]
        if r["device_start"] is None:
            timed = False
        else:
            device[part] += r["device_end"] - r["device_start"]
    per_map = 1e3 / run.units
    return {"forwards": sum(r["parent"] is None for r in inside),
            "host_ms": {p: s * per_map for p, s in host.items()},
            "device_ms": {p: s * per_map for p, s in device.items()} if timed else None}


def read_part(run, part: str, clock: str) -> float | None:
    """`part`'s ms a map on `clock` ("host_ms" or "device_ms"), or None."""
    parts = by_part(run)
    if parts is None or parts[clock] is None:
        return None
    return parts[clock][part]
