"""The program's spans (utils/profiler.py `annotate`, `spans`) on the CPU:
off any profiler session `annotate` is the shared no-op, allocates nothing
and makes no event, and a forward records nothing; under a CPU profiler the
tiny flagship and CasMVSNet forwards record the module tree (names, dotted
paths, one root a forward, children inside their parents) with no device
times; outputs are bit for bit the same with spans on and off; the ring
keeps its newest records; a checkpoint's replay in the backward records
nothing."""
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvsformerplusplus_tpu_torch.config import init_weights
from mvsformerplusplus_tpu_torch.models.casmvs import CasMVSNet
from mvsformerplusplus_tpu_torch.models.mvsformer import DINOv2MVSNet
from mvsformerplusplus_tpu_torch.tools.profile_eval import span_ms
from mvsformerplusplus_tpu_torch.utils import profiler
from tests.test_casmvs import make_inputs
from tests.test_torch_casmvs import TINY as CASMVS_TINY
from tests.test_torch_flagship import TINY as FLAGSHIP_TINY

STAGE = ("hypotheses", "volume", "cost_reg", "heads")
CASCADE = [p for k in range(1, 5)
           for p in [f"cascade.stage{k}"] + [f"cascade.stage{k}.{c}" for c in STAGE]]
TREES = {"flagship": ["encoder", "vit", "decoder_vit", "decoder", "fmt"] + CASCADE
         + ["cascade.confidence"],
         "casmvs": ["encoder", "decoder"] + CASCADE + ["cascade.confidence"]}
FAMILIES = sorted(TREES)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small CPU ops, several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring in place of the program's."""
    r = profiler.SpanRing()
    monkeypatch.setattr(profiler, "SPANS", r)
    return r


def build(family, **kw):
    if family == "flagship":
        model = DINOv2MVSNet(**FLAGSHIP_TINY, remat_stages=False, **kw)
    else:
        model = CasMVSNet(**CASMVS_TINY, **kw)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval()


def inputs():
    imgs, cams, dv = make_inputs(np.random.RandomState(0), h=64, w=128)
    return (torch.tensor(np.asarray(imgs)),
            {k: torch.tensor(np.asarray(c)) for k, c in cams.items()}, torch.tensor(np.asarray(dv)))


def forward(model, args):
    with torch.inference_mode():
        return model(*args)


def cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def flat(out) -> dict:
    if isinstance(out, torch.Tensor):
        return {"": out}
    return {f"{k}/{p}": t for k, v in out.items() for p, t in flat(v).items()}


def test_off_annotate_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert profiler.annotate("forward") is profiler.annotate("heads") is profiler._OFF


def test_off_annotate_allocates_nothing_and_makes_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an event was made off a profiler session")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with profiler.annotate("warm"):
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiler.annotate("forward"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, profiler.__file__)]
    grown = [d for d in after.filter_traces(here).compare_to(before.filter_traces(here),
                                                             "lineno") if d.size_diff > 0]
    assert grown == []


@pytest.mark.parametrize("family", FAMILIES)
def test_off_forward_records_nothing(family, ring):
    forward(build(family), inputs())
    assert len(ring.records) == 0 and profiler.spans() == []


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_records_the_tree(family, ring):
    model, args = build(family), inputs()
    with cpu_profiler():
        forward(model, args)
        forward(model, args)
    got = profiler.spans()
    roots = [r for r in got if r["parent"] is None]
    assert [r["name"] for r in roots] == ["forward", "forward"]
    by_id = {r["id"]: r for r in got}
    for root in roots:
        tree = [r for r in got if r["root"] == root["id"]]
        assert [r["path"] for r in tree] == ["forward"] + [f"forward.{p}" for p in TREES[family]]
        for r in tree[1:]:
            parent = by_id[r["parent"]]
            assert r["path"] == f"{parent['path']}.{r['name']}"
            assert parent["start"] <= r["start"] <= r["end"] <= parent["end"]
    assert {r["name"] for r in got} - {"forward"} - set(profiler.PARTS) \
        == {f"cascade.stage{k}" for k in range(1, 5)}
    assert all(r["device_start"] is None and r["device_end"] is None for r in got)


@pytest.mark.parametrize("family", FAMILIES)
def test_outputs_bitwise_equal_with_spans_on_and_off(family, ring):
    model, args = build(family), inputs()
    off = flat(forward(model, args))
    with cpu_profiler():
        on = flat(forward(model, args))
    assert len(ring.records) == 1 + len(TREES[family])
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_ring_keeps_the_newest(capacity, ring):
    small = profiler.SpanRing(capacity)
    for i in range(100):
        rec = small.open(f"s{i}")
        small.close(rec)
    got = small.resolve()
    assert [r["name"] for r in got] == [f"s{i}" for i in range(100 - capacity, 100)]
    assert [r["id"] for r in got] == list(range(100 - capacity, 100))


@pytest.mark.parametrize("granularity", ["stage", "cost_reg"])
def test_remat_replay_records_nothing(granularity, ring):
    """A train forward under gradient checkpointing records its tree once;
    the backward's replay of each checkpointed block records nothing."""
    model = build("casmvs", remat_stages=True, remat_granularity=granularity).train()
    replayed = model.cascade.stage1 if granularity == "stage" else model.cascade.stage1.cost_reg
    calls = []
    replayed.register_forward_pre_hook(lambda *a: calls.append(1))
    with cpu_profiler():
        out = model(*inputs())
        n_forward = len(ring.records)
        loss = sum(out[f"stage{k}"]["prob_volume_pre"].mean() for k in range(1, 5))
        loss.backward()
    assert len(calls) == 2  # the forward and its replay
    assert n_forward == len(ring.records) == 1 + len(TREES["casmvs"])
    assert [r["path"] for r in profiler.spans()] \
        == ["forward"] + [f"forward.{p}" for p in TREES["casmvs"]]


@pytest.mark.parametrize("family", FAMILIES)
def test_profile_eval_reads_spans_by_path_and_part(family, ring):
    """tools/profile_eval's table: host ms a forward by path and by part, no
    device ms on the CPU, the parts within the root."""
    model, args = build(family), inputs()
    with cpu_profiler():
        forward(model, args)
        forward(model, args)
    got = span_ms(profiler.spans())
    assert got["forwards"] == 2
    assert list(got["paths"]) == ["forward"] + [f"forward.{p}" for p in TREES[family]]
    want = {"fpn", "volume", "cost_reg", "heads"} | (
        {"vit", "sva", "fmt"} if family == "flagship" else set())
    assert set(got["parts"]) == want
    assert all(h > 0 and d is None for h, d in got["parts"].values())
    assert sum(h for h, _ in got["parts"].values()) <= got["paths"]["forward"][0]
