"""The harness as its command runs, on the CPU at tiny widths: every cell
found by name; a configuration, a traffic mix and a per-layer metric added
as files only; the last line's keys; each loop through the port and the
reference; runs that report no result; and runs whose timed path is broken
underneath, which come out not correct."""
from __future__ import annotations

import json

import pytest

from mvsbench.tests.tiny import HARNESS, REPO, make_copy, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_found_by_name(cell):
    traffic = json.loads((HARNESS / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HARNESS / "configs" / f"{cell['config']}.json").is_file()
    assert (HARNESS / "loops" / f"{traffic['loop']}.py").is_file()
    limits = json.loads((HARNESS / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    reported = [m for m in BENCH["per_layer"] if cell["name"] in m["workloads"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and reported
    for m in reported:
        assert (HARNESS / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e


def test_config_files_hold_the_repo_configs():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["config"] == json.loads((REPO / cfg["assumed"]["config_file"]).read_text())


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = make_copy(tmp_path_factory.mktemp("bench"))
    (root / "mvsbench" / "metrics" / "served.eval.py").write_text(
        "def read(run):\n    return float(run.units) if run.kind == 'eval' else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "served.eval", "unit": "maps", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "maps_per_s",
                               "workloads": ["tiny.eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _ok(proc, last):
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert last is not None and list(last)[:5] == KEYS and list(last)[-1] == "checks"
    return last


def test_eval_cell_added_as_files(copy):
    last = _ok(*run_cell(copy, "tiny.eval", seconds=2.0))
    assert last["correct"] is True and last["attempted"] >= 3 and last["failed"] == 0
    assert set(last["metrics"]) == {"maps_per_s", "peak_mem_gb", "setup_s"}
    assert set(last["checks"]) == set(json.loads(
        (HARNESS / "limits" / "mvsformerpp.dtu_eval.json").read_text()))


def test_metric_added_as_a_file(copy):
    last = _ok(*run_cell(copy, "tiny.eval", seconds=1.0, trace=1))
    assert last["metrics"]["served.eval"]["value"] == last["attempted"]
    assert "launches.eval" not in last["metrics"]  # no device trace on the CPU
    # the host-clock readings that stand per layer where their spread is too wide for a bound
    assert last["metrics"]["maps_per_s.tt"]["value"] > 0
    if last["attempted"] >= 3:  # the tiny mix's p90_min_maps
        assert last["metrics"]["map_ms_p90.eval"]["value"] > 0


ALTERED = """
import mvsformerplusplus_tpu_torch.models.cascade as c
_fwd = c.CascadeDepth.forward
def forward(self, *a, **k):
    out = _fwd(self, *a, **k)
    out["refined_depth"] = out["refined_depth"] * 1.05
    return out
c.CascadeDepth.forward = forward
"""
LOGITS_ALTERED = """
import mvsformerplusplus_tpu_torch.models.cascade as c
_fwd = c.CascadeDepth.forward
def forward(self, *a, **k):
    out = _fwd(self, *a, **k)
    pre = out["stage2"]["prob_volume_pre"]
    out["stage2"]["prob_volume_pre"] = pre + pre.float().std().to(pre.dtype)
    return out
c.CascadeDepth.forward = forward
"""


@pytest.mark.parametrize("fault", [ALTERED, LOGITS_ALTERED],
                         ids=["answer_altered", "logits_altered"])
def test_broken_timed_path_is_not_correct(copy, fault):
    proc, last = run_cell(copy, "tiny.eval", seconds=1.0, prelude=fault)
    last = _ok(proc, last)
    assert last["correct"] is False
    assert "FAILED" in proc.stderr.strip().splitlines()[-1] or "FAILED" in proc.stderr


def test_no_card_no_result(tmp_path):
    import subprocess
    import sys

    root = make_copy(tmp_path)
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n"
            "from mvsbench import run\nsys.exit(run.main(['--workload', 'tiny.eval', "
            "'--seed', '1', '--seconds', '1']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3 and proc.stdout == ""


def test_bare_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the harness (no program)."""
    import shutil
    import subprocess
    import sys

    shutil.copytree(HARNESS, tmp_path / "mvsbench", ignore=shutil.ignore_patterns("tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}]\n"
            "from mvsbench import run\nsys.exit(run.main(['--workload', "
            "'mvsformerpp.dtu_eval', '--seed', '1', '--seconds', '1'], device='cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
