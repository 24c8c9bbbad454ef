"""On a card: each cell's command for a short window from the repository's
root prints the contract's last line with `correct` true, and its traced
run the per-layer metrics. Skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from mvsbench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", cell, "--seed",
                           "2147483777", "--seconds", "3", "--trace", str(trace)], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
    if trace:
        assert 0 < last["device"]["busy_s"] <= last["device"]["window_s"]
