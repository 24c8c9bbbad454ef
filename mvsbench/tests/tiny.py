"""A copy of the harness with a tiny configuration and tiny traffic mixes
added as files only (no file of the harness edited), and a function that runs
one of its cells on the CPU in a child process, as the command runs it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HARNESS = REPO / "mvsbench"

TINY_ARGS = dict(
    feat_chs=[4, 8, 16, 32], vit_ch=48, vit_depth=3, vit_num_heads=2, out_ch=32,
    ndepths=[8, 4, 4, 4], base_ch=[4, 4, 4, 4],
    dino_cfg=dict(cross_interval_layers=3, decoder_cfg=dict(
        d_model=48, nhead=2, attention_type="Linear", softmax_scale="entropy_invariance",
        train_avg_length=762, prev_values=0.5, init_values=1.0, pre_norm_query=True)),
    FMT_config=dict(attention_type="Linear", d_model=32, nhead=2,
                    layer_names=["self", "cross", "self", "cross"],
                    softmax_scale="entropy_invariance", train_avg_length=12185, init_values=1.0,
                    pre_norm_query=False),
    transformer_config=[dict(mid_channel=16, num_heads=2, down_rate=[2, 4, 4], mlp_ratio=2,
                             layer_num=2, position_encoding=True,
                             softmax_scale="entropy_invariance", train_avg_length=12185,
                             use_pe_proj=True)],
    cost_reg_type=["PureTransformerCostReg", "Normal", "Normal", "Normal"], use_pe3d=True)
TINY_MIX = dict(views=3, height=64, width=128, ndepths=48, depth_interval=10.0, texture=64)


def tiny_config() -> dict:
    cfg = json.loads((HARNESS / "configs" / "mvsformerpp.json").read_text())
    cfg["name"] = "tiny"
    cfg["dtype"] = "float32"
    cfg["config"]["arch"]["args"].update(TINY_ARGS)
    return cfg


def make_copy(root: Path) -> Path:
    """root/ holding BENCHMARK.json and mvsbench/ with the tiny files added."""
    shutil.copytree(HARNESS, root / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    h = root / "mvsbench"
    (h / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    ev = json.loads((h / "traffic" / "dtu_eval.json").read_text())
    ev.update(TINY_MIX, pool=3, compare=2, p90_min_maps=3)
    (h / "traffic" / "tiny_eval.json").write_text(json.dumps(ev))
    (h / "limits" / "tiny.eval.json").write_text(
        (h / "limits" / "mvsformerpp.dtu_eval.json").read_text())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests", "file":
                             "mvsbench/configs/tiny.json", "reduced": [], "why": "tests"})
    bench["workloads"].append(
        {"name": "tiny.eval", "config": "tiny", "traffic": "tiny_eval", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.eval")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, cell: str, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: int = 0, prelude: str = "", timeout: int = 600):
    """The command on the CPU in a child process from `root`; `prelude` is
    Python run first (a fault planted in the program). Returns the
    CompletedProcess and the parsed last line (or None)."""
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n{prelude}\n"
            "from mvsbench import run\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', "
            f"'{seconds}', '--trace', '{trace}'], device='cpu'))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=timeout, env=env)
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc, last
