"""The port's run scripts (mvsformerplusplus_tpu_torch/scripts/*.sh) against
the JAX package's (scripts/*.sh): each is run by bash with `python`
replaced by a recorder, so loops, functions and defaults expand as they
would; every recorded call must give the port's CLI (train or eval) the
JAX call's flags, the scene list file's path aside, and parse with that
CLI's argument parser.
"""
import os
import stat
import subprocess
from pathlib import Path

import pytest

from mvsformerplusplus_tpu_torch.eval import cli as eval_cli
from mvsformerplusplus_tpu_torch.train import cli as train_cli

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ["finetune_blended.sh", "test_dtu.sh", "test_eth3d.sh", "test_tt_adv.sh",
           "test_tt_inter.sh", "train_dtu.sh"]
ENTRY = {"train.py": ("mvsformerplusplus_tpu_torch.train", train_cli),
         "test.py": ("mvsformerplusplus_tpu_torch.eval", eval_cli)}


def _record(script: Path, tmp_path: Path, args, tag: str):
    """The argv of each `python` call the script makes."""
    log = tmp_path / f"{tag}.log"
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text('#!/bin/bash\nprintf "%s\\0" "$@" >> "$PYLOG"\nprintf "\\n\\0" >> "$PYLOG"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", PYLOG=str(log),
               TMPDIR=str(tmp_path))
    text = script.read_text().replace("/tmp/", f"{tmp_path}/")  # the JAX scripts' scene list
    subprocess.run(["bash", "-c", text, script.name, *args], check=True, env=env, cwd=ROOT)
    calls, cur = [], []
    for field in log.read_bytes().split(b"\0")[:-1]:
        if field == b"\n":
            calls.append(cur)
            cur = []
        else:
            cur.append(field.decode())
    return calls


def _without_testlist(argv):
    out = list(argv)
    if "--testlist" in out:
        i = out.index("--testlist")
        out[i + 1] = "<list>"
    return out


@pytest.mark.parametrize("name", SCRIPTS)
def test_port_script_passes_the_jax_scripts_flags(tmp_path, name):
    args = ["ckpt.npz", "data"] if name == "test_eth3d.sh" else []
    jax_calls = _record(ROOT / "scripts" / name, tmp_path, args, "jax")
    port_calls = _record(ROOT / "mvsformerplusplus_tpu_torch" / "scripts" / name, tmp_path, args,
                         "port")
    assert len(port_calls) == len(jax_calls) >= 1
    for port, jax in zip(port_calls, jax_calls):
        module, cli = ENTRY[jax[0]]
        assert port[:2] == ["-m", module]
        assert _without_testlist(port[2:]) == _without_testlist(jax[1:])
        cli.parser().parse_args(port[2:])
