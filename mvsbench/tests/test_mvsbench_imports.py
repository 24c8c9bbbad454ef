"""What the benchmark runs imports: no module of the harness or of the port
imports jax, jaxlib, flax or the JAX package mvsformerplusplus_tpu (each
module's top-level name compared whole, since the port's name begins with
the JAX package's), and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mvsformerplusplus_tpu"}


def imported_tops(path: Path) -> set:
    """Top-level names of every absolute import in a source file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(*dirs):
    return sorted(p for d in dirs for p in (REPO / d).rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources("mvsbench", "mvsformerplusplus_tpu_torch"),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((REPO / "mvsbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "mvsformerplusplus_tpu_torch" not in imported_tops(path)
    assert not imported_tops(path) & FORBIDDEN


def test_top_level_names_are_compared_whole():
    assert "mvsformerplusplus_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "mvsformerplusplus_tpu.models".split(".", 1)[0] in FORBIDDEN


def test_loaded_modules_after_reference_and_port():
    """In a fresh process: the reference loads nothing of the port, and the
    reference, the harness and the port together load nothing forbidden."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import mvsbench.reference.model, mvsbench.counts\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == "
            "'mvsformerplusplus_tpu_torch'], 'reference loaded the port'\n"
            "import mvsbench.run, mvsbench.loops.eval, mvsbench.check\n"
            "import mvsformerplusplus_tpu_torch.config\n"
            "import mvsformerplusplus_tpu_torch.models.mvsformer\n"
            "from mvsbench.harness import forbidden_modules\n"
            "print(forbidden_modules())\n") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
