"""What a run may load: no JAX and nothing of the JAX package (compared by
whole top-level names), and a reference that imports nothing of the
program. The command line fails without a card and prints no result."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from bench_port.harness.cell import FORBIDDEN
from bench_port.harness.spec import PACKAGE, REPO

RUN_TINY = """
import json, sys, torch
from pathlib import Path
from bench_port.harness.cell import forbidden_modules, run_cell
from bench_port.tests.tiny_cells import tiny_cell, tiny_root
root = tiny_root(Path(sys.argv[1]))
for name in ("voc352-score-b128", "bdd416-clips-open"):
    run_cell(tiny_cell(root, name), 3, 0.3, False, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mobilenet_yolo_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (PACKAGE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "torch", "numpy"}, path


def test_only_the_system_module_imports_the_program():
    users = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")
             if "mobilenet_yolo_tpu_torch" in _imports(p)}
    assert users <= {"harness/system.py", "tests/test_bench_port_reference.py",
                     "tests/test_bench_port_faults.py"}
    assert not any(_imports(p) & set(FORBIDDEN) for p in PACKAGE.rglob("*.py"))


def test_command_line_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload",
                          "voc352-score-b128", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
