"""Card tests: each cell through the command line, as the driver runs it,
a short window, untraced and traced. Skipped where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_port.harness.spec import REPO, load_cell

CELLS = ["voc352-score-b128", "bdd416-clips-open"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name, trace):
    out = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload", name,
                          "--seed", str(2**32 + 21), "--seconds", "6", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    cell = load_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
