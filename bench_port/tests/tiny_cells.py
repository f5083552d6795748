"""Tiny copies of the benchmark's cells for CPU tests.

``tiny_root(tmp)`` writes a benchmark directory: a ``BENCHMARK.json``
with the real cells' names, metrics and limits, whose configurations are
the real ones at 64x64 frames and whose traffic sends requests of 2-4
frames, plus copies of the metric readers and references. The harness
finds all of it by name, as it finds the real files.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench_port.harness.spec import PACKAGE, REPO, load_cell

SIZE = 64
TRAFFIC = {
    "score-b128": {"arrival": "closed", "in_flight": 2, "sizes": [4], "shares": [1],
                   "pool_frames": 16, "offset_step": 4},
    "clips-open": {"arrival": "poisson", "rate_per_s": 4.0, "in_flight": 2, "sizes": [2, 4],
                   "shares": [1, 1], "pool_frames": 16, "offset_step": 1},
}


def tiny_root(tmp: Path) -> Path:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("metrics", "reference", "limits"):
        shutil.copytree(PACKAGE / sub, tmp / sub)
    (tmp / "configs").mkdir()
    (tmp / "traffic").mkdir()
    for c in spec["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        config["img_h"] = config["img_w"] = SIZE
        c["file"] = f"configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(config))
    for w in spec["workloads"]:
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(TRAFFIC[w["traffic"]]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def tiny_cell(root: Path, workload: str):
    return load_cell(workload, root / "BENCHMARK.json", root)
