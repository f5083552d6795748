"""Find a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are found by those names, so a later cell, configuration, traffic mix or
metric is a data entry plus new files, never an edit here:

* a configuration: the ``file`` that ``BENCHMARK.json`` gives it, whose
  ``reference`` key names ``reference/<name>.py``; its output limits are
  ``limits/<configuration>.json``;
* a traffic mix: ``traffic/<traffic>.json``, read by ``harness/traffic.py``;
* a metric: ``metrics/<metric>.py``, which defines ``read(run)`` and
  returns a number or None (nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

PACKAGE = Path(__file__).resolve().parents[1]
REPO = PACKAGE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path

    def reference(self):
        """The configuration's plain reference module."""
        name = self.config["reference"]
        path = self.root / "reference" / f"{name}.py"
        return _load(path, f"bench_port.reference.{name}")

    def reader(self, metric: str) -> Callable:
        return _load(self.root / "metrics" / f"{metric}.py", f"bench_port_metric_{metric}").read


def _load(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str, moves_ok: bool = True) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_ok


def load_cell(workload: str, benchmark: Path | None = None, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``benchmark`` (default: the checkout's
    ``BENCHMARK.json``), its files looked up under ``root`` (default: this
    package; a configuration's ``file`` is relative to the benchmark's
    directory)."""
    benchmark = benchmark or REPO / "BENCHMARK.json"
    root = root or PACKAGE
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((benchmark.parent / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "limits" / f"{w['config']}.json"
    limits = json.loads(limits_path.read_text())["limits"]
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload, m["moves"] in names)]
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic,
                limits, e2e, per_layer, root)
