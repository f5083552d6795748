"""A new configuration, traffic mix and metric are files found by name:
nothing in the harness is edited to add them."""

from __future__ import annotations

import json

from bench_port.harness.spec import load_cell
from bench_port.harness.traffic import schedule
from bench_port.tests.tiny_cells import tiny_root


def test_throwaway_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / spec["configs"][0]["file"]).read_text())
    (root / "configs" / "throwaway.json").write_text(json.dumps({**base, "img_h": 32,
                                                                 "img_w": 32}))
    spec["configs"].append({"name": "throwaway", "source": "https://example.org/x",
                            "file": "configs/throwaway.json", "reduced": ["img_h", "img_w"],
                            "why": "test"})
    (root / "limits" / "throwaway.json").write_text(json.dumps({"limits": {"det_gap": 9.0}}))
    (root / "traffic" / "bursty.json").write_text(json.dumps(
        {"arrival": "poisson", "rate_per_s": 3.0, "in_flight": 1, "sizes": [3],
         "pool_frames": 8, "burst": {"on_s": 1.0, "off_s": 1.0}}))
    (root / "metrics" / "throwaway_count.py").write_text(
        "def read(run):\n    return float(len(run))\n")
    spec["workloads"].append({"name": "throwaway.bursty", "config": "throwaway",
                              "traffic": "bursty", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "throwaway_count", "unit": "n", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["throwaway.bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("throwaway.bursty", root / "BENCHMARK.json", root)
    assert cell.config["img_h"] == 32 and cell.limits == {"det_gap": 9.0}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "throwaway_count"]
    assert cell.per_layer == []
    assert cell.reader("throwaway_count")([1, 2, 3]) == 3.0
    assert cell.reference().__name__.endswith("mbv2_yolo")
    reqs = list(schedule(cell.traffic, 1, 4.0))
    assert len(reqs) == 6 and all(r.size == 3 for r in reqs)


def test_real_cells_take_their_metrics():
    cell = load_cell("voc352-score-b128")
    assert {m["name"] for m in cell.end_to_end} == {"score_img_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "idle_share.score", "mfu.score", "fused_roofline.score", "enqueue_ms.score"}
    cell = load_cell("bdd416-clips-open")
    assert {m["name"] for m in cell.end_to_end} == {"clip_p95_ms", "setup_s"}
    assert len(cell.per_layer) == 6
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
