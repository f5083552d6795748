"""The readings that the output check's limits are set from, on the card.

For each seed, in one process: the cell as the benchmark runs it (the
program in the configuration's precision), then the control (the same
cell served through the program's bfloat16 path, the precision below the
configuration's float32), each for a short window at the cell's own load
and sizes, each judged by the reference. One JSON line a run:

    python3 -m bench_port.tools.readings --workload <name> --seeds 1 2 3 \\
        [--seconds 4] [--arms program control] [--out chiprun_out/readings.jsonl]

Limits sit above the largest program reading and below the smallest
control reading (``limits/<configuration>.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bench_port.harness.cell import run_cell
from bench_port.harness.spec import load_cell

ARMS = {"program": None, "control": "bfloat16"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--arms", nargs="+", default=list(ARMS), choices=list(ARMS))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for arm in args.arms:
                t = time.perf_counter()
                res = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                               precision=ARMS[arm])
                line = json.dumps({"workload": args.workload, "seed": seed, "arm": arm,
                                   "correct": res["correct"], "attempted": res["attempted"],
                                   "checks": {k: c["value"] for k, c in res["checks"].items()},
                                   "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                                   "seconds": time.perf_counter() - t})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
