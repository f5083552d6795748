"""Find the highest clip rate the server sustains (the knee), on the card.

One process sets the open-loop cell up once, then runs a window at each
rate, the cell's traffic file with its ``rate_per_s`` replaced, and prints
one JSON line a rate: the clips due, the median and 95th-percentile
latency, and whether the backlog grew through the window (the mean
latency of the window's last third over its first third, and the last
clip's). The knee is the highest rate whose backlog did not grow; the
cell's rate is written into its traffic file as 0.8 of it.

    python3 -m bench_port.tools.sweep --workload bdd416-clips-open \\
        --rates 20 30 40 50 --seconds 10 [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from bench_port.harness.cell import prepare
from bench_port.harness.readers import percentile
from bench_port.harness.spec import load_cell
from bench_port.harness.traffic import schedule


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    prep = prepare(cell, args.seed, torch.device("cuda", 0))
    for rate in args.rates:
        traffic = {**cell.traffic, "rate_per_s": rate}
        window = prep.server.serve(schedule(traffic, args.seed, args.seconds), args.seconds,
                                   closed=False)
        reqs = [r for r in window["issued"] + window["unissued"]]
        lat = [((r.done if r.done == r.done else float("inf")) - r.due) * 1e3 for r in reqs]
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate_per_s": rate, "clips": len(lat),
            "frames_per_s": sum(r.size for r in reqs) / args.seconds,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "first_third_mean_ms": statistics.fmean(lat[:third]),
            "last_third_mean_ms": statistics.fmean(lat[-third:]),
            "last_ms": lat[-1], "unfinished": sum(1 for r in reqs if r.done != r.done)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
