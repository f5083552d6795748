"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
output check compared, beside its limit); the last lines of standard error
give the same checks. Without as many CUDA devices as the cell asks for it
exits with code 2 and prints no result; any other failure exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch

        from bench_port.harness.cell import run_cell
        from bench_port.harness.spec import load_cell

        # one process with few threads: the window's host work is one thread's
        torch.set_num_threads(1)
        cell = load_cell(args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"bench_port: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
                  file=sys.stderr)
            return 2
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
