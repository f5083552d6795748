"""A cell's traced window read by the program's own ``myt:`` spans, on the
card.

One process runs the cell once as ``bench_port.run --trace 1`` does (the
traced slice the window's last 4 s, the output check after it), keeps the
trace's events, and prints one JSON line: each stage's device microseconds
a frame and launches a request over the whole requests of the slice, the
readings that ``harness/stages.py`` gives (decode and NMS, neck and
heads), the share of kernel time under a stage span, the stage of every
fused backbone launch, the kernels under ``myt:nms``, the host
milliseconds of a ``bench:req`` span inside the slice, and the run's own
result line. A program without the spans reads None where a number needs
them.

    python3 -m bench_port.tools.spans --workload <name> --seed <n> \\
        [--seconds 12] [--out spans.jsonl]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from unittest import mock

import torch

from bench_port.harness import stages as st
from bench_port.harness import trace
from bench_port.harness.cell import run_cell
from bench_port.harness.spec import load_cell

# the kernels metrics/fused_roofline.*.py match
FUSED = ("fused_stem_kernel", "fused_block_f32_kernel", "fused_block_bf16_kernel")


def read(events: list[dict]) -> dict:
    """The line's numbers from a traced window's events."""
    stages = st.reduce(events)
    summary = trace.summarise(events)
    reqs = list(stages.requests.values())
    frames = sum(r["frames"] for r in reqs)
    table = {}
    for r in reqs:
        for name, (sec, n) in r["stages"].items():
            row = table.setdefault(name, [0.0, 0])
            row[0] += sec
            row[1] += n
    by_stage = {name: {"us_per_frame": sec / frames * 1e6, "launches_per_request": n / len(reqs)}
                for name, (sec, n) in sorted(table.items())} if reqs else {}
    fused = {stage: sum(n for k, (_, n) in kernels.items() if any(p in k for p in FUSED))
             for stage, kernels in stages.kernels.items()}
    nms = {k: {"ms_per_request": sec / len(reqs) * 1e3, "launches": n}
           for k, (sec, n) in stages.kernels.get("myt:nms", {}).items()} if reqs else {}
    in_slice = [e["dur"] * 1e-6 for e in events
                if e.get("cat") == "user_annotation" and trace.REQ.match(e["name"])
                and int(trace.REQ.match(e["name"]).group(1)) in stages.requests]
    return {
        "requests": len(reqs), "frames": frames, "window_s": summary.window_s,
        "idle_share": 100.0 * (1.0 - summary.busy_s / summary.window_s),
        "launches_per_request": sum(len(r["kernels"]) for r in summary.requests.values())
        / max(1, len(summary.requests)),
        "decode_nms_us": st.decode_nms_us(stages), "neck_heads_us": st.neck_heads_us(stages),
        "leaf_share": st.leaf_share(stages), "unlaunched": stages.unlaunched,
        "stages": by_stage, "fused_launches_by_stage": {k: v for k, v in fused.items() if v},
        "nms_kernels": nms,
        "bench_req_ms_traced": statistics.fmean(in_slice) * 1e3 if in_slice else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    kept, summarise = [], trace.summarise

    def keeping(events):
        kept.append(events)
        return summarise(events)

    with mock.patch.object(trace, "summarise", keeping):
        result = run_cell(load_cell(args.workload), args.seed, args.seconds, True, device)
    line = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
            "device": torch.cuda.get_device_name(device), **read(kept[-1]), "result": result}
    text = json.dumps(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
