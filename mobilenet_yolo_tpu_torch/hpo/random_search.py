"""Local random-search HPO driver over ``search_space.json`` (port of the
repository's ``hpo/random_search.py``; the space is a copy of
``hpo/search_space.json``, shipped as package data).

The reference delegates search to NNI (train.py:487-499 +
models/voc/config.yml experiment): a tuner samples the 8-key space and the
trial merges the parameters into its args. This driver exercises the SAME
seam locally — it samples the NNI-format search space, injects the
overrides through the identical attribute-merge path (the port's
``cli/train.py`` tuner-override contract), records the per-eval
intermediate reports through the ReportHook seam, and writes a per-trial
table:

    python -m mobilenet_yolo_tpu_torch.hpo.random_search \
        -y <data.yaml> --trials 4 --epochs 4 --out trials.json

Each trial trains on ``--device`` (default ``cuda``). Any NNI-format space
file works (``_type`` choice/uniform); plug NNI back in by simply running
``cli/train.py`` under an NNI experiment instead.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np


def sample_params(space: dict, rng: np.random.Generator) -> dict:
    """One draw from an NNI-format search space (choice / uniform)."""
    out = {}
    for key, spec in space.items():
        kind, values = spec["_type"], spec["_value"]
        if kind == "choice":
            out[key] = values[int(rng.integers(len(values)))]
        elif kind == "uniform":
            out[key] = float(rng.uniform(values[0], values[1]))
        else:
            raise ValueError(f"unsupported _type {kind!r} for {key!r}")
    return out


class RecordingReport:
    """ReportHook capturing what an NNI trial would report."""

    def __init__(self):
        self.intermediates: list[float] = []
        self.final_value: float | None = None

    def intermediate(self, value: float) -> None:
        self.intermediates.append(float(value))

    def final(self, value: float) -> None:
        self.final_value = float(value)


def main(argv=None):
    ap = argparse.ArgumentParser(description="local random-search HPO")
    ap.add_argument("-y", "--data_yaml", required=True)
    ap.add_argument("--space", default=str(Path(__file__).parent
                                           / "search_space.json"))
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default="hpo_runs")
    ap.add_argument("--out", default="trials.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from mobilenet_yolo_tpu_torch.cli import train as cli_train

    with open(args.space) as f:
        space = json.load(f)
    rng = np.random.default_rng(args.seed)
    rows = []
    # refuse stale trial dirs UP FRONT (before any training is spent):
    # cli_train would AUTO-RESUME from an old run's checkpoint (zero
    # epochs trained) and record the OLD weights' mAP as the freshly
    # sampled params' score — corrupting the search silently
    stale = [d for d in (os.path.join(args.workdir, f"trial_{t}")
                         for t in range(args.trials))
             if os.path.isdir(d) and os.listdir(d)]
    if stale:
        raise FileExistsError(
            f"{stale[0]} already holds a previous run's checkpoints "
            f"({len(stale)} stale trial dir(s) total); pass a fresh "
            "--workdir (or delete the old one)")
    for trial in range(args.trials):
        params = sample_params(space, rng)
        ckdir = os.path.join(args.workdir, f"trial_{trial}")
        argv_t = ["-y", args.data_yaml, "--epochs", str(args.epochs),
                  "-c", ckdir, "-o", ckdir, "--device", args.device]
        if args.batch_size:
            argv_t += ["--batch-size", str(args.batch_size)]
        targs = cli_train.get_params(argv_t)
        # the tuner-override seam: identical to cli/train.py __main__'s
        # get_tuner_overrides() attribute merge (reference train.py:487-499)
        for k, v in params.items():
            if not hasattr(targs, k):
                raise KeyError(f"search-space key {k!r} is not a cli/train.py flag")
            setattr(targs, k, v)
        report = RecordingReport()
        print(f"--- trial {trial}: {params}", flush=True)
        best = cli_train.main(targs, report=report)
        rows.append({"trial": trial, "params": params,
                     "best_mAP": float(best),
                     "intermediates": report.intermediates,
                     "final_report": report.final_value})
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    best_row = max(rows, key=lambda r: r["best_mAP"])
    print(json.dumps({"best_trial": best_row["trial"],
                      "best_mAP": best_row["best_mAP"],
                      "params": best_row["params"]}, indent=2))
    return rows


if __name__ == "__main__":
    main()
