"""Channel-pruning CLI (Network Slimming; ``prune.py`` has the algorithm).

Port of the JAX package's ``tools/prune.py``, with the same flags and
artifacts: rank the prunable channels by BatchNorm |gamma| (ideally after
training with ``--slim-l1``), cut the global bottom ``--ratio`` fraction,
and write what a fine-tune needs:

    <out>/params.npz   — the sliced weights in the JAX package's flat .npz
                         format (``tools_io``), read by ``--init-from`` of
                         either package's train CLI
    <out>/model.yaml   — the model config plus the ``prune:`` block of the
                         slimmed widths (``models.build_model``)
    <out>/data.yaml    — the data yaml re-pointed at model.yaml (with -y)
    <out>/summary.json — per-site kept/total, parameter counts and the
                         gamma concentration

Usage:
    python -m mobilenet_yolo_tpu_torch.tools.prune -y <data.yaml> \\
        -c <ckptdir|params.npz> --ratio 0.3 --out pruned/
    python -m mobilenet_yolo_tpu_torch.cli.train -y pruned/data.yaml \\
        --init-from pruned/params.npz -c pruned_ck   # fine-tune

``-c`` is a checkpoint directory of the port's trainer, whose served
weights (the average where the run kept one) are pruned, or an ``.npz``.
The rebuilt slim model must load the sliced weights with ``strict=True``.
A config that already carries a ``prune:`` block is refused. The model is
loaded on ``--device`` (default ``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="YOLO channel pruning (Network Slimming)")
    parser.add_argument("-y", "--data_yaml", dest="data_yaml", default=None)
    parser.add_argument("--model-yaml", default=None,
                        help="model config path (alternative to -y when there is no "
                             "data yaml, e.g. synthetic runs)")
    parser.add_argument("-c", "--checkpoint", required=True,
                        help="checkpoint directory of the port's trainer or params .npz")
    parser.add_argument("--backbone", default="mbv2", choices=["mbv2", "mbv3", "mbv3_macc"])
    parser.add_argument("--ratio", default=0.3, type=float,
                        help="global fraction of prunable channels to cut")
    parser.add_argument("--min-keep", default=8, type=int)
    parser.add_argument("--round-to", default=8, type=int,
                        help="round kept counts up to this multiple (8 default)")
    parser.add_argument("--no-head", action="store_true",
                        help="leave the backbone head conv unpruned")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--dry-run", action="store_true",
                        help="print the plan, write nothing")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    if bool(args.data_yaml) == bool(args.model_yaml):
        parser.error("give exactly one of -y/--data_yaml or --model-yaml")

    import yaml

    from mobilenet_yolo_tpu_torch.cli.infer import load_variables
    from mobilenet_yolo_tpu_torch.config import load_config, load_yaml
    from mobilenet_yolo_tpu_torch.convert import state_dict_to_flax
    from mobilenet_yolo_tpu_torch.models import build_model
    from mobilenet_yolo_tpu_torch.prune import (apply_prune, param_count, plan_prune,
                                                prunable_gammas)
    from mobilenet_yolo_tpu_torch.tools import tool_device
    from mobilenet_yolo_tpu_torch.tools_io import save_params_npz

    device = tool_device(args.device)
    model_cfg = load_config(args.data_yaml).model if args.data_yaml else load_yaml(args.model_yaml)
    if model_cfg.get("prune"):
        raise SystemExit("the model config already carries a 'prune:' block — iterative "
                         "pruning of an already-pruned model is not supported (re-prune "
                         "the original)")

    model = load_variables(build_model(model_cfg, args.backbone, device=device),
                           args.checkpoint)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    keep = plan_prune(state, args.ratio, min_keep=args.min_keep, round_to=args.round_to,
                      include_head=not args.no_head)
    gammas = prunable_gammas(state, include_head=not args.no_head)
    rows = []
    for site in keep:
        rows.append({"site": site, "kept": int(keep[site].size),
                     "total": int(gammas[site].size)})
        print(f"{site:>12}: keep {rows[-1]['kept']:4d} / {rows[-1]['total']:4d}")

    # concentration: the share of the total |gamma| mass in the channels
    # being cut; a slimming-trained model shows a small bottom mass
    allg = np.sort(np.concatenate([np.abs(g).ravel() for g in gammas.values()]))
    cut = int(allg.size * args.ratio)
    bottom_mass = float(allg[:cut].sum() / max(allg.sum(), 1e-12))
    gamma_stats = {
        "channels": int(allg.size),
        "cut_fraction": args.ratio,
        "bottom_mass_fraction": bottom_mass,
        "p10": float(np.percentile(allg, 10)),
        "median": float(np.median(allg)),
        "p90": float(np.percentile(allg, 90)),
    }
    print(f"gamma concentration: bottom {args.ratio:.0%} of {allg.size} channels hold "
          f"{100 * bottom_mass:.2f}% of total |gamma| mass (p10 {gamma_stats['p10']:.4f}, "
          f"median {gamma_stats['median']:.4f}, p90 {gamma_stats['p90']:.4f})")

    new_state, prune_cfg = apply_prune(state, keep)
    pruned_cfg = copy.deepcopy(model_cfg)
    pruned_cfg["prune"] = prune_cfg
    # the slim graph must take exactly the sliced weights
    pruned_model = build_model(pruned_cfg, args.backbone, device=device)
    pruned_model.load_state_dict(new_state, strict=True)
    before, after = param_count(model), param_count(pruned_model)
    print(f"params: {before:,} -> {after:,} ({100.0 * (1 - after / before):.1f}% cut)")

    if args.dry_run:
        print("dry run: nothing written")
        return

    os.makedirs(args.out, exist_ok=True)
    flax = state_dict_to_flax(new_state)
    save_params_npz(os.path.join(args.out, "params.npz"), flax["params"], flax["batch_stats"])
    model_yaml_out = os.path.join(args.out, "model.yaml")
    with open(model_yaml_out, "w") as f:
        yaml.safe_dump(pruned_cfg, f, sort_keys=False)
    if args.data_yaml:
        data_cfg = load_yaml(args.data_yaml)
        data_cfg["model_config_path"] = os.path.abspath(model_yaml_out)
        with open(os.path.join(args.out, "data.yaml"), "w") as f:
            yaml.safe_dump(data_cfg, f, sort_keys=False)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"sites": rows, "params_before": before, "params_after": after,
                   "ratio": args.ratio, "gamma_stats": gamma_stats}, f, indent=2)
    print(f"wrote {args.out}/{{params.npz, model.yaml"
          + (", data.yaml" if args.data_yaml else "") + ", summary.json}")


if __name__ == "__main__":
    main()
