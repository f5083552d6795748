"""Post-training int8 quantization CLI (the KL720-port analog).

Port of the JAX package's ``tools/quantize.py``, with the same flags and
report keys (``mobilenet_yolo_tpu_torch/quant.py`` has the algorithm):
fold BN, quantize every ConvBNAct kernel per output channel, calibrate
activation ranges on the test record store (or random data), write the
int8 artifact (the JAX package's key layout: either package loads it), and
optionally A/B float vs simulated-int8 mAP through the shared evaluation
loop (``eval/evaluator.py:evaluate_detection``). Both arms run the folded
weights through the per-layer modules.

Usage:
    python -m mobilenet_yolo_tpu_torch.tools.quantize --checkpoint <ckptdir|params.npz> \\
        --data-yaml <data.yaml> --out model_int8.npz [--calib-batches 4] [--eval]

``--checkpoint`` is read as ``cli/infer.py`` reads it: a checkpoint
directory of the port's trainer (its served weights), a ``.npz``, or
nothing with ``--random-weights`` (the seeded init). The model runs on
``--device`` (default ``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import copy
import json
import os

from mobilenet_yolo_tpu_torch.config import default_data_yaml


def main(argv=None):
    parser = argparse.ArgumentParser(description="int8 PTQ")
    parser.add_argument("--checkpoint", default="checkpoint")
    parser.add_argument("--data-yaml", dest="data_yaml", default=default_data_yaml())
    parser.add_argument("--backbone", default="mbv2", choices=["mbv2", "mbv3", "mbv3_macc"])
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--calib-batches", default=4, type=int,
                        help="calibration batches from the test record store (random images "
                             "if it is unavailable)")
    parser.add_argument("--random-weights", action="store_true")
    parser.add_argument("--eval", action="store_true",
                        help="A/B float vs simulated-int8 mAP on the test set (the "
                             "evaluation of cli/eval.py)")
    parser.add_argument("--val-conf", default=0.3, type=float)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from mobilenet_yolo_tpu_torch import quant
    from mobilenet_yolo_tpu_torch.cli.infer import load_variables
    from mobilenet_yolo_tpu_torch.config import load_config
    from mobilenet_yolo_tpu_torch.models import build_model
    from mobilenet_yolo_tpu_torch.tools import tool_device

    device = tool_device(args.device)
    cfg = load_config(args.data_yaml)
    mc = cfg.model
    h, w = mc["img_h"], mc["img_w"]
    model = build_model(mc, args.backbone, device=device,
                        generator=torch.Generator().manual_seed(0))
    model = load_variables(model, args.checkpoint, random_ok=args.random_weights)
    folded = quant.per_layer_folded(model)

    qkernels, wscales = quant.quantize_weights(folded)

    # calibration batches: the test record store when present, else random
    loader = _test_loader(args, cfg)
    batches = []
    if loader is not None:
        for batch in loader:
            batches.append(batch["images"])
            if len(batches) >= args.calib_batches:
                break
    if not batches:
        rng = np.random.default_rng(0)
        batches = [rng.normal(0, 0.25, size=(args.batch_size, h, w, 3)).astype(np.float32)
                   for _ in range(args.calib_batches)]
        print("calibration: test record store unavailable, using "
              f"{args.calib_batches} random batches")

    fq = copy.deepcopy(folded)
    fq.load_state_dict(quant.fake_quant_state(folded.state_dict(), qkernels, wscales))
    act_scales = quant.calibrate_activations(fq, batches)
    quant.save_int8(args.out, folded.state_dict(), qkernels, wscales, act_scales)
    n_int8 = sum(int(q.size) for q in qkernels.values())
    n_total = sum(p.numel() for p in folded.parameters())
    report = {"sites": len(qkernels), "int8_weights": n_int8, "total_params": n_total,
              "int8_fraction": round(n_int8 / n_total, 4), "out": args.out}

    if args.eval:
        report.update(_eval_ab(args, cfg, folded, quant.QuantSim(fq, act_scales), device))
    print(json.dumps(report, indent=2))
    return report


def _test_loader(args, cfg):
    from mobilenet_yolo_tpu_torch.config import load_yaml
    from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
    from mobilenet_yolo_tpu_torch.data.records import RecordReader

    data_cfg = load_yaml(args.data_yaml)
    path = (data_cfg.get("test_dataset_path") or {}).get("lmdb")
    if not path or not os.path.exists(path):
        return None
    mc = cfg.model
    seg_nc = int(data_cfg.get("segmentation_num_classes", 0))
    ds = DetectionDataset(RecordReader(path), phase="test", has_seg=cfg.segmentation_enabled,
                          seg_num_classes=seg_nc)
    norm = mc.get("normalize", {"mean": [0.5] * 3, "std": [1.0] * 3})
    return Loader(ds, args.batch_size, [[mc["img_w"], mc["img_h"]]], norm["mean"], norm["std"],
                  shuffle=False, pad_final=False)


def _eval_ab(args, cfg, folded, sim, device):
    from mobilenet_yolo_tpu_torch.eval import make_predict_fn
    from mobilenet_yolo_tpu_torch.eval.evaluator import evaluate_detection

    mc = cfg.model
    top_k = int(mc.get("nms_top_k", 512))
    results = {}
    for tag, model in (("float", folded), ("int8", sim)):
        loader = _test_loader(args, cfg)
        if loader is None:
            return {"eval": "skipped (no test record store)"}
        predict = make_predict_fn(model, mc, top_k=top_k)
        res = evaluate_detection(predict, loader, cfg.classes, args.val_conf,
                                 batch_size=args.batch_size, device=device)
        results[f"mAP_{tag}"] = res["mAP"]
    results["mAP_drop"] = results["mAP_float"] - results["mAP_int8"]
    return results


if __name__ == "__main__":
    main()
