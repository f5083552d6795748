"""Standalone mAP evaluation CLI (reference ``train.py --evaluate``; port of
``mobilenet_yolo_tpu/cli/eval.py``):

    python -m mobilenet_yolo_tpu_torch.cli.eval -y <data.yaml> -c <ckptdir>

Runs the SAME evaluation driver as ``Trainer.evaluate``
(eval/evaluator.py:evaluate_detection), so the VOC protocol — difficult-GT
handling (reference eval_mAP.py:8-67), the model yaml's ``nms_top_k``
horizon, segmentation mIoU for multi-task checkpoints — cannot drift
between the training-loop eval and this CLI. A checkpoint directory
restores the training run's adapted ``val_conf`` (the reference's feedback
controller state, train.py:434-440) unless ``--val-conf`` overrides it,
and the averaged weights where the run kept them. ``-c`` may also name a
``.npz`` of the JAX package's variables. The model runs on ``--device``
(default ``cuda``, which raises without a card).

Launched as several processes by ``torchrun`` (one a device), ``--mesh``
(default ``auto``: every rank on the data axis) shards the eval: every rank
reads the whole test set and runs its rows of each batch, and every rank
gets the same mAP; rank 0 prints it.
"""

from __future__ import annotations

import argparse
import json
import os

from mobilenet_yolo_tpu_torch.config import default_data_yaml


def main(argv=None):
    parser = argparse.ArgumentParser(description="YOLO mAP evaluation")
    parser.add_argument("-y", "--data_yaml", dest="data_yaml",
                        default=default_data_yaml())
    parser.add_argument("-c", "--checkpoint", default="checkpoint")
    parser.add_argument("--backbone", default="mbv2",
                        choices=["mbv2", "mbv3", "mbv3_macc"])
    parser.add_argument("--val-conf", default=None, type=float,
                        help="confidence gate; default: the checkpoint's "
                             "adapted val_conf (0.1 when unavailable)")
    parser.add_argument("--batch-size", default=32, type=int)
    parser.add_argument("--mesh", default="auto", type=str,
                        help="device mesh spec (see cli/train.py --mesh); "
                             "'auto' shards the eval batch over every rank "
                             "of a torchrun job")
    parser.add_argument("--random-weights", action="store_true")
    parser.add_argument("--coco-ap", action="store_true",
                        help="also report COCO-protocol AP@[.5:.95]/AP50/"
                             "AP75 (beyond-reference; ops/coco_ap.py)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mobilenet_yolo_tpu_torch.cli.infer import load_variables
    from mobilenet_yolo_tpu_torch.config import load_config, load_yaml
    from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
    from mobilenet_yolo_tpu_torch.data.records import RecordReader
    from mobilenet_yolo_tpu_torch.eval import make_predict_fn
    from mobilenet_yolo_tpu_torch.eval.evaluator import evaluate_detection
    from mobilenet_yolo_tpu_torch.models import build_model
    from mobilenet_yolo_tpu_torch.parallel import initialize_distributed, mesh_from_spec
    from mobilenet_yolo_tpu_torch.parallel.mesh import is_primary, rank_device
    from mobilenet_yolo_tpu_torch.parallel.sharding import shard_over_model_axis
    from mobilenet_yolo_tpu_torch.tools import tool_device

    device = tool_device(args.device)
    # a torchrun job joins its group (a no-op for one process)
    initialize_distributed(device=device)
    device = rank_device(device)
    cfg = load_config(args.data_yaml)
    mc = cfg.model
    model = build_model(mc, args.backbone, device=device,
                        generator=torch.Generator().manual_seed(0))

    val_conf = args.val_conf
    if os.path.isdir(args.checkpoint) and not args.random_weights:
        # the full saved state: weights (the average where the run kept
        # one, like the trainer evaluated) AND the adapted val_conf
        from mobilenet_yolo_tpu_torch.train.checkpoints import (CheckpointManager,
                                                                served_state_dict)
        raw = CheckpointManager(args.checkpoint).restore_latest_raw()
        if raw is None:
            raise FileNotFoundError(
                f"no checkpoint found at {args.checkpoint}")
        model.load_state_dict(served_state_dict(raw), strict=True)
        if val_conf is None:
            val_conf = float(raw["val_conf"])
    else:
        model = load_variables(model, args.checkpoint, random_ok=args.random_weights)
    if val_conf is None:
        val_conf = 0.1

    mesh = mesh_from_spec(args.mesh)
    if mesh is not None:
        shard_over_model_axis(model, mesh)
    # same NMS horizon as the Trainer (TrainerConfig.nms_top_k semantics:
    # the reference's ragged pipeline has no cap, utils/box.py:11-31)
    predict = make_predict_fn(model, mc, top_k=int(mc.get("nms_top_k", 512)), mesh=mesh)

    data_cfg = load_yaml(args.data_yaml)
    seg_nc = int(data_cfg.get("segmentation_num_classes", 0))
    ds = DetectionDataset(
        RecordReader(data_cfg["test_dataset_path"]["lmdb"]), phase="test",
        has_seg=cfg.segmentation_enabled, seg_num_classes=seg_nc)
    norm = mc["normalize"]
    loader = Loader(ds, args.batch_size, [[mc["img_w"], mc["img_h"]]],
                    norm["mean"], norm["std"], shuffle=False,
                    pad_final=False)

    res = evaluate_detection(predict, loader, cfg.classes, val_conf,
                             batch_size=args.batch_size, coco_ap=args.coco_ap,
                             device=device, mesh=mesh)
    out = {"mAP": res["mAP"], "APs": res["aps"],
           "val_conf": val_conf}
    if res["seg_miou"] is not None:
        out["seg_mIoU"] = float(res["seg_miou"])
    if args.coco_ap:
        out["coco"] = res["coco"]
    if is_primary():
        print(json.dumps(out, indent=2))
    return res["mAP"]


if __name__ == "__main__":
    main()
