"""The system under test: the port's folded serving predict.

This is the one module of the harness that imports the program
(``mobilenet_yolo_tpu_torch``), and it takes only what a user of the port
calls: ``build_model``, ``calibrate_bn``, ``fold_batchnorm`` and
``make_predict_fn``.
"""

from __future__ import annotations

import torch

PRECISIONS = {"float32": None, "bfloat16": torch.bfloat16}


def normalised(frames_u8: torch.Tensor, config: dict) -> torch.Tensor:
    """NHWC float32 ``(x / 255 - mean) / std``, the calibration input."""
    norm = config.get("normalize", {"mean": [0.5] * 3, "std": [1.0] * 3})
    mean = torch.tensor(norm["mean"], dtype=torch.float32, device=frames_u8.device)
    std = torch.tensor(norm["std"], dtype=torch.float32, device=frames_u8.device)
    return (frames_u8.to(torch.float32) / 255.0 - mean) / std


def load_program():
    """Import the port's serving entry points."""
    from mobilenet_yolo_tpu_torch.eval import make_predict_fn
    from mobilenet_yolo_tpu_torch.models import build_model
    from mobilenet_yolo_tpu_torch.models.bn_fold import calibrate_bn, fold_batchnorm

    return build_model, calibrate_bn, fold_batchnorm, make_predict_fn


def build_predict(config: dict, weights: dict, calib_u8: torch.Tensor, device,
                  precision: str | None = None, stage=lambda name: None):
    """``predict(frames_u8, val_conf) -> (dets, keep[, seg])`` of the port:
    the model built with ``weights``, BatchNorm calibrated on ``calib_u8``,
    folded, served by ``make_predict_fn(..., normalize=True)`` in
    ``precision`` (default: the configuration's)."""
    build_model, calibrate_bn, fold_batchnorm, make_predict_fn = load_program()
    serving = config["serving"]
    # built where it runs (on meta, the init's normal_ would import
    # torch._dynamo: seconds of set-up), then given the benchmark's weights
    model = build_model(config, backbone=config["backbone"], device=device)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or any(not k.rsplit(".", 1)[-1].startswith(("running_", "num_batches"))
                         for k in missing):
        raise KeyError(f"weights do not fit the port's model: missing {missing}, "
                       f"unexpected {unexpected}")
    stage("build")
    calibrate_bn(model, normalised(calib_u8, config))
    stage("calibrate")
    folded = fold_batchnorm(model)
    del model
    dtype = PRECISIONS[precision or serving["precision"]]
    return make_predict_fn(folded, config, top_k=serving["top_k"],
                           iou_threshold=serving["iou_threshold"], normalize=True, dtype=dtype)
