"""torch models: the MobileNetV2 and MobileNetV3 backbones and the YOLO
detector graphs (MBv2-YOLO, MBv3-YOLO, MBv3-YOLO MACC-lite).

Port of ``mobilenet_yolo_tpu/models/__init__.py:23-56``. Modules are NCHW
(run them in ``channels_last`` memory for NHWC-like speed); parameter
names follow the flax variable paths so ``convert.py`` maps weights by path.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO  # noqa: F401
from mobilenet_yolo_tpu_torch.models.mbv3_yolo import MBv3YOLO  # noqa: F401
from mobilenet_yolo_tpu_torch.models.mbv3_yolo_macc import MBv3YOLOMacc  # noqa: F401
from mobilenet_yolo_tpu_torch.models.mobilenetv2 import MobileNetV2  # noqa: F401
from mobilenet_yolo_tpu_torch.models.mobilenetv3 import (  # noqa: F401
    MobileNetV3Large,
    MobileNetV3Small,
)


def build_model(config: dict, backbone: str = "mbv2", dtype=None, *,
                device="cuda", generator: torch.Generator | None = None):
    """Factory keyed on the model-yaml dict (same contract as the JAX
    ``build_model``): ``backbone`` ``mbv2``, ``mbv3`` or ``mbv3_macc``;
    ``yolo.num_classes``/``num_anchors``, the optional ``seg.num_classes``
    head (MBv2), the ``prune:`` width overrides and ``remat`` (recompute the
    backbone blocks in the backward, ``:32-34``). A ``backbone_head`` on
    ``mbv3`` raises the JAX ``ValueError``: its consumer is a width-coupled
    depthwise stack (``prune.py``).

    The model is placed on ``device``, the card unless the caller asks for
    the CPU (``device="cpu"``); without a card the default raises.
    ``generator`` seeds the init, which is drawn on the generator's own
    device and then moved, so one seed gives the same weights on the CPU
    and on the card. ``dtype`` sets the parameters' type. Serving in bf16
    is ``make_predict_fn(..., dtype=torch.bfloat16)``; BatchNorm-folded
    serving is ``make_predict_fn(models.bn_fold.fold_batchnorm(model), ...)``.
    """
    num_classes = config["yolo"]["num_classes"]
    num_anchors = config["yolo"]["num_anchors"]
    seg_classes = config.get("seg", {}).get("num_classes", 0)
    prune_cfg = config.get("prune") or {}
    hidden = prune_cfg.get("backbone_hidden")
    hidden = tuple(hidden) if hidden else None
    head = prune_cfg.get("backbone_head")
    remat = bool(config.get("remat", False))
    if backbone == "mbv2":
        cls, kw = MBv2YOLO, dict(seg_num_classes=seg_classes, backbone_head=head)
    elif backbone == "mbv3":
        if head is not None:
            raise ValueError("backbone_head is not prunable for mbv3 — its"
                             " consumer is a width-coupled depthwise stack"
                             " (see prune.py)")
        cls, kw = MBv3YOLO, {}
    elif backbone == "mbv3_macc":
        cls, kw = MBv3YOLOMacc, dict(backbone_head=head)
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model places the model on the card by default and no CUDA "
                           "device is available; pass device='cpu' to build it on the CPU")
    init_device = generator.device if generator is not None else device
    model = cls(num_classes=num_classes, num_anchors=num_anchors, backbone_hidden=hidden,
                remat=remat, device=init_device, dtype=dtype, generator=generator, **kw)
    return model.to(device)
