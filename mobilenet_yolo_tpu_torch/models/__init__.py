"""torch models: the MobileNetV2-YOLO detector graph.

Port of ``mobilenet_yolo_tpu/models/__init__.py:23-56``. Modules are NCHW
(run them in ``channels_last`` memory for NHWC-like speed); parameter
names follow the flax variable paths so ``convert.py`` maps weights by path.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO  # noqa: F401
from mobilenet_yolo_tpu_torch.models.mobilenetv2 import MobileNetV2  # noqa: F401


def build_model(config: dict, backbone: str = "mbv2", dtype=None, *,
                device=None, generator: torch.Generator | None = None):
    """Factory keyed on the model-yaml dict (same contract as the JAX
    ``build_model``): ``yolo.num_classes``/``num_anchors``, the optional
    ``seg.num_classes`` head and the ``prune:`` width overrides.

    ``dtype``/``device`` place the parameters; ``generator`` seeds the init.
    Serving in bf16 is ``make_predict_fn(..., dtype=torch.bfloat16)``.
    """
    num_classes = config["yolo"]["num_classes"]
    num_anchors = config["yolo"]["num_anchors"]
    seg_classes = config.get("seg", {}).get("num_classes", 0)
    prune_cfg = config.get("prune") or {}
    hidden = prune_cfg.get("backbone_hidden")
    hidden = tuple(hidden) if hidden else None
    head = prune_cfg.get("backbone_head")
    if backbone == "mbv2":
        return MBv2YOLO(num_classes=num_classes, num_anchors=num_anchors,
                        seg_num_classes=seg_classes, backbone_hidden=hidden,
                        backbone_head=head, device=device, dtype=dtype,
                        generator=generator)
    if backbone in ("mbv3", "mbv3_macc"):
        raise NotImplementedError(
            f"backbone {backbone!r} is not ported yet "
            "(ROADMAP.md, Queue 1 item 8: MobileNetV3 graphs)")
    raise ValueError(f"unknown backbone {backbone!r}")
