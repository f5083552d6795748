"""Box primitives on ``(..., 4)`` tensors.

Port of ``mobilenet_yolo_tpu/ops/boxes.py:17-48`` (``cxcywh_to_corners``,
``area``, ``pairwise_iou``). Corner boxes are ``(x1, y1, x2, y2)``, centre
boxes ``(cx, cy, w, h)``. CIoU and GIoU come with the loss port.
"""

from __future__ import annotations

import torch


def cxcywh_to_corners(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = box.unbind(-1)
    x1 = cx - w / 2
    y1 = cy - h / 2
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def area(box: torch.Tensor) -> torch.Tensor:
    """Signed area of corner boxes."""
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def pairwise_iou(set_1: torch.Tensor, set_2: torch.Tensor) -> torch.Tensor:
    """IoU of every pair: (..., n1, 4) x (..., n2, 4) -> (..., n1, n2).

    The intersection is clamped at 0; the union uses signed areas, as the
    JAX package and the upstream reference do.
    """
    lower = torch.maximum(set_1[..., :, None, :2], set_2[..., None, :, :2])
    upper = torch.minimum(set_1[..., :, None, 2:], set_2[..., None, :, 2:])
    wh = (upper - lower).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(set_1)[..., :, None] + area(set_2)[..., None, :] - inter
    return inter / union
