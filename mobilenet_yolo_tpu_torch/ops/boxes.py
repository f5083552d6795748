"""Box primitives on ``(..., 4)`` tensors.

Port of ``mobilenet_yolo_tpu/ops/boxes.py`` (coordinate conversions,
``area``, ``pairwise_iou``, ``elementwise_iou``, ``shape_iou``,
``enclosing_box``, ``box_ciou``, ``box_giou``). Corner boxes are
``(x1, y1, x2, y2)``, centre boxes ``(cx, cy, w, h)``.
"""

from __future__ import annotations

import math

import torch


def cxcywh_to_corners(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = box.unbind(-1)
    x1 = cx - w / 2
    y1 = cy - h / 2
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def corners_to_cxcywh(box: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = box.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + w / 2, y1 + h / 2, w, h], dim=-1)


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


def _intersection_union(box1: torch.Tensor, box2: torch.Tensor):
    lower = torch.maximum(box1[..., :2], box2[..., :2])
    upper = torch.minimum(box1[..., 2:], box2[..., 2:])
    wh = (upper - lower).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, area(box1) + area(box2) - inter


def elementwise_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """IoU of aligned corner boxes of one shape (..., 4) -> (...)."""
    inter, union = _intersection_union(box1, box2)
    return inter / union


def shape_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """Anchor-shape IoU of boxes pinned at the origin (``boxes.py:61-75``):
    (..., n1, 2) x (..., n2, 2) -> (..., n1, n2)."""
    w1 = wh1[..., :, None, 0]
    h1 = wh1[..., :, None, 1]
    w2 = wh2[..., None, :, 0]
    h2 = wh2[..., None, :, 1]
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    return inter / (w1 * h1 + w2 * h2 - inter)


def enclosing_box(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Smallest corner box holding both."""
    return torch.stack([torch.minimum(box1[..., 0], box2[..., 0]),
                        torch.minimum(box1[..., 1], box2[..., 1]),
                        torch.maximum(box1[..., 2], box2[..., 2]),
                        torch.maximum(box1[..., 3], box2[..., 3])], dim=-1)


def box_ciou(box1: torch.Tensor, box2: torch.Tensor):
    """Complete-IoU of aligned corner boxes; returns ``(ciou, iou)``
    (``boxes.py:87-120``). ``alpha`` is *not* detached, as in the JAX
    package and the reference, so the gradients match. A zero-area
    enclosing box falls back to plain IoU."""
    c = area(enclosing_box(box1, box2))
    iou = elementwise_iou(box1, box2)

    w1 = box1[..., 2] - box1[..., 0]
    h1 = box1[..., 3] - box1[..., 1]
    w2 = box2[..., 2] - box2[..., 0]
    h2 = box2[..., 3] - box2[..., 1]
    x1 = (box1[..., 2] + box1[..., 0]) / 2
    y1 = (box1[..., 1] + box1[..., 3]) / 2
    x2 = (box2[..., 2] + box2[..., 0]) / 2
    y2 = (box2[..., 1] + box2[..., 3]) / 2

    u = (x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2)
    # guard the c == 0 division; the degenerate branch overrides the value
    d = u / torch.where(c == 0, torch.ones_like(c), c)

    atan_diff = torch.atan(w2 / h2) - torch.atan(w1 / h1)
    ar_loss = 4.0 / (math.pi * math.pi) * atan_diff * atan_diff
    alpha = ar_loss / (1.0 - iou + ar_loss + 1e-6)
    ciou_term = torch.where(c == 0, iou, d + alpha * ar_loss)
    return iou - ciou_term, iou


def box_giou(box1: torch.Tensor, box2: torch.Tensor):
    """Generalized-IoU of aligned corner boxes; returns ``(giou, iou)``
    (``boxes.py:123-134``)."""
    c = area(enclosing_box(box1, box2))
    inter, union = _intersection_union(box1, box2)
    iou = inter / union
    giou_term = (c - union) / torch.where(c == 0, torch.ones_like(c), c)
    giou_term = torch.where(c == 0, iou, giou_term)
    return iou - giou_term, iou
