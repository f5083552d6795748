"""Segmentation quality metrics: per-class IoU and mIoU over thresholded
sigmoid maps.

Port of ``mobilenet_yolo_tpu/ops/seg_metrics.py``. The counts are int64
tensors on the maps' device, so accumulating a batch does not wait for
the device; ``mean_iou`` reads them once at the end.
"""

from __future__ import annotations

import torch


def seg_intersection_union(pred_maps: torch.Tensor, truth: torch.Tensor,
                           threshold: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class intersection and union pixel counts.

    pred_maps: (B, H, W, C) sigmoid maps; truth: (B, H, W, C) {0,1} maps.
    Returns (intersection (C,), union (C,)) int64 — accumulate across
    batches and divide at the end for dataset IoU.
    """
    p = pred_maps >= threshold
    t = truth >= 0.5
    inter = (p & t).sum(dim=(0, 1, 2), dtype=torch.int64)
    union = (p | t).sum(dim=(0, 1, 2), dtype=torch.int64)
    return inter, union


def mean_iou(intersection: torch.Tensor, union: torch.Tensor) -> tuple[torch.Tensor, float]:
    """(per-class IoU, mIoU). Classes absent from both pred and truth
    count as IoU 1 (standard convention for empty classes)."""
    inter, union = intersection.double(), union.double()
    iou = torch.where(union > 0, inter / union.clamp(min=1), torch.ones_like(union))
    return iou, float(iou.mean())


class SegMetricAccumulator:
    def __init__(self, num_classes: int):
        self.inter = torch.zeros(num_classes, dtype=torch.int64)
        self.union = torch.zeros(num_classes, dtype=torch.int64)

    def add_batch(self, pred_maps: torch.Tensor, truth: torch.Tensor,
                  threshold: float = 0.5) -> None:
        inter, union = seg_intersection_union(pred_maps, truth, threshold)
        self.inter = self.inter.to(inter.device) + inter
        self.union = self.union.to(union.device) + union

    def compute(self) -> tuple[torch.Tensor, float]:
        return mean_iou(self.inter, self.union)
