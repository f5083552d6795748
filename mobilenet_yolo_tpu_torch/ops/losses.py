"""Loss functions: weighted MSE, per-head YOLO loss, segmentation loss.

Port of ``mobilenet_yolo_tpu/ops/losses.py``. The scale of every term is
the reference's and the JAX package's: the weighted MSE divides by the
(mask-dependent) weight sum, the CIoU term by the number of assignments,
and ``iou_weighting`` scales it (reference yolo_loss.py:53-60,224,234).

Given a data-parallel step's data group (``group``) every normaliser is
the global batch's, as under GSPMD, so a rank's loss is its
share of the one global ratio: the shares sum to the global loss, and the
sum of the ranks' gradients is its gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobilenet_yolo_tpu_torch.ops.assign import build_targets
from mobilenet_yolo_tpu_torch.ops.decode import decode_boxes_train, reshape_head
from mobilenet_yolo_tpu_torch.ops.sigmoid_st import sigmoid_st
from mobilenet_yolo_tpu_torch.parallel.mesh import global_sum


def weighted_mse_loss(x: torch.Tensor, target: torch.Tensor,
                      weights: torch.Tensor, group=None) -> torch.Tensor:
    """``sum((x - t)^2 * w) / sum(w)``; with a data ``group`` this rank's
    share of the global ratio, ``sum(w)`` over the group's rows."""
    return ((x - target) ** 2 * weights).sum() / global_sum(weights.sum(), group).clamp(min=1e-12)


class HeadLoss(NamedTuple):
    loss: torch.Tensor
    metrics: dict


def yolo_head_loss(head_out: torch.Tensor, gt: torch.Tensor, n_gt: torch.Tensor,
                   anchors_all_norm: torch.Tensor, mask, num_classes: int,
                   ignore_thresh: float, iou_thresh: float, iou_weighting: float,
                   label_smooth_eps: float = 0.1, group=None) -> HeadLoss:
    """Single-head training loss of ``head_out`` (B, H, W, A*(5+C)) NHWC raw
    logits (``losses.py:33-85``):

    ``weighted_mse(sigmoid_st(conf, cls), targets, weights)
    + iou_weighting * sum((ciou - 1)^2 over assignments) / count``.

    The CIoU term is the reference's as executed: its weighted MSE
    broadcasts an (N, 1) error against (N,) weights into an (N, N) outer
    product, so the ``(2 - gt_area)`` weights cancel and the term is the
    plain mean over assignments (``losses.py:66-79``). ``group``: the
    data group whose rows the normalisers and metrics cover.
    """
    mask = list(mask)
    pred = reshape_head(head_out, len(mask))
    anchors_head = anchors_all_norm[torch.as_tensor(mask, device=anchors_all_norm.device)]
    pred_boxes, output = decode_boxes_train(pred, anchors_head)
    tgt = build_targets(pred_boxes, output, gt, n_gt, anchors_all_norm, mask,
                        ignore_thresh=ignore_thresh, iou_thresh=iou_thresh,
                        label_smooth_eps=label_smooth_eps, group=group)

    conf_cls_loss = weighted_mse_loss(output, tgt.targets, tgt.weights, group)
    sq = (tgt.ciou - 1.0) ** 2 * tgt.assign.to(tgt.ciou.dtype)
    iou_loss = torch.where(tgt.count > 0, sq.sum() / tgt.count.clamp(min=1.0),
                           torch.zeros_like(tgt.count))
    metrics = dict(tgt.metrics)
    metrics["conf_cls_loss"] = conf_cls_loss.detach()
    metrics["iou_loss"] = iou_loss.detach()
    return HeadLoss(loss=conf_cls_loss + iou_loss * iou_weighting, metrics=metrics)


def seg_loss(seg_logits: torch.Tensor, seg_truth: torch.Tensor, group=None):
    """Segmentation loss (``losses.py:88-104``) of NHWC ``seg_logits``
    against {0, 1} (or coverage-fraction) maps of the same shape.

    Returns ``(0.05 * mean((sigmoid_st(x) - t)^2), mean obj activation,
    mean no-obj activation)``; the two means carry no gradient. With a
    data ``group`` the means are over the group's rows.
    """
    output = sigmoid_st(seg_logits)
    sq = (output - seg_truth) ** 2
    if group is None:
        loss = sq.mean()
    else:
        loss = sq.sum() / global_sum(output.new_tensor(float(sq.numel())), group)
    with torch.no_grad():
        obj_mask = seg_truth >= 0.5
        zero = torch.zeros_like(output)
        sums = global_sum(torch.stack([
            torch.where(obj_mask, output, zero).sum(), obj_mask.sum().to(output.dtype),
            torch.where(obj_mask, zero, output).sum(), (~obj_mask).sum().to(output.dtype)]),
            group)
        obj_mean = sums[0] / sums[1].clamp(min=1)
        no_obj_mean = sums[2] / sums[3].clamp(min=1)
    return loss * 0.05, obj_mean, no_obj_mean
