"""Vectorized YOLO target assignment.

Port of ``mobilenet_yolo_tpu/ops/assign.py:40-159`` (``build_targets``):
the ignore mask, per-GT anchor matching (argmax plus every in-head anchor
over ``iou_thresh``), label-smoothed class targets, one CIoU per
(GT, head anchor) assignment and the running metrics, over padded GT
``(B, T, 5)`` rows ``(label, cx, cy, w, h)`` (label 1-indexed) of which
the first ``n_gt[b]`` are real.

The ``.at[...].add`` scatters are ``index_put_(..., accumulate=True)``;
``torch.argmax`` takes the first of tied values as ``jnp.argmax`` does.
Targets, weights, counts and metrics carry no gradient; the CIoU does.
Given a data-parallel step's data group (``group``) ``count`` and the
metrics are the global batch's, as they are under GSPMD.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mobilenet_yolo_tpu_torch.parallel.mesh import global_sum
from mobilenet_yolo_tpu_torch.ops.boxes import box_ciou, cxcywh_to_corners, pairwise_iou, shape_iou


class TargetAssignment(NamedTuple):
    targets: torch.Tensor      # (B, H, W, A, 1+C) conf/class targets
    weights: torch.Tensor      # (B, H, W, A, 1+C) loss weights
    ciou: torch.Tensor         # (B, T, A) CIoU per potential assignment
    assign: torch.Tensor       # (B, T, A) bool assignment mask
    area_weight: torch.Tensor  # (B, T, A) (2 - gt_area) box-loss weights
    count: torch.Tensor        # () total number of assignments
    metrics: dict              # scalar running metrics (no gradient)


def build_targets(pred_boxes: torch.Tensor, output: torch.Tensor, gt: torch.Tensor,
                  n_gt: torch.Tensor, anchors_all_norm: torch.Tensor, mask,
                  ignore_thresh: float, iou_thresh: float,
                  label_smooth_eps: float = 0.1, group=None) -> TargetAssignment:
    """pred_boxes (B, H, W, A, 4) train-decoded corners; output
    (B, H, W, A, 1+C) sigmoid(conf, classes); gt (B, T, 5); n_gt (B,);
    anchors_all_norm (num_anchors, 2); ``mask`` this head's anchor indices;
    ``group`` the data group whose rows ``count`` and the metrics cover."""
    b, h, w, a, _ = output.shape
    t = gt.shape[1]
    c = output.shape[-1] - 1
    dt, dev = output.dtype, output.device
    mask = torch.as_tensor(list(mask), dtype=torch.long, device=dev)

    valid = torch.arange(t, device=dev)[None, :] < n_gt[:, None]          # (B, T)
    gt_boxes = cxcywh_to_corners(gt[..., 1:5])                            # (B, T, 4)

    with torch.no_grad():
        # ignore mask: max IoU of every decoded box against any valid GT
        iou_gp = pairwise_iou(gt_boxes, pred_boxes.reshape(b, h * w * a, 4))
        iou_gp = torch.where(valid[..., None], iou_gp, torch.zeros_like(iou_gp))
        max_iou = iou_gp.amax(dim=1).clamp(min=0.0).reshape(b, h, w, a)
        negative = max_iou < ignore_thresh                                # (B, H, W, A)

        # per-GT anchor matching
        anch_iou_all = shape_iou(gt[..., 3:5], anchors_all_norm)          # (B, T, NA)
        best_n = anch_iou_all.argmax(dim=-1)                              # (B, T)
        is_best = best_n[..., None] == mask                               # (B, T, A)
        assign = valid[..., None] & (is_best | (anch_iou_all[..., mask] > iou_thresh))

        # grid cell of each GT centre (truncation, yolo_loss.py:136-137)
        gi = torch.floor(gt[..., 1] * w).long().clamp(0, w - 1)           # (B, T)
        gj = torch.floor(gt[..., 2] * h).long().clamp(0, h - 1)
        cls = (gt[..., 0].long() - 1).clamp(0, c - 1)

        shape = (b, t, a)
        b_idx = torch.arange(b, device=dev)[:, None, None].expand(shape)
        k_idx = torch.arange(a, device=dev)[None, None, :].expand(shape)
        gi_idx = gi[..., None].expand(shape)
        gj_idx = gj[..., None].expand(shape)
        cls_idx = cls[..., None].expand(shape)
        assign_f = assign.to(dt)

        # dense positive / class-assignment masks by scatter-add
        pos = torch.zeros((b, h, w, a), dtype=dt, device=dev).index_put_(
            (b_idx, gj_idx, gi_idx, k_idx), assign_f, accumulate=True) > 0
        cls_hit = torch.zeros((b, h, w, a, c), dtype=dt, device=dev).index_put_(
            (b_idx, gj_idx, gi_idx, k_idx, cls_idx), assign_f, accumulate=True) > 0

        y_true = (1.0 - label_smooth_eps) + 0.5 * label_smooth_eps
        y_false = 0.5 * label_smooth_eps
        tgt_cls = torch.where(cls_hit, torch.full_like(cls_hit, y_true, dtype=dt),
                              torch.full_like(cls_hit, y_false, dtype=dt))
        targets = torch.cat([pos.to(dt)[..., None], tgt_cls], dim=-1)
        weights = torch.cat([(pos | negative).to(dt)[..., None],
                             pos[..., None].expand(cls_hit.shape).to(dt)], dim=-1)

    # CIoU per assignment. Padded GT rows are sanitized *before* the
    # division-heavy CIoU so no NaN can leak through `where` into gradients
    pred_at = pred_boxes[b_idx, gj_idx, gi_idx, k_idx]                    # (B, T, A, 4)
    dummy = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=dt, device=dev)
    gt_safe = torch.where(assign[..., None], gt_boxes[:, :, None, :].expand(b, t, a, 4),
                          dummy)
    ciou, iou_el = box_ciou(gt_safe, pred_at)                             # (B, T, A)

    with torch.no_grad():
        area_weight = (2.0 - (gt[..., 3] * gt[..., 4])[:, :, None]) * assign_f
        # running metrics (reference yolo_loss.py:146-177), from sums over
        # the batch: the global batch's under a data-parallel step
        conf_at = output[b_idx, gj_idx, gi_idx, k_idx, 0]
        clsp_at = output[b_idx, gj_idx, gi_idx, k_idx, 1 + cls_idx]
        sums = global_sum(torch.stack([
            assign_f.sum(), (conf_at * assign_f).sum(), output[..., 0].sum(),
            ((iou_el > ignore_thresh).to(dt) * assign_f).sum(), (iou_el * assign_f).sum(),
            (clsp_at * assign_f).sum(), torch.tensor(float(b), dtype=dt, device=dev)]), group)
        count, obj_sum, total_conf, recall_sum, iou_sum, cls_sum, b = sums.unbind()
        no_cnt = b * (h * w * a)
        safe_count = count.clamp(min=1.0)
        has_pos = count > 0
        zero = torch.zeros((), dtype=dt, device=dev)
        metrics = {
            "recall": torch.where(has_pos, recall_sum / safe_count, zero),
            "avg_iou": torch.where(has_pos, iou_sum / safe_count, zero),
            "obj": torch.where(has_pos, obj_sum / safe_count, zero),
            "no_obj": torch.where(
                has_pos, (total_conf - obj_sum) / (no_cnt - count).clamp(min=1.0), zero),
            "cls_score": torch.where(has_pos, cls_sum / safe_count, zero),
            "count": count / b,
        }

    return TargetAssignment(targets=targets, weights=weights, ciou=ciou, assign=assign,
                            area_weight=area_weight, count=count, metrics=metrics)
