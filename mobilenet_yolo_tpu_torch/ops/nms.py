"""Batched, class-aware hard NMS with fixed shapes.

Port of ``mobilenet_yolo_tpu/ops/nms.py:29-35`` (``_suppression_matrix``)
and ``:54-82`` (``batched_nms``). The pairwise suppression matrix stays
plain torch, as it stays XLA in JAX; the greedy scan is the CUDA kernel
``kernels.nms_suppress.suppress`` on every CUDA tensor (its plain twin on a
CPU tensor).
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress
from mobilenet_yolo_tpu_torch.ops.boxes import pairwise_iou
from mobilenet_yolo_tpu_torch.utils.profiling import span


def _suppression_matrix(boxes: torch.Tensor, classes: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """(B, K, 4), (B, K) -> (B, K, K) float {0, 1}: i suppresses j, j > i."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    same_cls = classes[..., :, None] == classes[..., None, :]
    idx = torch.arange(k, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    return ((iou > iou_threshold) & same_cls & later).to(torch.float32)


def batched_nms(preds: torch.Tensor, val_conf: torch.Tensor, top_k: int = 256,
                iou_threshold: float = 0.45) -> tuple[torch.Tensor, torch.Tensor]:
    """preds: (B, N, 7) decoded ``(x1, y1, x2, y2, conf, cls_score, cls_idx)``;
    val_conf: 0-d confidence gate.

    Returns (detections (B, K, 7), keep (B, K) bool), K = min(top_k, N),
    sorted by descending ``conf * cls_score``. Ties keep the lower index
    first, as ``jax.lax.top_k`` does, so the order matches the JAX package.
    The gate, sort and gather run in a ``myt:select`` span, the suppression
    matrix and the scan in ``myt:nms``.
    """
    with span("myt:select"):
        conf = preds[..., 4]
        valid = conf > val_conf
        score = conf * preds[..., 5]
        ranked = torch.where(valid, score, torch.full_like(score, float("-inf")))

        k = min(top_k, preds.shape[1])
        # a stable descending sort keeps tied (incl. every invalid -inf)
        # candidates in index order; torch.topk does not promise that
        top_scores, top_idx = torch.sort(ranked, dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        sel = torch.gather(preds, 1, top_idx[..., None].expand(-1, -1, preds.shape[-1]))
        sel_valid = torch.isfinite(top_scores)

    with span("myt:nms"):
        over = _suppression_matrix(sel[..., :4], sel[..., 6].to(torch.int32), iou_threshold)
        keep = suppress(over, sel_valid.to(torch.float32))
    return sel, keep
