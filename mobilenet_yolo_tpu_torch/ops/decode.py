"""YOLO head decode: raw head logits -> boxes / confidences.

Port of ``mobilenet_yolo_tpu/ops/decode.py:33-40`` (``WH_CLIP``,
``reshape_head``), ``:43-63`` (``decode_boxes_train``) and ``:66-92``
(``decode_predictions``). Heads are NHWC
``(B, H, W, A*(5+C))``, so the flat candidate order is ``(H, W, A)`` as in
JAX and detections compare index by index.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.ops.anchors import grid_xy
from mobilenet_yolo_tpu_torch.ops.boxes import cxcywh_to_corners
from mobilenet_yolo_tpu_torch.ops.sigmoid_st import sigmoid_st

# t_wh clip before exp (reason at decode.py:28-32); a no-op for any sane box
WH_CLIP = 18.0


def reshape_head(head_out: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """(B, H, W, A*(5+C)) -> (B, H, W, A, 5+C)."""
    b, h, w, c = head_out.shape
    if c % num_anchors:
        raise ValueError(f"{c} head channels do not split into {num_anchors} anchors")
    return head_out.reshape(b, h, w, num_anchors, c // num_anchors)


def decode_boxes_train(pred: torch.Tensor, anchors_norm: torch.Tensor):
    """Loss-path decode (``decode.py:43-63``) of ``pred`` (B, H, W, A, 5+C)
    raw logits with ``anchors_norm`` (A, 2).

    Returns ``(pred_corners (B, H, W, A, 4), output (B, H, W, A, 1+C))``:
    straight-through sigmoid on xy and on conf/classes, a clipped exp on wh.
    """
    _, h, w, _, _ = pred.shape
    xy = sigmoid_st(pred[..., 0:2])
    wh = torch.exp(pred[..., 2:4].clamp(-WH_CLIP, WH_CLIP))
    output = sigmoid_st(pred[..., 4:])

    grid = grid_xy(w, h, device=pred.device, dtype=pred.dtype)[:, :, None, :]
    inv_dim = (1.0 / torch.tensor([w, h], dtype=pred.dtype)).to(
        pred.device, non_blocking=True)
    centers = (xy + grid) * inv_dim
    sizes = wh * anchors_norm
    return cxcywh_to_corners(torch.cat([centers, sizes], dim=-1)), output


def decode_predictions(pred: torch.Tensor, anchors_norm: torch.Tensor) -> torch.Tensor:
    """Eval decode of ``pred`` (B, H, W, A, 5+C) raw logits with
    ``anchors_norm`` (A, 2) image-fraction anchors.

    Returns (B, H*W*A, 7) ``(x1, y1, x2, y2, conf, cls_score, cls_idx)`` in
    normalized units; the ``conf > val_conf`` gate is applied by the NMS.
    """
    b, h, w, a, _ = pred.shape
    xy = torch.sigmoid(pred[..., 0:2])
    wh = torch.exp(pred[..., 2:4].clamp(-WH_CLIP, WH_CLIP))
    conf_cls = torch.sigmoid(pred[..., 4:])

    grid = grid_xy(w, h, device=pred.device, dtype=pred.dtype)[:, :, None, :]
    # divided in pred.dtype on the host as JAX does; a pageable non_blocking
    # copy is staged at once and does not wait for the device queue
    inv_dim = (1.0 / torch.tensor([w, h], dtype=pred.dtype)).to(
        pred.device, non_blocking=True)
    centers = (xy + grid) * inv_dim
    sizes = wh * anchors_norm
    boxes = cxcywh_to_corners(torch.cat([centers, sizes], dim=-1))

    conf = conf_cls[..., 0:1]
    cls_probs = conf_cls[..., 1:]
    cls_score = cls_probs.amax(dim=-1, keepdim=True)
    # argmax returns the first of tied maxima, as jnp.argmax does
    cls_idx = cls_probs.argmax(dim=-1, keepdim=True).to(pred.dtype)
    out = torch.cat([boxes, conf, cls_score, cls_idx], dim=-1)
    return out.reshape(b, h * w * a, 7)
