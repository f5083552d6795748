"""Tensor functions of the port: anchors, boxes, decode, NMS, target
assignment, losses and the device augmentation (port of
``mobilenet_yolo_tpu/ops/``; the AP ops come with the eval slice)."""

from mobilenet_yolo_tpu_torch.ops.anchors import grid_xy, scaled_anchors  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.boxes import area, cxcywh_to_corners, pairwise_iou  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.decode import decode_predictions, reshape_head  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.nms import batched_nms  # noqa: F401
