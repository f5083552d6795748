"""Tensor functions of the port: anchors, boxes, decode, NMS, target
assignment, losses, the device augmentation and the host-side VOC and COCO
AP and segmentation metrics (port of ``mobilenet_yolo_tpu/ops/``)."""

from mobilenet_yolo_tpu_torch.ops.anchors import grid_xy, scaled_anchors  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.boxes import area, cxcywh_to_corners, pairwise_iou  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.decode import decode_predictions, reshape_head  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.nms import batched_nms  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.ap import calculate_mAP  # noqa: F401
from mobilenet_yolo_tpu_torch.ops.coco_ap import calculate_coco_map  # noqa: F401
