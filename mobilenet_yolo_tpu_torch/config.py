"""The VOC model and train contract as plain dicts.

The values of ``mobilenet_yolo_tpu/configs/voc/config.yaml`` (the reference's
``models/voc/config.yaml``), kept here so the port's scripts and tools read
one copy without a yaml parser. ``tests/test_torch_tools.py`` holds them
equal to the file.
"""

from __future__ import annotations

VOC_CONFIG = {
    "img_h": 352,
    "img_w": 352,
    "batch_size": 32,
    "train_img_size": [[352, 352], [320, 320], [288, 288], [384, 384], [416, 416]],
    "expand_scale": 2.1610954191879452,
    "mosaic_num": [1, 4],
    "iou_weighting": 0.021830872589525777,
    "normalize": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "yolo": {
        "num_classes": 20,
        "num_anchors": 3,
        "ignore_thresh": [0.6076333316652263, 0.5623606200028424],
        "iou_thresh": 0.5497280113447018,
        "anchors": [[143, 265], [153, 121], [280, 279], [20, 37], [49, 94], [73, 201]],
        "classes": 20,
        "mask": [[0, 1, 2], [3, 4, 5]],
    },
}

# the multiscale training buckets, smallest first
TRAIN_BUCKETS = tuple(sorted(h for h, _ in VOC_CONFIG["train_img_size"]))
