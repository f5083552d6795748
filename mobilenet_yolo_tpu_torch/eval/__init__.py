"""Serving and evaluation entry points (port of ``mobilenet_yolo_tpu/eval/``)."""

from mobilenet_yolo_tpu_torch.eval.detector import make_predict_fn  # noqa: F401
from mobilenet_yolo_tpu_torch.eval.evaluator import (  # noqa: F401
    Evaluator,
    adjust_confidence,
    evaluate_detection,
)
