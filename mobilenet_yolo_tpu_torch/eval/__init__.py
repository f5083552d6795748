"""Serving entry point (port of ``mobilenet_yolo_tpu/eval/``; the evaluator
comes with a later slice)."""

from mobilenet_yolo_tpu_torch.eval.detector import make_predict_fn  # noqa: F401
