"""Command-line entry points of the port (``python -m mobilenet_yolo_tpu_torch.cli.<name>``;
port of ``mobilenet_yolo_tpu/cli/``): ``train``, ``eval``, ``infer``, ``build_dataset``."""
