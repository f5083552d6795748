"""Hand-written Hopper kernels of the port, each beside its plain-torch twin.

Sources live in ``mobilenet_yolo_tpu_torch/csrc/`` and are built by
``_build.py`` at first use; importing this package builds nothing.
"""

from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference  # noqa: F401
