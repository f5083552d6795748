"""Hand-written Hopper kernels of the port, each beside its plain-torch twin.

Sources live in ``mobilenet_yolo_tpu_torch/csrc/`` and are built by
``_build.py`` at first use; importing this package builds nothing. The
augmentation kernels' modules (``slot_aug``, ``aug_compose``) share their
wrappers' names, so import those from the modules themselves; the fused
MobileNetV2 blocks of the BatchNorm-folded forward are in ``fused_block``.
"""

from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference  # noqa: F401
