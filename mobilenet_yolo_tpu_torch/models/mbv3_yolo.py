"""MobileNetV3-YOLO detector graph (torch, NCHW).

Port of ``mobilenet_yolo_tpu/models/mbv3_yolo.py:28-62``. S32: the 960-ch
tap through a ``DepthwiseConvolution`` to 320 channels, a ``Connect`` and
its head. S16: the 160-ch tap through ``connect_for_S16`` twice (one
module, as the reference reuses it; in train mode its BatchNorm statistics
move twice a step, one update after the other, and ``num_batches_tracked``
counts both), then ``part_add`` with the upsampled 320-ch S32 trunk (160
channels added, the other 160 concatenated) and a 320-ch head.
``forward`` returns raw logits ``{"out0", "out1"}`` as NCHW tensors.

The backbone's ``head_conv`` is not prunable here: its consumer is a
width-coupled ``DepthwiseConvolution`` (``models.build_model`` refuses a
``backbone_head``).
"""

from __future__ import annotations

import torch
from torch import nn

from mobilenet_yolo_tpu_torch.models.layers import (
    Connect,
    DepthwiseConvolution,
    HeadStack,
    part_add,
    upsample_nearest2x,
)
from mobilenet_yolo_tpu_torch.models.mobilenetv3 import MobileNetV3Large


class MBv3YOLO(nn.Module):
    def __init__(self, num_classes: int = 20, num_anchors: int = 3,
                 backbone_hidden: tuple[int | None, ...] | None = None, remat: bool = False,
                 *, device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        head_ch = num_anchors * (5 + num_classes)
        self.backbone = MobileNetV3Large(backbone_hidden, remat=remat, **kw)
        c4, c5 = self.backbone.c4_features, self.backbone.c5_features
        self.conv_for_S32 = DepthwiseConvolution(c5, 320, **kw)
        self.connect_for_S32 = Connect(320, **kw)
        self.yolo_headS32 = HeadStack(320, 960, head_ch, **kw)
        self.connect_for_S16 = Connect(c4, **kw)
        self.yolo_headS16 = HeadStack(320, 640, head_ch, **kw)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c4, c5 = self.backbone(x)
        s32 = self.connect_for_S32(self.conv_for_S32(c5))
        s16 = self.connect_for_S16(self.connect_for_S16(c4))  # twice, as in the reference
        s16 = part_add(s16, upsample_nearest2x(s32))  # -> 320 ch
        return {"out0": self.yolo_headS32(s32), "out1": self.yolo_headS16(s16)}
