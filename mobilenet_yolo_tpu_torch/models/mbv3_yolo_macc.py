"""MobileNetV3-YOLO MACC-lite detector graph (torch, NCHW).

Port of ``mobilenet_yolo_tpu/models/mbv3_yolo_macc.py:25-59``: the S32
trunk is a plain 1x1 ``ConvBNAct`` to 512 channels, a ``Connect`` and its
head; the upsample path runs its 512->256 1x1 conv *before* the 2x
nearest upsample, so the pointwise conv runs at the low resolution, and
adds it to the S16 trunk (a ``DepthwiseConvolution`` of the 160-ch tap to
256 channels), then a ``Connect`` and the S16 head.

Its ``conv_for_S32`` is a plain 1x1 conv, so the backbone's 960-ch
``head_conv`` is prunable (``backbone_head``).
"""

from __future__ import annotations

import torch
from torch import nn

from mobilenet_yolo_tpu_torch.models.layers import (
    Connect,
    ConvBNAct,
    DepthwiseConvolution,
    HeadStack,
    upsample_nearest2x,
)
from mobilenet_yolo_tpu_torch.models.mobilenetv3 import MobileNetV3Large


class MBv3YOLOMacc(nn.Module):
    def __init__(self, num_classes: int = 20, num_anchors: int = 3,
                 backbone_hidden: tuple[int | None, ...] | None = None,
                 backbone_head: int | None = None, remat: bool = False, *, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        head_ch = num_anchors * (5 + num_classes)
        self.backbone = MobileNetV3Large(backbone_hidden, backbone_head, remat, **kw)
        c4, c5 = self.backbone.c4_features, self.backbone.c5_features
        self.conv_for_S32 = ConvBNAct(c5, 512, 1, **kw)
        self.connect_for_S32 = Connect(512, **kw)
        self.yolo_headS32 = HeadStack(512, 1024, head_ch, **kw)
        self.upsample_conv = ConvBNAct(512, 256, 1, **kw)
        self.conv_for_S16 = DepthwiseConvolution(c4, 256, **kw)
        self.connect_for_S16 = Connect(256, **kw)
        self.yolo_headS16 = HeadStack(256, 512, head_ch, **kw)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c4, c5 = self.backbone(x)
        s32 = self.connect_for_S32(self.conv_for_S32(c5))
        up = upsample_nearest2x(self.upsample_conv(s32))  # conv, then upsample
        s16 = self.connect_for_S16(self.conv_for_S16(c4) + up)
        return {"out0": self.yolo_headS32(s32), "out1": self.yolo_headS16(s16)}
