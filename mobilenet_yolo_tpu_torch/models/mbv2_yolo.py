"""MobileNetV2-YOLO detector graph (torch, NCHW).

Port of ``mobilenet_yolo_tpu/models/mbv2_yolo.py:29-67``: a two-scale
FPN-lite on the MobileNetV2 taps plus an optional segmentation branch.
``forward`` returns raw logits ``{"out0", "out1"[, "seg"]}`` as NCHW
tensors; no decode or NMS inside (those are ``ops/``). ``remat`` recomputes
the backbone blocks in the backward (``MobileNetV2``). The forward opens
the spans ``myt:backbone``, ``myt:heads`` (necks, upsample add, both YOLO
heads) and ``myt:seg_head`` (``utils.profiling.span``).
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
from mobilenet_yolo_tpu_torch.models.mobilenetv2 import MobileNetV2
from mobilenet_yolo_tpu_torch.utils.profiling import span


class MBv2YOLO(nn.Module):
    def __init__(self, num_classes: int = 20, num_anchors: int = 3,
                 seg_num_classes: int = 0, width_mult: float = 1.0,
                 backbone_hidden: tuple[int | None, ...] | None = None,
                 backbone_head: int | None = None, remat: bool = False, *, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        head_ch = num_anchors * (5 + num_classes)
        self.backbone = MobileNetV2(width_mult, backbone_hidden, backbone_head, remat, **kw)
        c4, c5 = self.backbone.c4_features, self.backbone.c5_features

        self.conv_for_S32 = ConvBNAct(c5, 512, 1, **kw)
        self.connect_for_S32 = Connect(512, **kw)
        self.yolo_headS32 = HeadStack(512, 1024, head_ch, **kw)

        self.conv_for_S16 = DepthwiseConvolution(c4, 512, **kw)
        self.connect_for_S16 = Connect(512, **kw)
        self.yolo_headS16 = HeadStack(512, 512, head_ch, **kw)

        self.seg_num_classes = seg_num_classes
        if seg_num_classes > 0:
            self.seg_conv_for_S16 = DepthwiseConvolution(c4, 32, **kw)
            self.seg_connect_for_S16 = Connect(32, **kw)
            self.seg_headS16 = HeadStack(32, 32, seg_num_classes, **kw)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        with span("myt:backbone"):
            c4, c5 = self.backbone(x)
        with span("myt:heads"):
            s32 = self.connect_for_S32(self.conv_for_S32(c5))
            s16 = self.connect_for_S16(self.conv_for_S16(c4))
            s16 = s16 + upsample_nearest2x(s32)
            outputs = {"out0": self.yolo_headS32(s32), "out1": self.yolo_headS16(s16)}
        if self.seg_num_classes > 0:
            with span("myt:seg_head"):
                seg = self.seg_connect_for_S16(self.seg_conv_for_S16(c4))
                outputs["seg"] = self.seg_headS16(seg)
        return outputs
