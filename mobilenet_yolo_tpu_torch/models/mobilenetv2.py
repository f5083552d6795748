"""MobileNetV2 backbone (torch, NCHW).

Port of ``mobilenet_yolo_tpu/models/mobilenetv2.py:17-84``: a 3x3/2 stem,
inverted-residual blocks ``block0``..``block16`` and a 1x1 ``head_conv``.
``forward`` returns both taps ``(c4 stride-16, c5 stride-32)``.
"""

from __future__ import annotations

import torch
from torch import nn

from mobilenet_yolo_tpu_torch.models.layers import (
    ConvBNAct,
    InvertedResidual,
    make_divisible,
)

# (expand_ratio t, channels c, repeats n, stride s) — mobilenetv2.py:17-27
CFGS_STAGE1 = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
]
CFGS_STAGE2 = [
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2(nn.Module):
    """``hidden_overrides`` / ``head_features`` carry channel-pruned widths:
    per-block expansion sizes (None keeps ``round(inp * t)``) and the final
    1x1 head-conv width (default 1280). ``c4_features`` / ``c5_features``
    are the tap widths a detector head builds on."""

    def __init__(self, width_mult: float = 1.0,
                 hidden_overrides: tuple[int | None, ...] | None = None,
                 head_features: int | None = None, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        div = 4 if width_mult == 0.1 else 8
        ch = make_divisible(32 * width_mult, div)
        self.stem = ConvBNAct(3, ch, 3, stride=2, act="relu6", **kw)
        idx = 0
        for stage, cfgs in enumerate((CFGS_STAGE1, CFGS_STAGE2)):
            for t, c, n, s in cfgs:
                out_ch = make_divisible(c * width_mult, div)
                for i in range(n):
                    hidden = hidden_overrides[idx] if hidden_overrides else None
                    self.add_module(f"block{idx}", InvertedResidual(
                        ch, out_ch, s if i == 0 else 1, t,
                        hidden_features=hidden, **kw))
                    ch = out_ch
                    idx += 1
            if stage == 0:
                self.c4_features = ch
                self.c4_blocks = idx
        self.num_blocks = idx
        self.c5_features = head_features or (
            make_divisible(1280 * width_mult, div) if width_mult > 1.0 else 1280)
        self.head_conv = ConvBNAct(ch, self.c5_features, 1, act="relu6", **kw)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        for idx in range(self.num_blocks):
            x = getattr(self, f"block{idx}")(x)
            if idx + 1 == self.c4_blocks:
                c4 = x  # stride 16
        return c4, self.head_conv(x)  # stride 32
