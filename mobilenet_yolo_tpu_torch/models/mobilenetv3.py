"""MobileNetV3 backbones (torch, NCHW).

Port of ``mobilenet_yolo_tpu/models/mobilenetv3.py:15-115``. Large: an
hswish stem, the 13-block ``bneck`` stage (tap c4, 160 channels, stride
16), the 2-block ``bneck2_`` stage and a 1x1 ``head_conv`` to 960 channels
with hswish (tap c5, stride 32). Small: the single-tap 576-channel variant
(no detector builds on it; it is part of what the JAX package offers).

``hidden_overrides`` carries channel-pruned expansion widths in slot order,
``bneck0..`` then ``bneck2_0..`` (``prune.py``); ``head_features`` the
pruned width of Large's ``head_conv``. ``remat=True`` recomputes each bneck
in the backward through ``layers.rematerialized``, as ``nn.remat(MBv3Block)``
does: the blocks, not the stem and not ``head_conv``. A BatchNorm-folded
MobileNetV3 runs every conv as a biased cuDNN conv; the fused kernels hold
MobileNetV2 blocks only.
"""

from __future__ import annotations

import torch
from torch import nn

from mobilenet_yolo_tpu_torch.models.layers import (
    ConvBNAct,
    MBv3Block,
    hswish,
    rematerialized,
)

# (kernel, expand, out, act, se, stride) — mobilenetv3.py:15-34
LARGE_STAGE1 = [
    (3, 16, 16, "relu", False, 1),
    (3, 64, 24, "relu", False, 2),
    (3, 72, 24, "relu", False, 1),
    (5, 72, 40, "relu", True, 2),
    (5, 120, 40, "relu", True, 1),
    (5, 120, 40, "relu", True, 1),
    (3, 240, 80, "hswish", False, 2),
    (3, 200, 80, "hswish", False, 1),
    (3, 184, 80, "hswish", False, 1),
    (3, 184, 80, "hswish", False, 1),
    (3, 480, 112, "hswish", True, 1),
    (3, 672, 112, "hswish", True, 1),
    (5, 672, 160, "hswish", True, 1),
]
LARGE_STAGE2 = [
    (5, 672, 160, "hswish", True, 2),
    (5, 960, 160, "hswish", True, 1),
]

# mobilenetv3.py:36-51
SMALL_STAGE1 = [
    (3, 16, 16, "relu", True, 2),
    (3, 72, 24, "relu", False, 2),
    (3, 88, 24, "relu", False, 1),
    (5, 96, 40, "hswish", True, 2),
    (5, 240, 40, "hswish", True, 1),
    (5, 240, 40, "hswish", True, 1),
    (5, 120, 48, "hswish", True, 1),
    (5, 144, 48, "hswish", True, 1),
]
SMALL_STAGE2 = [
    (5, 288, 96, "hswish", True, 2),
    (5, 576, 96, "hswish", True, 1),
    (5, 576, 96, "hswish", True, 1),
]


class _MobileNetV3(nn.Module):
    """The stem, two bneck stages and the head conv of either variant."""

    def __init__(self, stage1, stage2, head_features: int,
                 hidden_overrides: tuple[int | None, ...] | None, remat: bool, *,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.remat = remat
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.stem = ConvBNAct(3, 16, 3, stride=2, act="hswish", **kw)
        ch = 16
        self.block_names = []
        for prefix, stage, first_slot in (("bneck", stage1, 0),
                                          ("bneck2_", stage2, len(stage1))):
            for i, (k, e, c, act, se, s) in enumerate(stage):
                hidden = hidden_overrides[first_slot + i] if hidden_overrides else None
                self.add_module(f"{prefix}{i}", MBv3Block(ch, k, e, c, act, se, s, hidden,
                                                          **kw))
                self.block_names.append(f"{prefix}{i}")
                ch = c
            if prefix == "bneck":
                self.c4_features = ch
        self.c5_features = head_features
        self.head_conv = ConvBNAct(ch, head_features, 1, act="none", **kw)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        remat = self.remat and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = rematerialized(block, x) if remat else block(x)
            if not name.startswith("bneck2_"):
                c4 = x  # stride 16, the last block of the first stage
        return c4, hswish(self.head_conv(x))  # stride 32


class MobileNetV3Large(_MobileNetV3):
    """``mobilenetv3.py:54-86``: taps (c4 160 ch, c5 ``head_features`` or 960 ch)."""

    def __init__(self, hidden_overrides: tuple[int | None, ...] | None = None,
                 head_features: int | None = None, remat: bool = False, *, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__(LARGE_STAGE1, LARGE_STAGE2, head_features or 960, hidden_overrides,
                         remat, device=device, dtype=dtype, generator=generator)


class MobileNetV3Small(_MobileNetV3):
    """``mobilenetv3.py:89-115``: taps (c4 48 ch, c5 576 ch)."""

    def __init__(self, hidden_overrides: tuple[int | None, ...] | None = None,
                 remat: bool = False, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__(SMALL_STAGE1, SMALL_STAGE2, 576, hidden_overrides, remat,
                         device=device, dtype=dtype, generator=generator)
