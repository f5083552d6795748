"""Conv building blocks of MobileNetV2-YOLO (torch, NCHW modules).

Port of ``mobilenet_yolo_tpu/models/layers.py:35-59`` (activations),
``:62-124`` (``ConvBNAct``, ``InvertedResidual``) and ``:180-259``
(``Connect``, ``DepthwiseConvolution``, ``HeadStack``,
``upsample_nearest2x``, ``part_add``, ``make_divisible``).

Submodules carry the flax names (``conv``, ``bn``, ``expand``,
``depthwise``, ``project``, ``dw``, ``pw``, ``pw1``, ``pw2``, ``out``), so a
state_dict key reads like the flax variable path (``convert.py``).

Flax infers input widths at trace time; torch needs them at construction,
so every block takes ``in_features``. Flax pads by the integer
``kernel // 2`` (``layers.py:79``), which is symmetric, so torch
``padding=kernel // 2`` is the same convolution at stride 1 and 2.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F

# flax momentum 0.9 (fraction of the old running stat) == torch momentum 0.1
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu6": relu6,
    "relu": F.relu,
    "leaky": leaky_relu,
    "none": lambda x: x,
}


def _kaiming_out_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """flax ``variance_scaling(2.0, "fan_out", "truncated_normal")``.

    The flax fan-out of an HWIO kernel is ``H * W * O`` — for a depthwise
    kernel ``(3, 3, 1, C)`` that is ``9 * C``. The truncated normal is cut
    at two standard deviations and rescaled by 0.8796 to keep the variance.
    """
    out_ch, _, kh, kw = weight.shape
    std = (2.0 / (kh * kw * out_ch)) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)


class ConvBNAct(nn.Module):
    """conv (no bias) -> batchnorm -> activation (``layers.py:62-93``)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, depthwise: bool = False, act: str = "leaky",
                 *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if depthwise and in_features != features:
            raise ValueError(f"depthwise conv keeps its width: {in_features} -> {features}")
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride,
                              padding=kernel // 2,
                              groups=in_features if depthwise else 1,
                              bias=False, device=device, dtype=dtype)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM,
                                 device=device, dtype=dtype)
        self.act = ACTIVATIONS[act]
        _kaiming_out_(self.conv.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted-residual bottleneck (``layers.py:96-124``).

    ``hidden_features`` overrides the expansion width (default
    ``round(in_features * expand_ratio)``), the seam channel pruning uses.
    """

    def __init__(self, in_features: int, features: int, stride: int,
                 expand_ratio: int, hidden_features: int | None = None,
                 *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        hidden = hidden_features or round(in_features * expand_ratio)
        self.identity = stride == 1 and in_features == features
        if expand_ratio != 1:
            self.expand = ConvBNAct(in_features, hidden, 1, act="relu6", **kw)
        else:
            self.expand = None
            hidden = in_features
        self.depthwise = ConvBNAct(hidden, hidden, 3, stride=stride,
                                   depthwise=True, act="relu6", **kw)
        self.project = ConvBNAct(hidden, features, 1, act="none", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.depthwise(y))
        return x + y if self.identity else y


class Connect(nn.Module):
    """x + convs(x) residual refinement (``layers.py:180-190``)."""

    def __init__(self, channels: int, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dw = ConvBNAct(channels, channels, 3, depthwise=True, **kw)
        self.pw = ConvBNAct(channels, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pw(self.dw(x))


class DepthwiseConvolution(nn.Module):
    """dw3x3 -> pw1x1 (same ch) -> pw1x1 (out ch) (``layers.py:193-205``)."""

    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dw = ConvBNAct(in_features, in_features, 3, depthwise=True, **kw)
        self.pw1 = ConvBNAct(in_features, in_features, 1, **kw)
        self.pw2 = ConvBNAct(in_features, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw2(self.pw1(self.dw(x)))


class HeadStack(nn.Module):
    """dw3x3 -> pw1x1 -> pw1x1(mid) -> 1x1 conv with bias to raw outputs
    (``layers.py:208-229``). The ``out`` conv starts at N(0, 0.01) with a
    zero bias, as in flax (see the reason at ``layers.py:222-225``)."""

    def __init__(self, in_features: int, mid: int, out: int, *, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.dw = ConvBNAct(in_features, in_features, 3, depthwise=True, **kw)
        self.pw1 = ConvBNAct(in_features, in_features, 1, **kw)
        self.pw2 = ConvBNAct(in_features, mid, 1, **kw)
        self.out = nn.Conv2d(mid, out, 1, bias=True, device=device, dtype=dtype)
        with torch.no_grad():
            self.out.weight.normal_(0.0, 0.01, generator=generator)
            self.out.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.pw2(self.pw1(self.dw(x))))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (``layers.py:232-237``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def part_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Channel-partial residual add on NCHW tensors (``layers.py:240-249``):
    add the common channel prefix, concat the wider input's leftover."""
    cx, cy = x.shape[1], y.shape[1]
    if cx == cy:
        return x + y
    n = min(cx, cy)
    rest = y[:, n:] if cy > cx else x[:, n:]
    return torch.cat([x[:, :n] + y[:, :n], rest], dim=1)


def make_divisible(v, divisor, min_value=None):
    """Channel rounding (``layers.py:252-259``)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
