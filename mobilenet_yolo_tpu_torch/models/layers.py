"""Conv building blocks of MobileNetV2-YOLO (torch, NCHW modules).

Port of ``mobilenet_yolo_tpu/models/layers.py:35-59`` (activations, with
``hswish`` and ``hsigmoid``), ``:62-124`` (``ConvBNAct``,
``InvertedResidual``), ``:127-177`` (``SEModule``, ``MBv3Block``) and
``:180-259`` (``Connect``, ``DepthwiseConvolution``, ``HeadStack``,
``upsample_nearest2x``, ``part_add``, ``make_divisible``).

Submodules carry the flax names (``conv``, ``bn``, ``expand``,
``depthwise``, ``project``, ``se``, ``fc1``, ``fc2``, ``shortcut``, ``dw``,
``pw``, ``pw1``, ``pw2``, ``out``), so a state_dict key reads like the flax
variable path (``convert.py``).

Flax infers input widths at trace time; torch needs them at construction,
so every block takes ``in_features``. Flax pads by the integer
``kernel // 2`` (``layers.py:79``), which is symmetric, so torch
``padding=kernel // 2`` is the same convolution at stride 1 and 2.
Every block's BatchNorm is ``BatchNorm2d`` below, which keeps flax's
train-mode running-variance update. ``rematerialized`` runs a block under
``torch.utils.checkpoint`` as flax's ``nn.remat`` does, its BatchNorm
buffers moved once per step.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mobilenet_yolo_tpu_torch.parallel.mesh import differentiable_sum, group_size

# flax momentum 0.9 (fraction of the old running stat) == torch momentum 0.1
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x)


def hswish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6 in the JAX package's order of operations
    (``layers.py:39``): the product first, then the multiply by 1/6, which
    rounds otherwise than ``F.hardswish``'s division."""
    return x * relu6(x + 3.0) * (1.0 / 6.0)


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6 as ``layers.py:44`` computes it."""
    return relu6(x + 3.0) * (1.0 / 6.0)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu6": relu6,
    "relu": F.relu,
    "leaky": leaky_relu,
    "hswish": hswish,
    "none": lambda x: x,
}


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update stores the *biased* batch
    variance in ``running_var``, as flax's ``nn.BatchNorm`` does.

    Both frameworks normalize a training batch with the biased variance,
    but torch moves ``running_var`` toward the unbiased one, n/(n-1) larger
    (n = N*H*W per channel). Scaling the old value by n/(n-1) before torch's
    update and the result by (n-1)/n after it turns ``(1-m) old + m
    unbiased`` into ``(1-m) old + m biased`` for any momentum ``m``: two
    elementwise launches per layer and step. The state-dict keys are
    torch's, so ``convert.py`` and ``strict=True`` loads are unchanged.

    One value per channel in train mode (``SEModule``'s pooled tensor at
    batch 1), where torch raises, normalises as flax does: the biased
    variance is 0, the output is the BN bias, and the running variance
    moves toward 0.

    With a ``process_group`` of more than one rank (a data-parallel step
    sets its data group, ``set_process_group``) the train-mode statistics
    are the global batch's, as GSPMD computes them: ``_global`` sums each
    channel's values and squares (in float64) and the row count over the
    group, with the gradients summed back over it, and takes flax's
    ``E[x^2] - E[x]^2``. ``nn.SyncBatchNorm`` would refuse CPU tensors
    under a process group and move ``running_var`` toward the unbiased
    variance.
    """

    # the data group whose rows the train-mode statistics cover
    process_group = None
    # set by ``rematerialized`` while the backward recomputes this layer
    recomputing = False
    # ``rematerialized`` collects here the global sums of the first pass,
    # which its recompute takes back in order
    first_pass_sums: list | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.numel() // x.shape[1]
        if not (self.training and self.track_running_stats) or n < 1:
            return super().forward(x)
        if self.recomputing and self.first_pass_sums:
            return self._global(x, self.first_pass_sums.pop(0))
        if group_size(self.process_group) > 1:
            return self._global(x)
        if n == 1:
            return self._single_value(x)
        if self.recomputing:
            # normalise with the batch statistics as the first pass did; the
            # same op on copies of the buffers, so the recompute saves what
            # the first pass saved and moves no running statistic or count
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            self.running_var.mul_(n / (n - 1))
        out = super().forward(x)
        # a new buffer, not an in-place edit: autograd saved this one
        with torch.no_grad():
            self.running_var = self.running_var * ((n - 1) / n)
        return out

    def _global(self, x: torch.Tensor, total: torch.Tensor | None = None) -> torch.Tensor:
        """Normalise with the statistics of every rank's rows of the group.
        ``total``: the sums a first pass took, reused by remat's recompute,
        which then moves no buffer and calls no collective forward."""
        c = x.shape[1]
        xs = x if x.dtype == torch.float64 else x.float()
        # the sums in float64: in float32, E[x^2] - E[x]^2 cancels away the
        # variance of a channel whose mean is large against its spread
        f64 = torch.float64
        local = torch.cat([xs.sum(dim=(0, 2, 3), dtype=f64), (xs * xs).sum(dim=(0, 2, 3), dtype=f64),
                           xs.new_full((1,), x.numel() // c, dtype=f64)])
        sums = differentiable_sum(local, self.process_group, total)
        if total is None and self.first_pass_sums is not None:
            self.first_pass_sums.append(sums.detach())
        n = sums[2 * c:].detach()
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        mean, var = mean.to(xs.dtype), var.to(xs.dtype)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xs - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        if total is None:
            self._move_running(mean.detach(), var.detach())
        return out.to(x.dtype)

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Flax's momentum update of the running statistics (biased ``var``)."""
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            # momentum None is torch's cumulative average
            m = (self.momentum if self.momentum is not None
                 else 1.0 / float(self.num_batches_tracked))
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)

    def _single_value(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mean = x.mean(dim=(0, 2, 3))
        centred = x - mean.reshape(shape)
        var = (centred * centred).mean(dim=(0, 2, 3))
        out = (centred * torch.rsqrt(var + self.eps).reshape(shape) * self.weight.reshape(shape)
               + self.bias.reshape(shape))
        if not self.recomputing:
            self._move_running(mean.detach(), var.detach())
        return out


def set_process_group(model: nn.Module, group) -> None:
    """Make every ``BatchNorm2d`` of ``model`` take its train-mode
    statistics over ``group`` (``None``: this process's rows)."""
    for bn in model.modules():
        if isinstance(bn, BatchNorm2d):
            bn.process_group = group


@contextlib.contextmanager
def _recomputing(module: nn.Module):
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for bn in bns:
        bn.recomputing = True
    try:
        yield
    finally:
        for bn in bns:
            bn.recomputing = False


def rematerialized(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` whose activations are recomputed in the backward instead
    of stored: the counterpart of flax's ``nn.remat`` (``jax.checkpoint``).

    The recompute runs ``block`` again in train mode, where a plain
    ``checkpoint`` would move every BatchNorm's running statistics a second
    time, apply the n/(n-1) rescale of ``BatchNorm2d`` twice and count
    ``num_batches_tracked`` twice; ``nn.remat`` does none of that. The
    recompute context makes each BatchNorm normalise with the batch
    statistics and leave its buffers alone. Under a process group it
    takes back the global sums of the first pass, so the recompute calls no
    collective forward and every rank's backward calls the same ones.
    """
    for bn in block.modules():
        if isinstance(bn, BatchNorm2d):
            bn.first_pass_sums = []
    return checkpoint(block, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing(block)))


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
    """conv (no bias) -> batchnorm -> activation (``layers.py:62-93``).

    ``folded`` is set by ``models/bn_fold.py:fold_batchnorm``: the BN is then
    the identity with ``bn.bias`` as the conv's bias, so the block runs as
    one biased conv, in eval mode only.
    """

    folded = False

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
        self.bn = BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM,
                              device=device, dtype=dtype)
        self.act = ACTIVATIONS[act]
        _kaiming_out_(self.conv.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded:
            check_inference(self)
            conv = self.conv
            return self.act(F.conv2d(x, conv.weight, self.bn.bias, conv.stride, conv.padding,
                                     groups=conv.groups))
        return self.act(self.bn(self.conv(x)))


def check_inference(module: nn.Module) -> None:
    """BatchNorm-folded weights are for inference: train mode raises."""
    if module.training:
        raise RuntimeError("a BatchNorm-folded model runs in eval mode only; its folded "
                           "weights are for inference (call .eval())")


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


class SEModule(nn.Module):
    """Squeeze-excite with an hsigmoid gate (``layers.py:127-139``). Its
    BatchNorms see the pooled (B, C, 1, 1) tensor: B values a channel."""

    def __init__(self, features: int, reduction: int = 4, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fc1 = ConvBNAct(features, features // reduction, 1, act="relu", **kw)
        self.fc2 = ConvBNAct(features // reduction, features, 1, act="none", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * hsigmoid(self.fc2(self.fc1(s)))


class MBv3Block(nn.Module):
    """MobileNetV3 bneck (``layers.py:142-177``): expand, depthwise
    (``kernel`` 3 or 5), project, an optional ``SEModule`` on the project's
    output, and the reference's shortcut at stride 1: the input itself, or a
    1x1 conv-BN ``shortcut`` where the width changes.

    ``hidden_features`` overrides the expansion width (default ``expand``),
    the seam channel pruning uses; the SE gates the project output, so a
    hidden cut leaves it alone.
    """

    def __init__(self, in_features: int, kernel: int, expand: int, features: int, act: str,
                 use_se: bool, stride: int, hidden_features: int | None = None, *,
                 device=None, dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        hidden = hidden_features or expand
        self.expand = ConvBNAct(in_features, hidden, 1, act=act, **kw)
        self.depthwise = ConvBNAct(hidden, hidden, kernel, stride=stride, depthwise=True,
                                   act=act, **kw)
        self.project = ConvBNAct(hidden, features, 1, act="none", **kw)
        self.se = SEModule(features, **kw) if use_se else None
        self.residual = stride == 1
        self.shortcut = (ConvBNAct(in_features, features, 1, act="none", **kw)
                         if self.residual and in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.depthwise(self.expand(x)))
        if self.se is not None:
            y = self.se(y)
        if self.residual:
            y = y + (x if self.shortcut is None else self.shortcut(x))
        return y


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
