"""MobileNetV2 backbone (torch, NCHW).

Port of ``mobilenet_yolo_tpu/models/mobilenetv2.py:17-84``: a 3x3/2 stem,
inverted-residual blocks ``block0``..``block16`` and a 1x1 ``head_conv``.
``forward`` returns both taps ``(c4 stride-16, c5 stride-32)``.

A backbone that ``models/bn_fold.py:fold_batchnorm`` produced runs, in eval
mode, its stem and blocks through the fused CUDA kernels
(``kernels/fused_block.py``): ``stem`` + ``block0`` through
``fused_stem_block0``, the stride-2 blocks through
``fused_inverted_residual_s2`` and the others through
``fused_inverted_residual`` (residual where the block is an identity).
That is 1 + 4 + 12 = 17 launches per forward at the MobileNetV2 widths.
``head_conv`` stays a cuDNN conv with the folded bias. A pruned block's
hidden width (any width ``prune.plan_prune`` emits, odd ones too) reaches
the kernels zero-padded to a multiple of 8, which keeps their 16-byte
copies and is exact (``_block_weights``).

``remat=True`` (``config["remat"]`` through ``build_model``) recomputes each
block's activations in the backward instead of storing them, as the JAX
``nn.remat`` does (``mobilenetv2.py:39-56``): the blocks, not the stem and
not ``head_conv``, run under ``layers.rematerialized`` whenever autograd
records. The parameters and their names are those of the plain model. A
folded backbone ignores it: it runs in eval mode only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mobilenet_yolo_tpu_torch.kernels.fused_block import (
    fused_inverted_residual,
    fused_inverted_residual_s2,
    fused_stem_block0,
)
from mobilenet_yolo_tpu_torch.models.layers import (
    ConvBNAct,
    InvertedResidual,
    check_inference,
    make_divisible,
    rematerialized,
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
                 head_features: int | None = None, remat: bool = False, *, device=None,
                 dtype=None, generator: torch.Generator | None = None):
        super().__init__()
        self.remat = remat
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
        if self.stem.folded:
            return self._forward_fused(x)
        x = self.stem(x)
        remat = self.remat and torch.is_grad_enabled()
        for idx in range(self.num_blocks):
            block = getattr(self, f"block{idx}")
            x = rematerialized(block, x) if remat else block(x)
            if idx + 1 == self.c4_blocks:
                c4 = x  # stride 16
        return c4, self.head_conv(x)  # stride 32

    def _forward_fused(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The folded forward through the fused kernels, in NHWC. Autocast
        does not reach the kernels, so under it the activations and weights
        are cast to its dtype here."""
        check_inference(self)
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        y = x.permute(0, 2, 3, 1).to(dtype).contiguous()  # no copy for channels_last input
        y = fused_stem_block0(y, *_stem_weights(self.stem, self.block0, dtype))
        for idx in range(1, self.num_blocks):
            block = getattr(self, f"block{idx}")
            weights = _block_weights(block, dtype)
            if block.depthwise.conv.stride[0] == 2:
                y = fused_inverted_residual_s2(y, *weights)
            else:
                y = fused_inverted_residual(y, *weights, residual=block.identity)
            if idx + 1 == self.c4_blocks:
                c4 = y
        return c4.permute(0, 3, 1, 2), self.head_conv(y.permute(0, 3, 1, 2))


def _weight(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


# hidden widths reach the block kernels in multiples of this (16 bytes of bf16)
HIDDEN_MULTIPLE = 8


def _block_weights(block: InvertedResidual, dtype: torch.dtype) -> tuple:
    """A folded block's weights in the kernels' layout: w1 (Cin, Ch), b1,
    wdw (3, 3, Ch), bdw, w2 (Ch, Cout), b2, with Ch zero-padded to a
    multiple of ``HIDDEN_MULTIPLE``. The padding is exact: a padded hidden
    channel is relu6(0) = 0 after the expand and after the depthwise, and
    meets zero rows of w2."""
    if block.expand is None:
        raise ValueError("the fused blocks need an expand conv (expand ratio > 1)")
    w1, b1 = block.expand.conv.weight[:, :, 0, 0].t(), block.expand.bn.bias
    wdw, bdw, w2, b2 = _block_weights_tail(block, dtype)
    pad = -w1.shape[1] % HIDDEN_MULTIPLE
    if pad:
        w1, b1, wdw, bdw = (F.pad(t, (0, pad)) for t in (w1, b1, wdw, bdw))
        w2 = F.pad(w2, (0, 0, 0, pad))
    return _weight(w1, dtype), b1, wdw, bdw, w2, b2


def _stem_weights(stem: ConvBNAct, block0: InvertedResidual, dtype: torch.dtype) -> tuple:
    """k_stem (3, 3, 3, Ch) HWIO, b_stem, and block 0's wdw, bdw, w2, b2."""
    if block0.expand is not None:
        raise ValueError("the fused stem takes a block 0 without an expand conv")
    return (_weight(stem.conv.weight.permute(2, 3, 1, 0), dtype), stem.bn.bias,
            *_block_weights_tail(block0, dtype))


def _block_weights_tail(block: InvertedResidual, dtype: torch.dtype) -> tuple:
    """wdw (3, 3, Ch), bdw, w2 (Ch, Cout), b2."""
    return (_weight(block.depthwise.conv.weight[:, 0].permute(1, 2, 0), dtype),
            block.depthwise.bn.bias,
            _weight(block.project.conv.weight[:, :, 0, 0].t(), dtype), block.project.bn.bias)
