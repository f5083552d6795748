"""BatchNorm folding for inference.

Port of ``mobilenet_yolo_tpu/models/bn_fold.py:23-65``. Every conv+BN pair
(every ``ConvBNAct``) is folded into the conv weight:

    weight' = weight * gamma / sqrt(var + eps)   (per output channel, OIHW dim 0)
    bias'   = beta - mean * gamma / sqrt(var + eps)

and the BN is rewritten to the identity (scale 1, bias bias', mean 0, var
1 - eps), so the folded ``state_dict`` is the one ``convert.py`` gives from
JAX's ``fold_batchnorm(variables)``. ``HeadStack.out`` has no BN and stays
as it is.

The folded modules do not run the BN: each ``ConvBNAct`` is one biased
conv, and the MobileNetV2 backbone runs its blocks through the fused CUDA
kernels (``kernels/fused_block.py``; ``models/mobilenetv2.py``). The folded
model is for inference: in train mode it raises.

``calibrate_bn`` sets a model's BatchNorm statistics from one batch, so a
randomly initialised model can be served (and folded) with scores that do
not tie.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from mobilenet_yolo_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, ConvBNAct


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """A folded copy of ``model``; ``model`` itself is left as it was."""
    folded = copy.deepcopy(model)
    with torch.no_grad():
        for m in folded.modules():
            if not isinstance(m, ConvBNAct):
                continue
            bn = m.bn
            rstd = 1.0 / torch.sqrt(bn.running_var + BN_EPS)
            factor = bn.weight * rstd
            m.conv.weight.mul_(factor.reshape(-1, 1, 1, 1))
            bn.bias.copy_(bn.bias - bn.running_mean * factor)
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0 - BN_EPS)
            m.folded = True
    return folded


def calibrate_bn(model: nn.Module, images_nhwc: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    ``images`` (one train-mode pass, cumulative average) and leave the
    model in eval mode.

    Straight from the init, the (0, 1) statistics let eval-mode activations
    shrink ~C-fold at every depthwise conv (fan-out init over 9 inputs):
    the heads give logits of ~1e-10, every score ties at 0.25 and NMS sees
    one class. Calibrated, activations keep unit scale and scores spread.
    """
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    model.train()
    with torch.no_grad():
        model(images_nhwc.permute(0, 3, 1, 2))
    for bn in bns:
        bn.momentum = BN_MOMENTUM
    model.eval()
