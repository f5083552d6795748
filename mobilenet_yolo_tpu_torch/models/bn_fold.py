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
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from mobilenet_yolo_tpu_torch.models.layers import BN_EPS, ConvBNAct


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
