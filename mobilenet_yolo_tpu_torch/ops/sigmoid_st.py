"""Straight-through sigmoid: sigmoid forward, identity backward.

Port of ``mobilenet_yolo_tpu/ops/sigmoid_st.py:16-30`` (a ``jax.custom_vjp``)
as a ``torch.autograd.Function``. With the weighted-MSE loss this gives the
conf/class/xy logits the ``(sigma(x) - t)`` gradient shape the reference
trains with (reference models/yolo_loss.py:15-32); a plain ``torch.sigmoid``
would multiply every such gradient by ``sigma'(x)``.
"""

from __future__ import annotations

import torch


class _SigmoidST(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad


def sigmoid_st(x: torch.Tensor) -> torch.Tensor:
    """sigmoid forward, identity backward."""
    return _SigmoidST.apply(x)
