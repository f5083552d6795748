"""Anchor-grid construction.

Port of ``mobilenet_yolo_tpu/ops/anchors.py:15-31`` (``grid_xy``,
``scaled_anchors``).
"""

from __future__ import annotations

import numpy as np
import torch


def grid_xy(in_w: int, in_h: int, *, device=None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(in_h, in_w, 2) tensor of cell indices (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(in_h, device=device, dtype=dtype),
                            torch.arange(in_w, device=device, dtype=dtype),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def scaled_anchors(anchors, img_w: int, img_h: int) -> np.ndarray:
    """Anchors in pixels -> fraction-of-image units, with the (w, h)
    normalisation the JAX package uses (``anchors.py:22-31``)."""
    a = np.asarray(anchors, dtype=np.float32)
    return a / np.asarray([img_w, img_h], dtype=np.float32)
