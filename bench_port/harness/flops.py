"""The yardstick's arithmetic: the card's peaks, the model's operations,
and the least time each fused launch could take.

* Operations are those the model needs: convolutions and matrix products,
  counted by ``torch.utils.flop_counter`` over the plain reference on meta
  tensors at the cell's shapes (groups-aware), never the passes an
  implementation makes.
* Bytes count each input read once, each weight once and each output
  written once, in the type the kernel reads and writes.
* float32 work is held against the card's TF32 tensor rate, the fastest
  route a float32-accurate implementation can take, so no kernel can
  read over 100%.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense: FLOP/s by operand type, HBM bytes/s
PEAKS = {
    "H100": {"tf32": 494.7e12, "float32_cuda_cores": 67e12, "bfloat16": 989e12,
             "hbm_bytes": 3.35e12},
}
PEAK_FOR = {"float32": "tf32", "bfloat16": "bfloat16"}


def peaks(device_name: str) -> dict | None:
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None


def count_flops(fn, *args) -> float:
    """FLOPs of one call of ``fn(*args)``: convolutions and matrix
    products only, elementwise work not counted."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops())


def model_flops_per_image(reference, config: dict) -> float:
    """The reference forward's FLOPs for one frame at the configuration's
    size, on meta tensors (nothing is computed)."""
    model = reference.build(config, device="meta")
    x = torch.empty((1, 3, config["img_h"], config["img_w"]), device="meta")
    return count_flops(model, x)


@dataclass(frozen=True)
class Launch:
    """One fused launch's work for one frame, and its weight bytes."""
    name: str
    flops: float
    act_bytes: float
    weight_bytes: float

    def bound_s(self, frames: int, table: dict, precision: str) -> float:
        t_ops = frames * self.flops / table[PEAK_FOR[precision]]
        t_bytes = (frames * self.act_bytes + self.weight_bytes) / table["hbm_bytes"]
        return max(t_ops, t_bytes)


def block_launch(h: int, w: int, cin: int, ch: int, cout: int, stride: int,
                 elem: int = 4) -> Launch:
    """An inverted residual (expand 1x1, depthwise 3x3, project 1x1; the
    residual add reads the input already read) on an h x w input."""
    ho, wo = h // stride, w // stride
    flops = 2 * h * w * cin * ch + 2 * ho * wo * ch * 9 + 2 * ho * wo * ch * cout
    acts = (h * w * cin + ho * wo * cout) * elem
    weights = (cin * ch + ch + 9 * ch + ch + ch * cout + cout) * 4
    return Launch(f"block s{stride} {h}x{w} {cin}-{ch}-{cout}", flops, acts, weights)


def stem_launch(h: int, w: int, ch: int, cout: int, elem: int = 4) -> Launch:
    """The stem (3x3/2 conv, 3 -> ch) fused with block 0 (depthwise 3x3 and
    project ch -> cout, no expand) on an h x w x 3 input."""
    ho, wo = h // 2, w // 2
    flops = 2 * ho * wo * 27 * ch + 2 * ho * wo * ch * 9 + 2 * ho * wo * ch * cout
    acts = (h * w * 3 + ho * wo * cout) * elem
    weights = (27 * ch + ch + 9 * ch + ch + ch * cout + cout) * 4
    return Launch(f"stem {h}x{w} 3-{ch}-{cout}", flops, acts, weights)


def fused_launches(reference, config: dict, elem: int = 4) -> list[Launch]:
    """The folded backbone's fused launches in launch order: the stem with
    block 0, then blocks 1 to the last, at the configuration's size."""
    model = reference.build(config, device="meta")
    bb = model.backbone
    blocks = bb.blocks()
    h, w = config["img_h"] // 2, config["img_w"] // 2
    _, ch0, cout0, _ = blocks[0].shape
    out = [stem_launch(config["img_h"], config["img_w"], ch0, cout0, elem)]
    for block in blocks[1:]:
        cin, ch, cout, stride = block.shape
        out.append(block_launch(h, w, cin, ch, cout, stride, elem))
        h, w = h // stride, w // stride
    return out
