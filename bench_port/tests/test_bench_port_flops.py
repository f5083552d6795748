"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import json

import pytest
import torch

from bench_port.harness import flops
from bench_port.harness.spec import PACKAGE
from bench_port.reference import mbv2_yolo

VOC = json.loads((PACKAGE / "configs" / "mbv2-yolo-voc-352.json").read_text())
H100 = flops.PEAKS["H100"]


def _counted(module, shape):
    return flops.count_flops(module, torch.empty(shape, device="meta"))


def test_stride1_block_by_hand():
    # block 3 of MobileNetV2 at 352: 44x44, 32 -> 192 -> 32, residual
    launch = flops.block_launch(44, 44, 32, 192, 32, 1)
    hand = 2 * 44 * 44 * 32 * 192 + 2 * 44 * 44 * 192 * 9 + 2 * 44 * 44 * 192 * 32
    assert launch.flops == hand
    assert launch.act_bytes == (44 * 44 * 32 + 44 * 44 * 32) * 4
    assert launch.weight_bytes == (32 * 192 + 192 + 9 * 192 + 192 + 192 * 32 + 32) * 4
    block = mbv2_yolo.InvertedResidual(32, 32, 1, 6, device="meta")
    assert _counted(block, (1, 32, 44, 44)) == hand


def test_stride2_block_by_hand():
    # block 1 at 352: 176x176 -> 88x88, 16 -> 96 -> 24
    launch = flops.block_launch(176, 176, 16, 96, 24, 2)
    hand = 2 * 176 * 176 * 16 * 96 + 2 * 88 * 88 * 96 * 9 + 2 * 88 * 88 * 96 * 24
    assert launch.flops == hand
    assert launch.act_bytes == (176 * 176 * 16 + 88 * 88 * 24) * 4
    block = mbv2_yolo.InvertedResidual(16, 24, 2, 6, device="meta")
    assert _counted(block, (1, 16, 176, 176)) == hand


def test_stem_with_block0_by_hand():
    launch = flops.stem_launch(352, 352, 32, 16)
    hand = 2 * 176 * 176 * 27 * 32 + 2 * 176 * 176 * 32 * 9 + 2 * 176 * 176 * 32 * 16
    assert launch.flops == hand
    assert launch.act_bytes == (352 * 352 * 3 + 176 * 176 * 16) * 4
    assert launch.weight_bytes == (27 * 32 + 32 + 9 * 32 + 32 + 32 * 16 + 16) * 4
    stem = mbv2_yolo.ConvBNAct(3, 32, 3, 2, act="relu6", device="meta")
    block0 = mbv2_yolo.InvertedResidual(32, 16, 1, 1, device="meta")
    got = _counted(stem, (1, 3, 352, 352)) + _counted(block0, (1, 32, 176, 176))
    assert got == hand


def test_fused_launches_cover_the_backbone_blocks():
    launches = flops.fused_launches(mbv2_yolo, VOC)
    assert len(launches) == 17
    bb = mbv2_yolo.build(VOC, device="meta").backbone
    total, h = _counted(bb.stem, (1, 3, 352, 352)), 176
    for block in bb.blocks():
        total += _counted(block, (1, block.shape[0], h, h))
        h //= block.shape[3]
    assert sum(launch.flops for launch in launches) == total


def test_bound_takes_the_larger_of_operations_and_bytes():
    launch = flops.block_launch(44, 44, 32, 192, 32, 1)
    b = 128
    t_ops = b * launch.flops / H100["tf32"]
    t_bytes = (b * launch.act_bytes + launch.weight_bytes) / H100["hbm_bytes"]
    assert launch.bound_s(b, H100, "float32") == pytest.approx(max(t_ops, t_bytes), rel=1e-12)


def test_model_flops_per_image():
    # the count at 352: 2.777 GFLOP a frame (convolutions only)
    assert flops.model_flops_per_image(mbv2_yolo, VOC) == pytest.approx(2.7769984e9, rel=1e-9)
    assert flops.peaks("NVIDIA H100 80GB HBM3") is H100
    assert flops.peaks("cpu") is None
