"""The plain reference against the port's CPU path (the fused kernels'
twins), at a tiny size, with the same seeded weights."""

from __future__ import annotations

import json

import pytest
import torch

from bench_port.harness import check, inputs, system
from bench_port.harness.spec import PACKAGE
from bench_port.reference import mbv2_yolo

CONFIGS = ["mbv2-yolo-voc-352", "mbv2-yolo-bdd100k-416"]
CPU = torch.device("cpu")


def _config(name: str, size: int = 64) -> dict:
    config = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    config["img_h"] = config["img_w"] = size
    return config


@pytest.mark.parametrize("name", CONFIGS)
def test_parameters_match_the_port(name):
    from mobilenet_yolo_tpu_torch.models import build_model

    config = _config(name)
    port = build_model(config, backbone=config["backbone"], device="meta")
    ref = mbv2_yolo.build(config, device="meta")
    want = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert {n: tuple(p.shape) for n, p in ref.named_parameters()} == want


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_folded_port_on_the_cpu(name):
    config = _config(name)
    seed = 2**32 + 9
    weights, calib, gen = inputs.model_inputs(mbv2_yolo, config, seed, CPU)
    predict = system.build_predict(config, weights, calib, CPU)
    frames = inputs.draw_frames(gen, 3, 64, 64, CPU)
    outputs = [t.numpy() for t in predict(frames, torch.tensor(0.3))]
    model = check.reference_model(mbv2_yolo, config, seed, CPU)
    ref = mbv2_yolo.candidates(model, frames, config, torch.float64)
    det_gap, select_gap, flips = check._det_numbers(
        mbv2_yolo, torch.from_numpy(outputs[0]), torch.from_numpy(outputs[1]), ref,
        0.3, 0.45)
    assert det_gap < 1e-3
    assert select_gap < 1e-4
    assert flips == 0
    assert outputs[1].any()
    if "seg" in ref:
        assert abs(torch.from_numpy(outputs[2]).double() - ref["seg"]).max() < 1e-5


def test_greedy_nms_by_hand():
    boxes = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 0.9], [0, 0, 1, 0.9], [2, 2, 3, 3]]],
                         dtype=torch.float32)
    classes = torch.tensor([[0, 0, 1, 0]])
    valid = torch.tensor([[True, True, True, False]])
    keep = mbv2_yolo.greedy_nms(boxes, classes, valid, 0.45)
    assert keep.tolist() == [[True, False, True, False]]
