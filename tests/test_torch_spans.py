"""The port's ``myt:`` spans (``utils/profiling.py:span``), on the CPU.

A tiny BatchNorm-folded predict of the VOC and the VOC + seg model, raw
uint8 frames normalised on the device, under ``torch.profiler``: every
stage span once a call, one after another in the order of the work, and
outputs bit for bit those of the same calls with no profiler. With no
profiler a span is one shared no-op and builds no ``record_function``. A
device-geometry training step opens ``myt:augment``, ``myt:loss`` (with the
model's spans inside), ``myt:backward`` and ``myt:optimizer``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu_torch.config import load_yaml
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.bn_fold import calibrate_bn, fold_batchnorm
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step)
from mobilenet_yolo_tpu_torch.utils import profiling

from _torch_parity import REPO, SMALL_YOLO_CONFIG, geometry_batch

VOC = REPO / "mobilenet_yolo_tpu_torch" / "configs" / "voc" / "config.yaml"
PREDICT_STAGES = ["myt:normalise", "myt:backbone", "myt:heads", "myt:seg_head", "myt:decode",
                  "myt:select", "myt:nms"]


def _served(variant: str):
    cfg = load_yaml(str(VOC))
    if variant == "seg":
        cfg["seg"] = {"num_classes": 4}
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                                                dtype=np.uint8))
    calibrate_bn(model, (frames.float() / 255.0 - 0.45) / 0.25)
    predict = make_predict_fn(fold_batchnorm(model), cfg, normalize=True)
    return predict, frames, torch.tensor(0.3)


def _spans(prof) -> list[tuple[float, float, str]]:
    # "myt::<op>" are the kernels' registered ops, not spans
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith("myt:") and not e.name.startswith("myt::"))


def _record() -> torch.profiler.profile:
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("variant", ["voc", "seg"])
def test_predict_spans_nest_in_the_order_of_the_work(variant):
    predict, frames, val_conf = _served(variant)
    with _record() as prof:
        for _ in range(2):
            predict(frames, val_conf)
    spans = _spans(prof)
    want = [n for n in PREDICT_STAGES if variant == "seg" or n != "myt:seg_head"]
    assert [name for _, _, name in spans] == 2 * want
    # no stage holds another: each closes before the next opens
    assert all(b <= a2 for (_, b, _), (a2, _, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("variant", ["voc", "seg"])
def test_predict_outputs_equal_with_the_profiler_on(variant):
    predict, frames, val_conf = _served(variant)
    off = predict(frames, val_conf)
    with _record():
        on = predict(frames, val_conf)
    assert len(on) == len(off) == (3 if variant == "seg" else 2)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_span_with_no_profiler_is_one_shared_no_op(monkeypatch):
    predict, frames, val_conf = _served("voc")
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    assert profiling.span("myt:decode") is profiling.span("myt:nms") is profiling._NO_SPAN
    predict(frames, val_conf)
    assert made == []


def test_geometry_step_spans():
    batch = geometry_batch(np.random.default_rng(2), 2, 32)
    model = build_model(SMALL_YOLO_CONFIG, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model)
    step = make_geometry_train_step(model, SMALL_YOLO_CONFIG, fused_aug=False)
    args = (*(torch.from_numpy(batch[k]) for k in GEOMETRY_BATCH_KEYS),
            torch.from_numpy(batch["gt"]), torch.from_numpy(batch["n_gt"]), 5)
    with _record() as prof:
        step(state, *args, out_hw=(32, 32))
    spans = _spans(prof)
    outer = [name for a, b, name in spans
             if not any(a2 <= a and b <= b2 and (a2, b2) != (a, b) for a2, b2, _ in spans)]
    assert outer == ["myt:augment", "myt:loss", "myt:backward", "myt:optimizer"]
    (a, b), = [(a, b) for a, b, name in spans if name == "myt:loss"]
    assert [name for a2, b2, name in spans if a <= a2 and b2 <= b and name != "myt:loss"] == [
        "myt:backbone", "myt:heads"]
