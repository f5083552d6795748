"""The augmentation kernels against the plain ops at small shapes, on the card
(port of ``tools/probe_pallas_aug.py``).

Run it first after a change to ``csrc/slot_aug.cu`` or ``csrc/aug_compose.cu``:
it launches each kernel once with noise on, then holds it against the plain
ops with noise off, so both sides see the same pixels:

* ``slot_aug`` (float32 out) against ``planned_color_jitter``: max
  difference below 2e-2 (``probe_pallas_aug.py:60``);
* ``aug_compose`` (bf16 out) against ``geometric_compose`` with the programs
  (float32), mixed active tiles: max below 5.0 and mean below 1.0
  (``probe_pallas_aug.py:97``).

    python -m mobilenet_yolo_tpu_torch.tools.probe_aug_kernels [--size 64] \\
        [--slots 4] [--dtype f32|bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.kernels.aug_compose import aug_compose
from mobilenet_yolo_tpu_torch.kernels.slot_aug import slot_aug
from mobilenet_yolo_tpu_torch.ops.device_augment import geometric_compose, planned_color_jitter
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.train.synthetic import random_program

SLOT_TOL = 2e-2
COMPOSE_MAX_TOL, COMPOSE_MEAN_TOL = 5.0, 1.0
SEED = 7


def _programs(rng: np.random.Generator, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    plans = [random_program(rng) for _ in range(n)]
    return (torch.from_numpy(np.stack([p[0] for p in plans])).to(device),
            torch.from_numpy(np.stack([p[1] for p in plans])).to(device))


def run(size: int = 64, slots: int = 4, dtype: str = "f32", device="cuda") -> dict:
    device = tool_device(device)
    rng = np.random.default_rng(0)
    n, s = slots, size
    out_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.from_numpy(rng.integers(0, 255, (n, s, s, 3)).astype(np.uint8)).to(device)
    ops, facs = _programs(rng, n, device)
    gate = torch.from_numpy(rng.random(n) < 0.5).to(device)
    per_channel = torch.from_numpy(rng.random(n) < 0.3).to(device)
    out = slot_aug(x, SEED, gate, torch.full((n,), 8.0, device=device), per_channel, ops, facs,
                   dtype=out_dtype)
    result = {"device": device_name(device), "slot_aug_shape": list(out.shape),
              "slot_aug_range": [float(out.min()), float(out.max())]}

    off = torch.zeros(n, dtype=torch.bool, device=device)
    got = slot_aug(x, SEED, off, torch.zeros(n, device=device), off, ops, facs,
                   dtype=torch.float32)
    want = planned_color_jitter(x, ops, facs)
    result["slot_aug_max_abs_err"] = float((got.permute(0, 2, 3, 1) - want).abs().max())
    if not result["slot_aug_max_abs_err"] < SLOT_TOL:
        raise RuntimeError(f"slot_aug vs planned_color_jitter: {result['slot_aug_max_abs_err']}")

    b = max(2, n // 4)
    slots_b = torch.from_numpy(rng.integers(0, 255, (b, 4, s, s, 3)).astype(np.uint8)).to(device)
    src = torch.tensor([0.1, 0.05, 0.9, 0.85], device=device).repeat(b, 4, 1)
    dst = torch.tensor([[0, 0, .5, .5], [.5, 0, 1, .5], [0, .5, .5, 1], [.5, .5, 1, 1]],
                       device=device).repeat(b, 1, 1)
    opsb, facb = (t.reshape(b, 4, 5) for t in _programs(rng, b * 4, device))
    fill_color = torch.full((b, 4, 3), 99.0, device=device)
    fill_from_mean = torch.from_numpy(rng.random((b, 4)) < 0.5).to(device)
    flip = torch.from_numpy(rng.random((b, 4)) < 0.5).to(device)
    active = torch.from_numpy(np.concatenate([np.ones((b, 1), bool),
                                              rng.random((b, 3)) < 0.7], axis=1)).to(device)
    place = (src, dst, dst, fill_color, fill_from_mean, flip, active)
    off_b = torch.zeros((b, 4), dtype=torch.bool, device=device)
    got = aug_compose(slots_b, SEED, off_b, torch.zeros((b, 4), device=device), off_b, opsb, facb,
                      *place, (s, s))
    want = geometric_compose(slots_b, *place, (s, s), jitter_op=opsb, jitter_factor=facb)
    d = (got.float() - want).abs()
    result["aug_compose_max_abs_err"], result["aug_compose_mean_abs_err"] = (
        float(d.max()), float(d.mean()))
    if not (d.max() < COMPOSE_MAX_TOL and d.mean() < COMPOSE_MEAN_TOL):
        raise RuntimeError(f"aug_compose vs geometric_compose: max {float(d.max())}, "
                           f"mean {float(d.mean())}")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.size, args.slots, args.dtype, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
