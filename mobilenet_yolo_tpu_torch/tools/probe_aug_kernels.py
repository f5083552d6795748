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

``--bench`` times both kernels on the card instead, on the
``train/synthetic.py`` geometry batch (the loader's traffic, drawn from
seed S) at ``--batch`` (32) and ``--size`` (352): CUDA events per call,
and each CUDA kernel's device time per call from ``torch.profiler``, the
statistics pre-pass apart from the pixel pass, as one JSON line.
``--traffic`` replaces every slot's plan by one class, to show where the
pixel pass spends its time: ``copy`` (no noise, identity program),
``noise`` (the loader's noise draws on every slot, identity program) or
``color`` (no noise, a hue step then a gamma step); ``loader`` (the
default) keeps the batch's own plans.

    python -m mobilenet_yolo_tpu_torch.tools.probe_aug_kernels --bench \\
        [--batch 32] [--size 352] [--iters 20] [--traffic loader|copy|noise|color]
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
from mobilenet_yolo_tpu_torch.train.synthetic import (HUE_MAX, random_geometry_batch,
                                                      random_program)
from mobilenet_yolo_tpu_torch.utils.profiling import device_ms, kernel_ms_by_name

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


NOISE_SEED = 1234
TRAFFIC = ("loader", "copy", "noise", "color")


def slot_class(batch: dict, traffic: str, rng: np.random.Generator) -> dict:
    """``batch`` with every slot's noise and program replaced by one class
    of ``TRAFFIC`` (``loader``: unchanged)."""
    if traffic not in TRAFFIC:
        raise ValueError(f"traffic is one of {TRAFFIC}, not {traffic!r}")
    if traffic == "loader":
        return batch
    out = dict(batch)
    shape = batch["noise_gate"].shape
    out["noise_gate"] = np.full(shape, traffic == "noise")
    ops = np.full(shape + (5,), -1, np.int32)
    facs = np.ones(shape + (5,), np.float32)
    if traffic == "color":
        ops[..., 0], ops[..., 1] = 3, 4
        facs[..., 0] = rng.uniform(-HUE_MAX, HUE_MAX, shape)
        facs[..., 1] = rng.uniform(0.5, 1.5, shape)
    out["jitter_op"], out["jitter_factor"] = ops, facs
    return out


def bench(batch: int = 32, size: int = 352, iters: int = 20, traffic: str = "loader") -> dict:
    """``aug_compose`` on the geometry batch of seed ``size``, and
    ``slot_aug`` on its B * 4 slots, with the plans of ``traffic``
    (``slot_class``): ms per call (CUDA events) and each kernel's device
    ms per call (``kernel_ms_by_name``)."""
    device = tool_device("cuda")
    rng = np.random.default_rng(size)
    g = {k: torch.from_numpy(v).to(device)
         for k, v in slot_class(random_geometry_batch(rng, batch, size), traffic, rng).items()}
    n = batch * g["slots"].shape[1]
    per_slot = [g[k].reshape(n, *g[k].shape[2:]) for k in
                ("noise_gate", "noise_scale", "noise_per_channel", "jitter_op", "jitter_factor")]
    calls = {
        "aug_compose": lambda: aug_compose(
            g["slots"], NOISE_SEED, *(g[k] for k in (
                "noise_gate", "noise_scale", "noise_per_channel", "jitter_op", "jitter_factor",
                "src_rect", "dst_rect", "fill_rect", "fill_color", "fill_from_mean", "flip",
                "active")), (size, size)),
        "slot_aug": lambda: slot_aug(g["slots"].reshape(n, size, size, 3), NOISE_SEED, *per_slot),
    }
    ops = g["jitter_op"][g["active"]]
    result = {"device": device_name(device), "batch": batch, "size": size, "traffic": traffic,
              "active_slots": int(g["active"].sum()),
              "noised_slots": int(g["noise_gate"].sum()),
              "contrast_steps": int((ops == 1).sum()),
              "mean_fills": int((g["fill_from_mean"] & g["active"]).sum())}
    for name, fn in calls.items():
        result[name] = {"ms": device_ms(fn, device=device, iters=iters),
                        "kernels_ms": kernel_ms_by_name(fn, iters)}
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=None, help="64 for the check, 352 for --bench")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", action="store_true", help="time both kernels on the card")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--traffic", choices=TRAFFIC, default="loader",
                    help="--bench: every slot's plan from one class")
    args = ap.parse_args(argv)
    if args.bench:
        result = bench(args.batch, args.size or 352, args.iters, args.traffic)
    else:
        result = run(args.size or 64, args.slots, args.dtype, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
