"""The device-geometry train step against the plain step, on the card
(port of ``tools/bench_geometry.py``).

Times the plain train step (images already composed, normalised on the
device) against ``make_geometry_train_step`` (noise, photometric programs
and the geometric compose on the device, then forward, loss, backward and
AdamW) on the worst-case batch: every image a 4-tile mosaic with a mean
fill, programs from ``train/synthetic.py:random_program``. ``--stages`` also
times the aug stages alone: slot_noise, + the programs, + the compose (the
plain ops), and the kernel path alone (``--fused``'s ``augment_geometry``).
CUDA events, means over ``--iters`` calls after a warmup.

    python -m mobilenet_yolo_tpu_torch.tools.bench_geometry [--batch-size 32] \\
        [--img-size 352] [--dtype f32|bf16] [--fused auto|on|split|off] [--stages] \\
        [--iters 16] [--device cuda|cpu]

``--fused``: ``on`` the ``aug_compose`` kernel, ``split`` the ``slot_aug``
kernel and the plain compose, ``off`` the plain ops, ``auto`` the kernel on
the card and the plain ops on the CPU (``make_geometry_train_step``'s
``fused_aug=None``). ``--img-size`` is the stage and output size, any of
the VOC buckets (288-416) or other even sizes.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.config import VOC_CONFIG
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.ops.device_augment import (geometric_compose,
                                                         planned_color_jitter, slot_noise)
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step, make_train_step)
from mobilenet_yolo_tpu_torch.train.step import augment_geometry
from mobilenet_yolo_tpu_torch.train.synthetic import random_program
from mobilenet_yolo_tpu_torch.utils.profiling import device_ms

FUSED = {"auto": None, "on": True, "split": "split", "off": False}
DTYPES = {"f32": None, "bf16": torch.bfloat16}
AUG_SEED = 7


def worst_case_batch(rng: np.random.Generator, b: int, s: int) -> dict[str, np.ndarray]:
    """Geometry arrays with every image a 4-tile mosaic (``bench_geometry.py:27-60``):
    tile k pastes a random window into quadrant k, filled with its source
    window's mean; half the slots noised."""
    slots = rng.integers(0, 255, (b, 4, s, s, 3), np.uint8)
    src = np.zeros((b, 4, 4), np.float32)
    dst = np.zeros((b, 4, 4), np.float32)
    quads = [(0, 0), (0.5, 0), (0, 0.5), (0.5, 0.5)]
    for k, (qx, qy) in enumerate(quads):
        x1 = rng.uniform(0.0, 0.2, b)
        y1 = rng.uniform(0.0, 0.2, b)
        src[:, k] = np.stack([x1, y1, x1 + rng.uniform(0.6, 0.8, b),
                              y1 + rng.uniform(0.6, 0.8, b)], -1)
        dst[:, k] = [qx, qy, qx + 0.5, qy + 0.5]
    programs = [random_program(rng) for _ in range(b * 4)]
    gt = np.zeros((b, 30, 5), np.float32)
    gt[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]
    return {
        "slots": slots, "src_rect": src, "dst_rect": dst, "fill_rect": dst.copy(),
        "fill_color": np.full((b, 4, 3), 127.5, np.float32),
        "fill_from_mean": np.ones((b, 4), bool),
        "flip": rng.random((b, 4)) < 0.5,
        "active": np.ones((b, 4), bool),
        "noise_gate": rng.random((b, 4)) < 0.5,
        "noise_scale": rng.uniform(0, 0.03 * 255, (b, 4)).astype(np.float32),
        "noise_per_channel": rng.random((b, 4)) < 0.3,
        "jitter_op": np.stack([p[0] for p in programs]).reshape(b, 4, 5),
        "jitter_factor": np.stack([p[1] for p in programs]).reshape(b, 4, 5),
        "gt": gt, "n_gt": np.ones((b,), np.int32),
    }


def run(batch_size: int = 32, img_size: int = 352, dtype: str = "f32", fused: str = "auto",
        stages: bool = False, iters: int = 16, device="cuda") -> dict:
    device = tool_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    b, s = batch_size, img_size
    cfg = {**VOC_CONFIG, "normalize": {"mean": [0.5] * 3, "std": [1.0] * 3}}
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model)
    autocast_dtype = DTYPES[dtype]
    aug_dtype = autocast_dtype or torch.float32

    rng = np.random.default_rng(0)
    gb = {k: torch.from_numpy(v).to(device) for k, v in worst_case_batch(rng, b, s).items()}
    geom = tuple(gb[k] for k in GEOMETRY_BATCH_KEYS)
    images = torch.from_numpy(rng.integers(0, 255, (b, s, s, 3)).astype(np.float32) / 2.0
                              ).to(device)

    def timed(fn):
        return device_ms(fn, device=device, iters=iters)

    results = {"device": device_name(device)}
    plain = make_train_step(model, cfg, normalize=True, dtype=autocast_dtype)
    results["plain_step_ms"] = timed(lambda: plain(state, images, gb["gt"], gb["n_gt"]))
    mode = FUSED[fused]
    gstep = make_geometry_train_step(model, cfg, fused_aug=mode, dtype=autocast_dtype)
    results["geometry_step_ms"] = timed(
        lambda: gstep(state, *geom, gb["gt"], gb["n_gt"], AUG_SEED, out_hw=(s, s)))
    results["overhead_ms"] = results["geometry_step_ms"] - results["plain_step_ms"]
    results["ratio"] = results["geometry_step_ms"] / results["plain_step_ms"]

    if stages:
        noise_args = (gb["slots"], AUG_SEED, gb["noise_gate"], gb["noise_scale"],
                      gb["noise_per_channel"])
        place = tuple(gb[k] for k in ("src_rect", "dst_rect", "fill_rect", "fill_color",
                                      "fill_from_mean", "flip", "active"))

        def stage_noise():
            return slot_noise(*noise_args, dtype=aug_dtype)

        def stage_jitter():
            flat = stage_noise().reshape(b * 4, s, s, 3)
            return planned_color_jitter(flat, gb["jitter_op"].reshape(b * 4, 5),
                                        gb["jitter_factor"].reshape(b * 4, 5), dtype=aug_dtype)

        def stage_compose():
            return geometric_compose(stage_noise(), *place, (s, s), jitter_op=gb["jitter_op"],
                                     jitter_factor=gb["jitter_factor"], dtype=aug_dtype)

        n, j, c = timed(stage_noise), timed(stage_jitter), timed(stage_compose)
        results.update(stage_noise_ms=n, stage_jitter_ms=j - n, stage_compose_ms=c - j,
                       stage_total_ms=c)
        kernel_mode = (device.type == "cuda") if mode is None else mode
        if kernel_mode is not False:
            results["stage_fused_total_ms"] = timed(
                lambda: augment_geometry(geom, AUG_SEED, (s, s), kernel_mode, dtype=aug_dtype))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--img-size", type=int, default=352)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32")
    ap.add_argument("--stages", action="store_true", help="also time the aug stages alone")
    ap.add_argument("--fused", choices=list(FUSED), default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(args.batch_size, args.img_size, args.dtype, args.fused, args.stages,
                  args.iters, args.device)
    record = {"label": f"batch {args.batch_size} {args.img_size}x{args.img_size} {args.dtype} "
                       f"fused={args.fused}", **results}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
