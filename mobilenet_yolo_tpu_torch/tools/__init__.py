"""The port's measurement tools, run as ``python -m mobilenet_yolo_tpu_torch.tools.<name>``.

Ports of the JAX package's ``tools/``: ``bench_train`` (the training split),
``bench_geometry`` (the device-geometry step against the plain step),
``probe_stem`` (the cuDNN stem formulations), ``prune`` (Network Slimming:
plan, slice and write a pruned model), ``probe_stem_cuda`` (the
staged stem roofline kernel) and ``probe_aug_kernels`` (the augmentation
kernels against their plain twins; ``--bench`` times their launches
apart, ``--traffic`` per slot class); ``probe_fused_tiles``, the fused
kernels' launch plans (the blocks', or with ``--stem`` the stem's) timed
beside their cost model; and ``probe_nms``, the NMS scan's time (events
per call, its device time with ``over`` in L2 and from HBM) beside both
bounds, on the card only.
Each other tool runs on the card unless given ``--device cpu``; without a
card, every tool raises unless given the CPU.
"""

from __future__ import annotations

import torch


def tool_device(name: str) -> torch.device:
    """The device a tool runs on: ``cuda`` (the default of every tool)
    raises without a card; ``cpu`` only when the caller asked for it."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the tools run on cuda or cpu, not {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this tool runs on the card by default and no CUDA device is "
                           "available; pass --device cpu to run it on the CPU")
    return device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
