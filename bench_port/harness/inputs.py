"""Everything a run feeds the program, made from the seed on the device.

One ``torch.Generator`` on the card, seeded with ``--seed``, draws in this
order: every parameter drawn from a normal in one truncated-normal call
(then scaled per leaf), the calibration batch, and the frame pool. The
reference draws the same weights and calibration batch again from the
same seed; it reads the pool's frames from host memory.
"""

from __future__ import annotations

import torch

CALIBRATION_FRAMES = 32


def draw_weights(gen: torch.Generator, kinds: dict, shapes: dict, device,
                 dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``kinds`` (``reference.init_kinds``) and their
    shapes: one truncated-normal draw for every ``normal`` leaf, cut at two
    deviations, each slice scaled by its leaf's deviation."""
    normal = [n for n in kinds if kinds[n][0] == "normal"]
    total = sum(shapes[n].numel() for n in normal)
    flat = torch.empty(total, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, (kind, value) in kinds.items():
        shape = shapes[name]
        if kind == "normal":
            n = shape.numel()
            out[name] = (flat[at:at + n].reshape(shape) * value).to(dtype)
            at += n
        else:
            out[name] = torch.full(shape, value, device=device, dtype=dtype)
    return out


def draw_frames(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 frames on the device."""
    return torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device, dtype=torch.uint8)


def model_inputs(reference, config: dict, seed: int, device):
    """(weights, calibration frames on the device, and the generator, which
    draws the frame pool next) for this seed."""
    meta = reference.build(config, device="meta")
    shapes = {n: p.shape for n, p in meta.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    weights = draw_weights(gen, reference.init_kinds(meta), shapes, device)
    calib = draw_frames(gen, CALIBRATION_FRAMES, config["img_h"], config["img_w"], device)
    return weights, calib, gen


def frame_pool(gen: torch.Generator, config: dict, frames: int, device,
               pinned: bool) -> torch.Tensor:
    """The pool of frames requests read, in host memory (pinned on a card)."""
    on_device = draw_frames(gen, frames, config["img_h"], config["img_w"], device)
    host = torch.empty(on_device.shape, dtype=torch.uint8, pin_memory=pinned)
    host.copy_(on_device)
    return host
