"""Random device-geometry batches, for driving the train step without data.

``random_geometry_batch`` draws a batch in the contract of the port's
``Loader(device_geometry=True)`` (``data/geometry.py:GroupPlan``, planned by
``data/geometry.py:GeometryPlanner``) from a numpy generator alone: no
images to decode, no cv2. The traffic is the VOC loader's: each image's
group size is drawn as ``data/mosaic.py:sample_group_size`` draws it with
the VOC config's ``mosaic_num: [1, 4]`` (a quarter of the images are
4-tile mosaics), and
each slot's noise gate as ``data/augment.py:pixel_noise`` draws it (on for
a quarter of the slots). A single is a crop, optionally expanded, on a
constant fill; a mosaic a crop per quadrant of a random centre, each
quadrant filled with its source window's mean. Flipped rects arrive
mirrored, as the planner emits them; the photometric programs follow
``data/augment.py:sample_photometric``. Slots past an image's tile count
are zero and inactive.
"""

from __future__ import annotations

import numpy as np

MAX_TILES = 4
STEPS = 5
HUE_MAX = 18.0 / 255.0  # hue delta in turns, data/augment.py
MOSAIC_NUM = (1, 4)     # mobilenet_yolo_tpu_torch/configs/voc/config.yaml:13


def _mirror_x(rect: np.ndarray) -> np.ndarray:
    return np.asarray([1.0 - rect[2], rect[1], 1.0 - rect[0], rect[3]], np.float32)


def _window(rng: np.random.Generator, x0: float, y0: float, x1: float, y1: float,
            min_frac: float) -> np.ndarray:
    """A random sub-rect of [x0, x1) x [y0, y1) at least ``min_frac`` of
    each side."""
    w, h = (x1 - x0) * rng.uniform(min_frac, 1.0), (y1 - y0) * rng.uniform(min_frac, 1.0)
    left = x0 + rng.uniform(0.0, x1 - x0 - w)
    top = y0 + rng.uniform(0.0, y1 - y0 - h)
    return np.asarray([left, top, left + w, top + h], np.float32)


def sample_group_size(rng: np.random.Generator) -> int:
    """Tiles of one image, as ``data/mosaic.py:125-130`` draws them: p=0.5 a
    single image, else uniform over ``MOSAIC_NUM``."""
    if rng.random() < 0.5:
        return int(rng.choice(MOSAIC_NUM))
    return 1


def noise_gated(rng: np.random.Generator) -> bool:
    """Whether a slot gets additive noise, as ``data/augment.py:246-250``
    draws it: Sometimes(0.5), then the noise among the first 1-2 of the
    shuffled blur, sharpen and noise ops (p = 0.5 * 0.5)."""
    if rng.random() >= 0.5:
        return False
    ops = ["blur", "sharpen", "noise"]
    rng.shuffle(ops)
    return "noise" in ops[:int(rng.integers(1, 3))]


def random_program(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One photometric program: the five ops in a random order, each
    applied with p=0.5 (brightness, contrast, saturation, gamma factors
    U(0.5, 1.5); hue a delta U(-18, 18)/255 of a turn)."""
    ops = np.full((STEPS,), -1, np.int32)
    facs = np.ones((STEPS,), np.float32)
    for t, op in enumerate(rng.permutation(STEPS)):
        if rng.random() < 0.5:
            ops[t] = op
            facs[t] = rng.uniform(-HUE_MAX, HUE_MAX) if op == 3 else rng.uniform(0.5, 1.5)
    return ops, facs


def random_geometry_batch(rng: np.random.Generator, batch: int, stage: int,
                          num_classes: int = 20, max_gt: int = 16) -> dict[str, np.ndarray]:
    """A geometry batch: the ``GEOMETRY_BATCH_KEYS`` arrays (slots
    (B, 4, S, S, 3) uint8, rects (B, 4, 4), fill_color (B, 4, 3), the
    (B, 4) flags, noise plans, programs (B, 4, 5)), ``gt`` (B, max_gt, 5)
    rows (label 1-indexed, cx, cy, w, h) with non-zero padding past
    ``n_gt`` (B,)."""
    t = MAX_TILES
    out = {
        "slots": np.zeros((batch, t, stage, stage, 3), np.uint8),
        "src_rect": np.tile(np.float32([0, 0, 1, 1]), (batch, t, 1)),
        "dst_rect": np.tile(np.float32([0, 0, 1, 1]), (batch, t, 1)),
        "fill_rect": np.zeros((batch, t, 4), np.float32),
        "fill_color": np.zeros((batch, t, 3), np.float32),
        "fill_from_mean": np.zeros((batch, t), bool),
        "flip": np.zeros((batch, t), bool),
        "active": np.zeros((batch, t), bool),
        "noise_gate": np.zeros((batch, t), bool),
        "noise_scale": np.zeros((batch, t), np.float32),
        "noise_per_channel": np.zeros((batch, t), bool),
        "jitter_op": np.full((batch, t, STEPS), -1, np.int32),
        "jitter_factor": np.ones((batch, t, STEPS), np.float32),
    }
    for b in range(batch):
        tiles = sample_group_size(rng)
        cx, cy = rng.uniform(0.3, 0.7, 2)
        quads = [(0.0, 0.0, cx, cy), (cx, 0.0, 1.0, cy), (0.0, cy, cx, 1.0), (cx, cy, 1.0, 1.0)]
        for k in range(tiles):
            out["slots"][b, k] = rng.integers(0, 256, (stage, stage, 3), dtype=np.uint8)
            src = _window(rng, 0.0, 0.0, 1.0, 1.0, 0.4)
            if tiles == 1:
                fill = np.float32([0, 0, 1, 1])
                # expand with p=0.5: the source lands on part of the canvas
                dst = _window(rng, 0.0, 0.0, 1.0, 1.0, 0.5) if rng.random() < 0.5 else fill
                out["fill_color"][b, k] = rng.uniform(0, 255, 3)
            else:
                fill = np.asarray(quads[k], np.float32)
                dst = _window(rng, *quads[k], 0.7)
                out["fill_from_mean"][b, k] = True
            flip = rng.random() < 0.5
            out["src_rect"][b, k] = _mirror_x(src) if flip else src
            # a single's canvas is the flipped crop; a mosaic places the
            # flipped crop, so only its source window mirrors
            out["dst_rect"][b, k] = _mirror_x(dst) if flip and tiles == 1 else dst
            out["fill_rect"][b, k] = fill
            out["flip"][b, k] = flip
            out["active"][b, k] = True
            if noise_gated(rng):
                out["noise_gate"][b, k] = True
                out["noise_scale"][b, k] = rng.uniform(0.0, 0.03 * 255.0)
                out["noise_per_channel"][b, k] = rng.random() < 0.3
            out["jitter_op"][b, k], out["jitter_factor"][b, k] = random_program(rng)

    gt = np.zeros((batch, max_gt, 5), np.float32)
    gt[..., 0] = rng.integers(1, num_classes + 1, (batch, max_gt))
    gt[..., 1:3] = rng.uniform(0.1, 0.9, (batch, max_gt, 2))
    gt[..., 3:5] = rng.uniform(0.05, 0.5, (batch, max_gt, 2))
    out["gt"] = gt
    out["n_gt"] = rng.integers(1, max_gt + 1, batch).astype(np.int32)
    return out
