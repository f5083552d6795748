"""Mosaic augmentation: layout masks, compositor and group sampling (port
of ``mobilenet_yolo_tpu/data/mosaic.py``, a copy).

Reproduces reference utils/image_augmentation.py:199-278 (1/2/3/4-tile
layouts with a random split point, aspect-ratio-clamped placement, per-tile
mean fill, label remap into mosaic coordinates) and the GreedyBatchSampler
group-size logic (CustomBatchSampler.py:48-73: each batch entry is a group
of size 1 with p=0.5 else a uniform draw from ``mosaic_num``).
"""

from __future__ import annotations

import numpy as np


def generate_mosaic_mask(num: int, size, rng: np.random.Generator):
    """Tile rectangles [x1,y1,x2,y2] for a ``num``-image mosaic (:199-215)."""
    w, h = size
    mask = [[0, 0, w, h]]
    x_c = int(rng.uniform(0.25, 0.75) * w)
    y_c = int(rng.uniform(0.25, 0.75) * h)
    if num == 2:
        m1 = [[0, 0, x_c, h], [x_c, 0, w, h]]
        m2 = [[0, 0, w, y_c], [0, y_c, w, h]]
        mask = [m1, m2][int(rng.integers(0, 2))]
    elif num == 3:
        m1 = [[0, 0, w, y_c], [0, y_c, x_c, h], [x_c, y_c, w, h]]
        m2 = [[0, 0, x_c, y_c], [x_c, 0, w, y_c], [0, y_c, w, h]]
        m3 = [[0, 0, x_c, h], [x_c, 0, w, y_c], [x_c, y_c, w, h]]
        m4 = [[0, 0, x_c, y_c], [x_c, 0, w, h], [0, y_c, x_c, h]]
        mask = [m1, m2, m3, m4][int(rng.integers(0, 4))]
    elif num == 4:
        mask = [[0, 0, x_c, y_c], [x_c, 0, w, y_c],
                [0, y_c, x_c, h], [x_c, y_c, w, h]]
    return mask


def plan_mosaic_placement(shapes, size, rng: np.random.Generator):
    """Pixel-free placement plan for an N-tile mosaic (reference :216-278).

    ``shapes``: [(h, w), ...] of the source images. Returns, per source,
    ``(tile, offset_x, offset_y, width, height)`` — the tile rect it was
    assigned, the aspect-ratio-clamped paste size and its random offset
    inside the tile. Owns every rng draw of the compositor, in reference
    order, so the host pixel path and the device resample path
    (data/geometry.py) sample identical layouts."""
    mask = generate_mosaic_mask(len(shapes), size, rng)
    plan = []
    for counter, (ih, iw) in enumerate(shapes):
        tile = mask[counter]
        width = tile[2] - tile[0]
        height = tile[3] - tile[1]
        ar_src = ih / iw
        min_ratio, max_ratio = ar_src * 0.5, ar_src * 2
        ar_tar = height / width
        offset_x = offset_y = 0
        if ar_tar < min_ratio:
            scale = 1.0 / min_ratio
            offset_x = int(rng.integers(0, int(width - height * scale) + 1))
            width = int(height * scale)
        if ar_tar > max_ratio:
            offset_y = int(rng.integers(0, int(height - width * max_ratio) + 1))
            height = int(width * max_ratio)
        plan.append((tile, offset_x, offset_y, width, height))
    return plan


def remap_mosaic_labels(labels: np.ndarray, placement, size) -> np.ndarray:
    """Scale one source's normalized (cls, cx, cy, w, h[, ...]) rows into
    mosaic coordinates (reference :269-276)."""
    W, H = size
    tile, offset_x, offset_y, width, height = placement
    lab = labels.copy()
    box = lab[:, 1:5]
    w_scale = W / width
    h_scale = H / height
    box[:, 0] /= w_scale
    box[:, 2] /= w_scale
    box[:, 1] /= h_scale
    box[:, 3] /= h_scale
    box[:, 0] += (tile[0] + offset_x) / W
    box[:, 1] += (tile[1] + offset_y) / H
    return lab


def mosaic(group, size, rng: np.random.Generator):
    """Compose N (image uint8 HWC, labels (n,5) normalized cxcywh) pairs
    into one ``size`` mosaic (reference :216-278). Returns (image, labels).
    """
    W, H = size
    background = np.zeros((H, W, 3), np.float32)
    plan = plan_mosaic_placement([img.shape[:2] for img, _ in group], size, rng)
    # column-agnostic: rows may carry extra per-box fields (e.g. the
    # difficult flag) after the (cls, cx, cy, w, h) prefix
    ncols = max((lab.shape[1] for _, lab in group if lab.ndim == 2), default=5)
    all_labels = [np.zeros((0, ncols), np.float32)]

    for (img, labels), placement in zip(group, plan):
        tile, offset_x, offset_y, width, height = placement
        resized = _resize(img, (width, height)).astype(np.float32)
        mean = resized.reshape(-1, 3).mean(0)
        x1 = tile[0] + offset_x
        y1 = tile[1] + offset_y
        x2 = min(tile[2], x1 + width)
        y2 = min(tile[3], y1 + height)
        background[tile[1]:tile[3], tile[0]:tile[2]] = mean
        background[y1:y2, x1:x2] = resized[: y2 - y1, : x2 - x1]

        if labels.shape[0]:
            all_labels.append(remap_mosaic_labels(labels, placement, size))

    return background.astype(np.uint8), np.concatenate(all_labels, 0)


def _resize(img: np.ndarray, size):
    """(w, h) resize; cv2 if available, PIL otherwise."""
    w, h = size
    try:
        import cv2
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((w, h)))


def sample_group_size(mosaic_num, rng: np.random.Generator) -> int:
    """p=0.5 single image, else uniform over ``mosaic_num``
    (CustomBatchSampler.py:48-53)."""
    if rng.random() < 0.5:
        return int(rng.choice(mosaic_num))
    return 1


def group_indices(order, batch_size: int, mosaic_num, rng: np.random.Generator,
                  drop_last: bool = False):
    """Yield batches of index-groups (GreedyBatchSampler.__iter__ :54-73)."""
    batch = []
    bucket = []
    num = sample_group_size(mosaic_num, rng)
    for idx in order:
        bucket.append(int(idx))
        if len(bucket) == num:
            batch.append(bucket)
            bucket = []
            num = sample_group_size(mosaic_num, rng)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch
