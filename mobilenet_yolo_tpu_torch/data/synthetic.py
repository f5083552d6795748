"""Synthetic detection data for tests, smoke training and benchmarks (port
of ``mobilenet_yolo_tpu/data/synthetic.py``, a copy).

Draws axis-aligned colored rectangles on noise backgrounds with matching
YOLO labels — enough signal that a few optimization steps measurably reduce
the loss (the e2e train-smoke criterion from SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np


def synthetic_scene(rng: np.random.Generator, img_size: int, num_classes: int,
                    max_boxes: int = 4):
    img = rng.normal(0.0, 0.3, (img_size, img_size, 3)).astype(np.float32)
    n = int(rng.integers(1, max_boxes + 1))
    labels = np.zeros((n, 5), np.float32)
    for i in range(n):
        cls = int(rng.integers(1, num_classes + 1))
        w = float(rng.uniform(0.15, 0.5))
        h = float(rng.uniform(0.15, 0.5))
        cx = float(rng.uniform(w / 2, 1 - w / 2))
        cy = float(rng.uniform(h / 2, 1 - h / 2))
        x1, y1 = int((cx - w / 2) * img_size), int((cy - h / 2) * img_size)
        x2, y2 = int((cx + w / 2) * img_size), int((cy + h / 2) * img_size)
        color = np.zeros(3, np.float32)
        color[cls % 3] = 2.0 + cls * 0.3
        img[y1:y2, x1:x2] = color
        labels[i] = [cls, cx, cy, w, h]
    return img, labels


def synthetic_dataset(num_samples: int, img_size: int = 96,
                      num_classes: int = 20, max_boxes: int = 4, seed: int = 0):
    """Returns (images (N,S,S,3) f32, labels list of (n,5) arrays)."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(num_samples):
        img, lab = synthetic_scene(rng, img_size, num_classes, max_boxes)
        images.append(img)
        labels.append(lab)
    return np.stack(images), labels


def pad_labels(labels_list, max_gt: int):
    """Ragged label lists -> (B, T, 5) + (B,) count arrays."""
    b = len(labels_list)
    gt = np.zeros((b, max_gt, 5), np.float32)
    n_gt = np.zeros((b,), np.int32)
    for i, lab in enumerate(labels_list):
        n = min(len(lab), max_gt)
        gt[i, :n] = lab[:n]
        n_gt[i] = n
    return gt, n_gt


def synthetic_batches(num_batches: int, batch_size: int, img_size: int = 96,
                      num_classes: int = 20, max_gt: int = 10, seed: int = 0):
    """Yields (images, gt, n_gt) batches, cycling a fixed tiny dataset."""
    images, labels = synthetic_dataset(
        batch_size * min(num_batches, 4), img_size, num_classes, seed=seed)
    n = images.shape[0]
    for step in range(num_batches):
        idx = [(step * batch_size + j) % n for j in range(batch_size)]
        gt, n_gt = pad_labels([labels[i] for i in idx], max_gt)
        yield images[idx], gt, n_gt
