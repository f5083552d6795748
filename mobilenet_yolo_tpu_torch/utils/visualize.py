"""Visual debug rendering.

A copy of ``mobilenet_yolo_tpu/utils/visualize.py`` (numpy and PIL).
Counterpart of the reference's debug viewers (folder2lmdb.py:179-214
``show_image``, inference.py:70-103 drawing): draw labeled boxes and
segmentation overlays on numpy images and save to disk (headless — no
cv2.imshow windows).
"""

from __future__ import annotations

import numpy as np

DISTINCT_COLORS = [(230, 25, 75), (60, 180, 75), (255, 225, 25),
                   (0, 130, 200), (245, 130, 48), (145, 30, 180),
                   (70, 240, 240), (240, 50, 230), (210, 245, 60),
                   (250, 190, 190), (0, 128, 128)]


def draw_detections(image: np.ndarray, boxes, labels=None, scores=None,
                    class_names=None, normalized: bool = True) -> np.ndarray:
    """Draw corner boxes (+labels) on an RGB uint8 image; returns a copy."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(img)
    h, w = image.shape[:2]
    for i, box in enumerate(np.asarray(boxes)):
        x1, y1, x2, y2 = box[:4]
        if normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        color = DISTINCT_COLORS[i % len(DISTINCT_COLORS)]
        draw.rectangle([float(x1), float(y1), float(x2), float(y2)],
                       outline=color, width=2)
        text = ""
        if labels is not None and class_names:
            text = str(class_names[int(np.asarray(labels)[i])]).lower()
        if scores is not None:
            text += f" {float(np.asarray(scores)[i]):.2f}"
        if text:
            draw.text((float(x1) + 3, max(0.0, float(y1) - 11)), text,
                      fill=(255, 255, 255))
    return np.asarray(img)


def draw_gt_sample(image: np.ndarray, rows: np.ndarray,
                   class_names=None) -> np.ndarray:
    """Render one training-pipeline sample with its GT (the counterpart of
    the reference's ``show_image`` debug viewer, folder2lmdb.py:179-214):
    ``rows`` are normalized (cls, cx, cy, w, h[, difficult]) label rows as
    produced by DetectionDataset/mosaic. Difficult boxes are tagged '*'.
    """
    rows = np.asarray(rows).reshape(-1, rows.shape[-1])
    cx, cy, w, h = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    out = draw_detections(image, boxes, labels=rows[:, 0].astype(int),
                          class_names=class_names, normalized=True)
    if rows.shape[-1] > 5 and rows[:, 5].any():
        from PIL import Image, ImageDraw
        img = Image.fromarray(np.ascontiguousarray(out))
        draw = ImageDraw.Draw(img)
        hh, ww = image.shape[:2]
        for r in rows[rows[:, 5] > 0]:
            draw.text((float((r[1] - r[3] / 2) * ww) + 3,
                       float((r[2] - r[4] / 2) * hh) + 3), "*",
                      fill=(255, 0, 0))
        out = np.asarray(img)
    return out


def dump_pipeline_samples(dataset, indices, out_dir: str,
                          class_names=None, seed: int = 0,
                          mosaic_group: int = 0) -> list[str]:
    """Write augmented training samples (optionally mosaic groups) with
    their GT drawn — the debugging aid for mosaic/crop label math the
    reference exposed via show_image call sites (folder2lmdb.py:169,173).

    ``indices``: sample indices; with ``mosaic_group=N>1`` consecutive
    indices are composed into N-image mosaics first. Returns written paths.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    group = max(1, int(mosaic_group))
    chunks = [list(indices[i:i + group])
              for i in range(0, len(indices), group)]
    for chunk in chunks:
        img, rows, _seg, _n = dataset.get_group(chunk, rng)
        name = "gt_" + "_".join(str(i) for i in chunk) + ".jpg"
        path = os.path.join(out_dir, name)
        save_image(path, draw_gt_sample(img, rows, class_names))
        paths.append(path)
    return paths


def overlay_seg_maps(image: np.ndarray, seg_maps: np.ndarray,
                     threshold: float = 0.5,
                     channels=(1, 0)) -> np.ndarray:
    """Alpha-blend per-class sigmoid maps onto color channels
    (reference inference.py:100-103 semantics)."""
    from PIL import Image

    out = image.astype(np.float32).copy()
    h, w = image.shape[:2]
    for idx in range(min(seg_maps.shape[-1], len(channels))):
        m = np.asarray(Image.fromarray(
            (seg_maps[..., idx] * 255).astype(np.uint8)).resize(
                (w, h), Image.BILINEAR), np.float32) / 255.0
        mask = m > threshold
        ch = channels[idx]
        out[..., ch][mask] = out[..., ch][mask] * (1.0 - m[mask])
    return out.astype(np.uint8)


def save_image(path: str, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(image).save(path)
