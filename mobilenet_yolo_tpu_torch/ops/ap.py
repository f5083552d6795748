"""Pascal-VOC 11-point interpolated mAP.

A numpy copy of ``mobilenet_yolo_tpu/ops/ap.py``. Host-side numpy
reproduction of reference utils/eval_mAP.py:8-188: per-class greedy TP/FP
matching at IoU 0.5 with difficult-object skipping and
already-detected deduplication, cumulative precision/recall, 11 recall
thresholds, classes 1..N-1 averaged (class 0 = background excluded).

Inputs are per-image lists of numpy arrays (the batched eval produces
fixed-K padded detections; the evaluator strips padding before calling in).
Boxes are corner format, labels are 1-indexed (background = 0).
"""

from __future__ import annotations

import numpy as np


def _pairwise_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lower = np.maximum(a[:, None, :2], b[None, :, :2])
    upper = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(upper - lower, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union


def _eval_single_image(true_mask, det_mask, true_box, true_diff, det_box, det_score):
    """Greedy per-image matching (reference eval_mAP.py:8-67).

    Detections are processed in their stored order (the reference does NOT
    sort within an image here; global score sorting happens later).
    """
    true_class_boxes = true_box[true_mask]
    true_class_diff = true_diff[true_mask]
    n_easy = float((1 - true_class_diff).sum())

    det_class_boxes = det_box[det_mask]
    det_class_scores = det_score[det_mask]
    n_det = det_class_boxes.shape[0]
    tp = np.zeros(n_det, np.float32)
    fp = np.zeros(n_det, np.float32)
    if n_det == 0:
        return tp, fp, n_easy, det_class_scores

    detected = np.zeros(true_class_boxes.shape[0], bool)
    if true_class_boxes.shape[0]:
        overlaps = _pairwise_iou_np(det_class_boxes, true_class_boxes)
    for d in range(n_det):
        if true_class_boxes.shape[0] == 0:
            fp[d] = 1
            continue
        ind = int(np.argmax(overlaps[d]))
        max_overlap = overlaps[d, ind]
        if max_overlap > 0.5:
            if true_class_diff[ind] == 0:
                if not detected[ind]:
                    tp[d] = 1
                    detected[ind] = True
                else:
                    fp[d] = 1
            # difficult match: neither TP nor FP (ignored)
        else:
            fp[d] = 1
    return tp, fp, n_easy, det_class_scores


def eval_class_ap(c, true_labels, det_labels, true_boxes, true_difficulties,
                  det_boxes, det_scores):
    """11-point AP for class ``c`` (reference eval_mAP.py:69-132)."""
    tps, fps, scores = [], [], []
    n_easy_total = 0.0
    for tl, dl, tb, td, db, ds in zip(
        true_labels, det_labels, true_boxes, true_difficulties, det_boxes, det_scores
    ):
        tp, fp, n_easy, s = _eval_single_image(tl == c, dl == c, tb, td, db, ds)
        tps.append(tp)
        fps.append(fp)
        scores.append(s)
        n_easy_total += n_easy

    tp = np.concatenate(tps) if tps else np.zeros(0, np.float32)
    fp = np.concatenate(fps) if fps else np.zeros(0, np.float32)
    sc = np.concatenate(scores) if scores else np.zeros(0, np.float32)

    order = np.argsort(-sc, kind="stable")
    tp = tp[order]
    fp = fp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(fp)
    precision = cum_tp / (cum_tp + cum_fp + 1e-10)
    recall = cum_tp / n_easy_total if n_easy_total > 0 else np.zeros_like(cum_tp)

    precisions_at_t = np.zeros(11, np.float32)
    for i, t in enumerate(np.arange(0.0, 1.1, 0.1)):
        above = recall >= t
        if above.any():
            precisions_at_t[i] = precision[above].max()
    return float(precisions_at_t.mean()), float(tp.sum()), float(fp.sum())


def calculate_mAP(det_boxes, det_labels, det_scores, true_boxes, true_labels,
                  true_difficulties, classes_name):
    """Reference eval_mAP.py:134-188 contract.

    ``classes_name`` includes 'background' at index 0; APs are computed for
    classes 1..N-1. Returns (per-class AP dict, mAP, TP dict, FP dict).
    """
    assert len(det_boxes) == len(det_labels) == len(det_scores) \
        == len(true_boxes) == len(true_labels) == len(true_difficulties)
    n_classes = len(classes_name)
    aps, tp_counts, fp_counts = {}, {}, {}
    ap_values = []
    for c in range(1, n_classes):
        ap, tp, fp = eval_class_ap(
            c, true_labels, det_labels, true_boxes, true_difficulties,
            det_boxes, det_scores,
        )
        name = classes_name[c]
        aps[name] = ap
        tp_counts[name] = tp
        fp_counts[name] = fp
        ap_values.append(ap)
    mAP = float(np.mean(ap_values)) if ap_values else 0.0
    return aps, mAP, tp_counts, fp_counts
