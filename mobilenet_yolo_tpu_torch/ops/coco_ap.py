"""COCO-protocol average precision (AP@[.5:.95], AP50, AP75).

A numpy copy of ``mobilenet_yolo_tpu/ops/coco_ap.py``.
Beyond-reference evaluation: the reference only implements the VOC
11-point protocol (utils/eval_mAP.py); this module adds the COCO metric
family with pycocotools' exact algorithm (cocoeval.py: evaluateImg /
accumulate), over the same per-image-list input contract as
``ops/ap.py:calculate_mAP``:

* 10 IoU thresholds 0.50:0.05:0.95; 101 recall points 0:0.01:1
* per (image, class): detections sorted by score; each detection greedily
  takes the UNMATCHED ground truth with the highest IoU >= t, preferring
  any non-ignored GT over ignored ones (a match to an ignored GT — the
  VOC ``difficult`` flag maps to pycocotools' ignore — removes the
  detection from scoring entirely, like an iscrowd match)
* precision envelope (monotone non-increasing) before interpolation;
  classes with no ground truth are skipped, not scored 0
* maxDets=100 per image (COCO default)
* area ranges (APsmall/APmedium/APlarge) with pycocotools' exact
  semantics: out-of-range GT is ignored (a match to it unscores the
  detection), unmatched out-of-range detections are unscored, and the
  recall denominator counts only in-range non-difficult GT. Boxes are
  normalized, so areas are computed at the evaluation resolution via
  ``img_size`` (COCO proper uses original-image pixel areas; here every
  eval image is the config's fixed img_w x img_h, so the network-input
  resolution IS the natural pixel frame). Ranges with no ground truth
  report -1.0, pycocotools' convention. Calibration of the frame choice
  for VOC-sized images: a typical 500x375 VOC image resized to 352x352
  scales box areas by (352/500)*(352/375) ~= 0.66, so the fixed 32^2 /
  96^2 thresholds correspond to ~39^2 / ~118^2 in the ORIGINAL frame —
  i.e. this module's "small" bin is ~1.5x stricter by original-image
  area than pycocotools on the same data, and objects within ~20% of a
  threshold can flip bins. AP50/AP75/AP@[.5:.95] are unaffected (IoU is
  scale-invariant); only cross-paper comparisons of APsmall/medium/
  large need this caveat.

Pure numpy, host-side, same as ops/ap.py.
"""

from __future__ import annotations

import numpy as np

from mobilenet_yolo_tpu_torch.ops.ap import _pairwise_iou_np

IOU_THRESHS = np.arange(0.5, 1.0, 0.05)          # 10 values, 0.50..0.95
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
# pycocotools areaRng (pixel^2): all / small / medium / large
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _box_areas(boxes: np.ndarray, img_size) -> np.ndarray:
    """Pixel areas of normalized corner boxes at ``img_size`` = (w, h)."""
    if boxes.shape[0] == 0:
        return np.zeros(0, np.float64)
    w, h = img_size
    return ((boxes[:, 2] - boxes[:, 0]) * w
            * (boxes[:, 3] - boxes[:, 1]) * h).astype(np.float64)


def _match_image_class(det_box, det_score, true_box, true_ignore,
                       det_out_rng=None):
    """pycocotools evaluateImg for one (image, class): returns
    (scores, tp[T, D], ignored[T, D]) with detections sorted by score.

    ``true_ignore`` already folds in out-of-area-range GT (cocoeval.py
    ``gtIg = _ignore or out-of-aRng``); ``det_out_rng`` marks detections
    whose own area falls outside the range — when such a detection stays
    UNMATCHED it is unscored rather than counted as a false positive
    (cocoeval.py's final ``dtIg`` line)."""
    order = np.argsort(-det_score, kind="stable")
    det_box = det_box[order]
    det_score = det_score[order]
    if det_out_rng is None:
        det_out_rng = np.zeros(det_box.shape[0], bool)
    else:
        det_out_rng = det_out_rng[order]
    n_det, n_gt = det_box.shape[0], true_box.shape[0]
    T = len(IOU_THRESHS)
    tp = np.zeros((T, n_det), bool)
    det_ig = np.zeros((T, n_det), bool)
    if n_det == 0:
        return det_score, tp, det_ig
    # GTs sorted ignored-last, like pycocotools (gtind)
    gt_order = np.argsort(true_ignore, kind="stable")
    true_box = true_box[gt_order]
    true_ignore = true_ignore[gt_order].astype(bool)
    if n_gt:
        ious = _pairwise_iou_np(det_box, true_box)
    for ti, t in enumerate(IOU_THRESHS):
        matched = np.zeros(n_gt, bool)
        for d in range(n_det):
            best, best_iou = -1, min(t, 1 - 1e-10)
            for g in range(n_gt):
                if matched[g]:
                    continue
                # best non-ignored match found and g is ignored: stop —
                # ignored GTs sort last (cocoeval.py evaluateImg)
                if best > -1 and not true_ignore[best] and true_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best = g
            if best == -1:
                # unmatched + outside the area range: unscored
                det_ig[ti, d] = det_out_rng[d]
                continue
            matched[best] = True
            if true_ignore[best]:
                det_ig[ti, d] = True     # matched an ignored GT: unscored
            else:
                tp[ti, d] = True
    return det_score, tp, det_ig


def _class_precision_recall(c, true_labels, det_labels, true_boxes,
                            true_difficulties, det_boxes, det_scores,
                            max_dets: int, area_rng=None, img_size=None):
    scores, tps, igs = [], [], []
    n_gt_total = 0
    for tl, dl, tb, td, db, ds in zip(true_labels, det_labels, true_boxes,
                                      true_difficulties, det_boxes,
                                      det_scores):
        tmask = tl == c
        dmask = dl == c
        dbox, dsc = db[dmask], ds[dmask]
        if dbox.shape[0] > max_dets:           # per-image COCO cap,
            keep = np.argsort(-dsc, kind="stable")[:max_dets]  # by score
            dbox, dsc = dbox[keep], dsc[keep]
        gt_ignore = (td[tmask] != 0)
        det_out_rng = None
        if area_rng is not None:
            lo, hi = area_rng
            g_area = _box_areas(tb[tmask], img_size)
            gt_ignore = gt_ignore | (g_area < lo) | (g_area > hi)
            d_area = _box_areas(dbox, img_size)
            det_out_rng = (d_area < lo) | (d_area > hi)
        s, tp, ig = _match_image_class(dbox, dsc, tb[tmask],
                                       gt_ignore.astype(np.float32),
                                       det_out_rng=det_out_rng)
        scores.append(s)
        tps.append(tp)
        igs.append(ig)
        n_gt_total += int((~gt_ignore).sum())
    if n_gt_total == 0:
        return None                            # class absent: skipped
    sc = np.concatenate(scores) if scores else np.zeros(0, np.float32)
    tp = np.concatenate(tps, axis=1) if tps else np.zeros((10, 0), bool)
    ig = np.concatenate(igs, axis=1) if igs else np.zeros((10, 0), bool)
    order = np.argsort(-sc, kind="stable")     # global score sort
    tp, ig = tp[:, order], ig[:, order]

    ap = np.zeros(len(IOU_THRESHS), np.float64)
    for ti in range(len(IOU_THRESHS)):
        keep = ~ig[ti]
        tpt = tp[ti, keep].astype(np.float64)
        fpt = (~tp[ti, keep]).astype(np.float64)
        cum_tp, cum_fp = np.cumsum(tpt), np.cumsum(fpt)
        recall = cum_tp / n_gt_total
        precision = cum_tp / np.maximum(cum_tp + cum_fp, np.spacing(1))
        # monotone envelope (pycocotools accumulate)
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        # precision at the first index with recall >= point, else 0
        inds = np.searchsorted(recall, RECALL_POINTS, side="left")
        q = np.zeros(len(RECALL_POINTS), np.float64)
        valid = inds < len(precision)
        q[valid] = precision[inds[valid]]
        ap[ti] = q.mean()
    return ap


def calculate_coco_map(det_boxes, det_labels, det_scores, true_boxes,
                       true_labels, true_difficulties, classes_name,
                       max_dets: int = 100, img_size=None) -> dict:
    """COCO metric family over the ops/ap.py input contract.

    Returns ``{"AP": mean over classes & IoU 0.5:0.95, "AP50": ...,
    "AP75": ..., "APsmall": ..., "APmedium": ..., "APlarge": ...,
    "per_class": {name: AP}}``. ``true_difficulties`` maps to the COCO
    ignore flag; classes with no non-difficult ground truth are skipped
    (pycocotools' -1 convention), and an area range with no ground truth
    at all reports -1.0.

    ``img_size`` = (w, h) pixel frame for the area ranges (boxes are
    normalized); pass the evaluation resolution. With ``img_size=None``
    the area-range APs are skipped (reported -1.0) — the "all" metrics
    need no pixel frame.
    """
    assert len(det_boxes) == len(det_labels) == len(det_scores) \
        == len(true_boxes) == len(true_labels) == len(true_difficulties)
    per_class = {}
    ap_stack = []
    for c in range(1, len(classes_name)):
        ap = _class_precision_recall(
            c, true_labels, det_labels, true_boxes, true_difficulties,
            det_boxes, det_scores, max_dets)
        if ap is None:
            continue
        per_class[classes_name[c]] = float(ap.mean())
        ap_stack.append(ap)
    res = {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "per_class": per_class,
           "APsmall": -1.0, "APmedium": -1.0, "APlarge": -1.0}
    if ap_stack:
        stacked = np.stack(ap_stack)           # (C, T)
        res.update(AP=float(stacked.mean()),
                   AP50=float(stacked[:, 0].mean()),
                   AP75=float(stacked[:, 5].mean()))
    if img_size is None:
        return res
    for name in ("small", "medium", "large"):
        stack = []
        for c in range(1, len(classes_name)):
            ap = _class_precision_recall(
                c, true_labels, det_labels, true_boxes, true_difficulties,
                det_boxes, det_scores, max_dets,
                area_rng=AREA_RANGES[name], img_size=img_size)
            if ap is not None:
                stack.append(ap)
        res[f"AP{name}"] = float(np.stack(stack).mean()) if stack else -1.0
    return res
