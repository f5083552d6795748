"""Batched mAP evaluation with the val_conf feedback controller.

Port of ``mobilenet_yolo_tpu/eval/evaluator.py`` (reference train.py:333-424,
``test``): run detection over the eval set, collect per-image detections
and ground truths, adjust the confidence gate from the predicted/GT
box-count ratio, and compute VOC 11-point mAP.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.ops.ap import calculate_mAP
from mobilenet_yolo_tpu_torch.ops.coco_ap import calculate_coco_map
from mobilenet_yolo_tpu_torch.ops.seg_metrics import SegMetricAccumulator
from mobilenet_yolo_tpu_torch.parallel.mesh import global_batch


def adjust_confidence(gt_box_num: int, pred_box_num: int, conf: float) -> float:
    """val_conf feedback controller (reference train.py:434-440)."""
    if pred_box_num > gt_box_num * 3:
        conf = conf + 0.01
    elif pred_box_num < gt_box_num * 2 and conf > 0.01:
        conf = conf - 0.01
    return conf


class Evaluator:
    """Accumulates detections/GT over batches and computes mAP.

    ``add_batch`` consumes the fixed-K padded outputs of
    :func:`mobilenet_yolo_tpu_torch.eval.detector.make_predict_fn` (as numpy)
    plus padded GT arrays; padding is stripped here on the host (the
    reference keeps ragged python lists throughout, train.py:348-394).
    """

    def __init__(self, classes_name: list[str]):
        self.classes_name = list(classes_name)
        self.reset()

    def reset(self):
        self.det_boxes: list[np.ndarray] = []
        self.det_labels: list[np.ndarray] = []
        self.det_scores: list[np.ndarray] = []
        self.true_boxes: list[np.ndarray] = []
        self.true_labels: list[np.ndarray] = []
        self.true_difficulties: list[np.ndarray] = []
        self.gt_box_count = 0
        self.pred_box_count = 0
        self.n_images = 0

    def add_batch(self, dets, keep, gt, n_gt, difficulties=None):
        """dets: (B,K,7); keep: (B,K); gt: (B,T,5) (label,cx,cy,w,h); n_gt: (B,)."""
        dets = np.asarray(dets)
        keep = np.asarray(keep)
        gt = np.asarray(gt)
        n_gt = np.asarray(n_gt)
        for b in range(dets.shape[0]):
            d = dets[b][keep[b]]
            self.det_boxes.append(d[:, :4])
            self.det_labels.append(d[:, 6].astype(np.int64) + 1)
            self.det_scores.append(d[:, 4] * d[:, 5])
            self.pred_box_count += len(d)

            n = int(n_gt[b])
            g = gt[b, :n]
            cx, cy, w, h = g[:, 1], g[:, 2], g[:, 3], g[:, 4]
            boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
            self.true_boxes.append(boxes.astype(np.float32))
            self.true_labels.append(g[:, 0].astype(np.int64))
            if difficulties is not None:
                self.true_difficulties.append(np.asarray(difficulties[b][:n], np.float32))
            else:
                self.true_difficulties.append(np.zeros(n, np.float32))
            self.gt_box_count += n
            self.n_images += 1

    def compute(self):
        return calculate_mAP(
            self.det_boxes, self.det_labels, self.det_scores,
            self.true_boxes, self.true_labels, self.true_difficulties,
            self.classes_name,
        )

    def compute_coco(self, max_dets: int = 100, img_size=None) -> dict:
        """COCO metric family (AP@[.5:.95]/AP50/AP75 + area-range APs)
        over the same accumulated detections (``ops/coco_ap.py``; the
        difficult flag maps to COCO's ignore). ``img_size`` = (w, h)
        evaluation resolution, the pixel frame for APsmall/medium/large
        (skipped as -1.0 when None)."""
        return calculate_coco_map(
            self.det_boxes, self.det_labels, self.det_scores,
            self.true_boxes, self.true_labels, self.true_difficulties,
            self.classes_name, max_dets=max_dets, img_size=img_size,
        )

    def adjusted_conf(self, conf: float) -> float:
        return adjust_confidence(self.gt_box_count, self.pred_box_count, conf)


def evaluate_detection(
    predict_fn: Callable,
    loader: Iterable,
    classes_name: list[str],
    val_conf: float,
    pad_multiple: int = 1,
    batch_size: int | None = None,
    log: Callable[[str], None] | None = None,
    coco_ap: bool = False,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict:
    """The one evaluation loop (VOC protocol): fixed-shape batch padding,
    difficult-flag threading (reference eval_mAP.py:8-67 skips difficult GT
    in both the n_easy denominator and the FP count), optional
    segmentation mIoU, and the val_conf feedback controller's pred/GT
    counts.

    * ``predict_fn(images, val_conf)`` is the port's predict
      (``make_predict_fn``), which closes over its model on ``device``:
      the card unless the caller asks for the CPU.
    * ``loader`` yields Loader-style dicts of numpy arrays (``images``,
      ``gt``, ``n_gt``, optional ``gt_difficult`` and ``seg_maps``); each
      batch moves to ``device`` and is padded with zero images up to the
      largest size seen so far, rounded to ``pad_multiple``, so every call
      sees one batch shape. The images keep the loader's dtype.
    * ``mesh`` (``evaluator.py:111-167``): ``predict_fn`` is the sharded
      predict of the same mesh. Every rank reads the same full loader; each
      padded batch (``pad_multiple`` rounded up to a multiple of the data
      axis) goes in as this rank's rows (``parallel.mesh.global_batch``),
      and every rank gets the whole batch's detections back, so the mAP and
      the val_conf controller are the same on every rank.
    * returns ``{"mAP", "aps", "new_conf", "seg_miou", "tp", "fp"}``
      (``seg_miou`` None without a seg head/maps), plus ``"coco"`` with
      ``coco_ap=True``.
    """
    device = torch.device(device)
    ev = Evaluator(classes_name)
    seg_acc = None
    vc = torch.tensor(val_conf, dtype=torch.float32, device=device)
    if mesh is not None:
        pad_multiple = math.lcm(pad_multiple, mesh.n_data)

    def round_up(n: int) -> int:
        return -(-n // pad_multiple) * pad_multiple

    if batch_size is not None:
        batch_size = round_up(batch_size)
    eval_wh = None  # (w, h) pixel frame for the COCO area-range APs
    for batch in loader:
        images = torch.from_numpy(np.asarray(batch["images"])).to(device)
        if eval_wh is None:
            eval_wh = (images.shape[2], images.shape[1])
        n = images.shape[0]
        batch_size = (round_up(n) if batch_size is None
                      else max(batch_size, round_up(n)))
        if n < batch_size:
            images = torch.cat([images, images.new_zeros((batch_size - n,) + images.shape[1:])])
        out = predict_fn(images if mesh is None else global_batch(mesh, images), vc)
        ev.add_batch(out[0][:n].cpu().numpy(), out[1][:n].cpu().numpy(), batch["gt"],
                     batch["n_gt"], difficulties=batch.get("gt_difficult"))
        if len(out) > 2 and "seg_maps" in batch:
            if seg_acc is None:
                seg_acc = SegMetricAccumulator(out[2].shape[-1])
            truth = torch.from_numpy(np.asarray(batch["seg_maps"])).to(device)
            seg_acc.add_batch(out[2][:n], truth)
    seg_miou = None
    if seg_acc is not None:
        _, seg_miou = seg_acc.compute()
        if log:
            log(f"  seg mIoU {seg_miou:.4f}")
    new_conf = ev.adjusted_conf(float(val_conf))
    aps, mAP, tp, fp = ev.compute()
    if log:
        log(f"  val_conf -> {new_conf:.3f}; mAP {mAP:.4f}")
    res = {"mAP": mAP, "aps": aps, "new_conf": new_conf,
           "seg_miou": seg_miou, "tp": tp, "fp": fp}
    if coco_ap:
        res["coco"] = ev.compute_coco(img_size=eval_wh)
        if log:
            c = res["coco"]
            log(f"  COCO AP {c['AP']:.4f} AP50 {c['AP50']:.4f} "
                f"AP75 {c['AP75']:.4f} APs {c['APsmall']:.4f} "
                f"APm {c['APmedium']:.4f} APl {c['APlarge']:.4f}")
    return res
