"""The port's evaluation slice against the JAX package's, on the CPU.

* ``calculate_mAP`` and ``calculate_coco_map`` (numpy copies) on seeded
  random detections and ground truth with difficult flags: equal results.
* The seg metrics (torch, int64 counts): exact counts, mIoU within 1e-7
  (JAX divides in float32, the port in float64).
* ``Evaluator`` on the same padded detections: equal results.
* ``evaluate_detection`` end to end on a small MBv2-YOLO at 64x64, 3
  batches with a ragged tail, with a seg head and without, against JAX
  ``evaluate_detection`` over JAX ``make_predict_fn``: ``keep``, the TP/FP
  counts and ``new_conf`` exact, ``mAP`` within 1e-6. The weights are the
  JAX init carried across by ``convert.py`` with ``perturb``'s redrawn
  ``out`` convs, and BatchNorm statistics calibrated on one batch
  (``models/bn_fold.py:calibrate_bn``) and written back into the JAX
  variables, so both packages serve one network. Uncalibrated, the heads
  do not depend on the input: every image gets the same scores to ~1e-7,
  the packages' float32 rounding (~4e-7) then orders the global score
  sort, and the precision curve with it.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.eval import Evaluator as JaxEvaluator
from mobilenet_yolo_tpu.eval import evaluate_detection as jax_evaluate_detection
from mobilenet_yolo_tpu.eval.detector import make_predict_fn as jax_make_predict_fn
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.ops import seg_metrics as jax_seg
from mobilenet_yolo_tpu.ops.ap import calculate_mAP as jax_calculate_mAP
from mobilenet_yolo_tpu.ops.coco_ap import calculate_coco_map as jax_calculate_coco_map
from mobilenet_yolo_tpu_torch.eval import Evaluator, adjust_confidence, evaluate_detection
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.bn_fold import calibrate_bn
from mobilenet_yolo_tpu_torch.ops import seg_metrics
from mobilenet_yolo_tpu_torch.ops.ap import calculate_mAP
from mobilenet_yolo_tpu_torch.ops.coco_ap import calculate_coco_map

from _torch_parity import SMALL_YOLO_CONFIG, jax_init, nhwc_input, perturb, port_module

CLASSES = ["background", "a", "b", "c"]
MAP_TOL = 1e-6
MIOU_TOL = 1e-7
TOP_K = 512  # cli/eval.py's top_k (K = min(512, 60) at 64x64)


def _random_lists(seed: int, n_images: int = 12):
    """Per-image (det_boxes, det_labels, det_scores, true_boxes,
    true_labels, true_difficulties): GT boxes, detections that jitter some
    of them (hits, duplicates, near misses) and random false positives."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in range(6)]
    for _ in range(n_images):
        n_gt = int(rng.integers(0, 6))
        lo = rng.uniform(0.0, 0.6, (n_gt, 2))
        tb = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (n_gt, 2))], 1).astype(np.float32)
        tl = rng.integers(1, len(CLASSES), n_gt)
        td = (rng.random(n_gt) < 0.2).astype(np.float32)
        pick = rng.integers(0, max(n_gt, 1), int(rng.integers(0, 2 * n_gt + 1))) if n_gt else []
        db = [tb[i] + rng.normal(0, 0.03, 4).astype(np.float32) for i in pick]
        dl = [tl[i] if rng.random() < 0.85 else int(rng.integers(1, len(CLASSES))) for i in pick]
        for _ in range(int(rng.integers(0, 4))):
            lo = rng.uniform(0.0, 0.7, 2)
            db.append(np.concatenate([lo, lo + rng.uniform(0.05, 0.3, 2)]).astype(np.float32))
            dl.append(int(rng.integers(1, len(CLASSES))))
        db = np.asarray(db, np.float32).reshape(-1, 4)
        for lst, v in zip(out, (db, np.asarray(dl, np.int64),
                                rng.random(len(db)).astype(np.float32), tb,
                                tl.astype(np.int64), td)):
            lst.append(v)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calculate_map_matches_jax(seed):
    lists = _random_lists(seed)
    got = calculate_mAP(*lists, CLASSES)
    want = jax_calculate_mAP(*lists, CLASSES)
    assert got == want
    assert 0.0 < got[1] < 1.0 and sum(got[3].values()) > 0  # hits and false positives


@pytest.mark.parametrize("img_size", [None, (352, 352)])
@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_coco_map_matches_jax(seed, img_size):
    lists = _random_lists(seed)
    got = calculate_coco_map(*lists, CLASSES, img_size=img_size)
    want = jax_calculate_coco_map(*lists, CLASSES, img_size=img_size)
    assert got == want
    assert 0.0 < got["AP"] < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = [rng.random((2, 4, 5, 3)).astype(np.float32) for _ in range(3)]
    truth = [(rng.random((2, 4, 5, 3)) < 0.4).astype(np.float32) for _ in range(3)]
    truth[0][..., 2] = 0.0
    pred[0][..., 2] = 0.0  # class 2 empty in batch 0: IoU 1 there
    inter, union = seg_metrics.seg_intersection_union(torch.from_numpy(pred[0]),
                                                      torch.from_numpy(truth[0]))
    j_inter, j_union = jax_seg.seg_intersection_union(jnp.asarray(pred[0]), jnp.asarray(truth[0]))
    assert inter.dtype == union.dtype == torch.int64
    np.testing.assert_array_equal(inter.numpy(), np.asarray(j_inter))
    np.testing.assert_array_equal(union.numpy(), np.asarray(j_union))
    iou, miou = seg_metrics.mean_iou(inter, union)
    j_iou, j_miou = jax_seg.mean_iou(j_inter, j_union)
    np.testing.assert_allclose(iou.numpy(), np.asarray(j_iou), atol=MIOU_TOL)
    assert iou[2] == 1.0 and abs(miou - j_miou) <= MIOU_TOL

    acc, j_acc = seg_metrics.SegMetricAccumulator(3), jax_seg.SegMetricAccumulator(3)
    for p, t in zip(pred, truth):
        acc.add_batch(torch.from_numpy(p), torch.from_numpy(t))
        j_acc.add_batch(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_array_equal(acc.inter.numpy(), j_acc.inter)
    np.testing.assert_array_equal(acc.union.numpy(), j_acc.union)
    assert abs(acc.compute()[1] - j_acc.compute()[1]) <= MIOU_TOL


@pytest.mark.parametrize("gt_boxes,pred_boxes,conf", [(10, 40, 0.1), (10, 15, 0.1),
                                                      (10, 15, 0.01), (10, 25, 0.1)])
def test_adjust_confidence_matches_jax(gt_boxes, pred_boxes, conf):
    from mobilenet_yolo_tpu.eval import adjust_confidence as jax_adjust_confidence

    assert adjust_confidence(gt_boxes, pred_boxes, conf) == \
        jax_adjust_confidence(gt_boxes, pred_boxes, conf)


def test_evaluator_matches_jax():
    """Padded (B, K, 7) detections with keep masks and padded GT rows over
    two batches, one with difficult flags."""
    rng = np.random.default_rng(3)
    ev, j_ev = Evaluator(CLASSES), JaxEvaluator(CLASSES)
    for b, k, t, diff in ((4, 16, 5, True), (3, 16, 5, False)):
        n_gt = rng.integers(0, t + 1, b)
        gt = np.zeros((b, t, 5), np.float32)
        gt[..., 0] = rng.integers(1, len(CLASSES), (b, t))
        gt[..., 1:3] = rng.uniform(0.2, 0.8, (b, t, 2))
        gt[..., 3:5] = rng.uniform(0.05, 0.4, (b, t, 2))
        dets = np.zeros((b, k, 7), np.float32)
        src = rng.integers(0, t, (b, k))
        for i in range(b):
            g = gt[i, src[i]]
            dets[i, :, :2] = g[:, 1:3] - g[:, 3:5] / 2 + rng.normal(0, 0.02, (k, 2))
            dets[i, :, 2:4] = g[:, 1:3] + g[:, 3:5] / 2 + rng.normal(0, 0.02, (k, 2))
            dets[i, :, 6] = np.where(rng.random(k) < 0.8, g[:, 0] - 1, rng.integers(0, 3, k))
        dets[..., 4:6] = rng.uniform(0.3, 1.0, (b, k, 2))
        keep = rng.random((b, k)) < 0.5
        difficulties = (rng.random((b, t)) < 0.2).astype(np.float32) if diff else None
        ev.add_batch(dets, keep, gt, n_gt, difficulties=difficulties)
        j_ev.add_batch(dets, keep, gt, n_gt, difficulties=difficulties)
    got, want = ev.compute(), j_ev.compute()
    assert got == want and 0.0 < got[1] < 1.0
    assert ev.compute_coco(img_size=(64, 64)) == j_ev.compute_coco(img_size=(64, 64))
    assert (ev.gt_box_count, ev.pred_box_count, ev.n_images) == \
        (j_ev.gt_box_count, j_ev.pred_box_count, j_ev.n_images)
    for conf in (0.3, 0.01):
        assert ev.adjusted_conf(conf) == j_ev.adjusted_conf(conf)


def _calibrated(cfg: dict, variables: dict) -> dict:
    """``variables`` with the BatchNorm statistics ``calibrate_bn`` sets on
    one seeded batch."""
    model = port_module(build_model(cfg, device="cpu"), variables)
    calibrate_bn(model, torch.from_numpy(nhwc_input(14, (8, 64, 64, 3))))
    stats = {"running_mean": "mean", "running_var": "var"}
    variables = copy.deepcopy(variables)
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf in stats:
            node = variables["batch_stats"]
            for name in path:
                node = node[name]
            node[stats[leaf]] = value.numpy().copy()
    return variables


@pytest.fixture(scope="module")
def seg_setup():
    cfg = dict(SMALL_YOLO_CONFIG, seg={"num_classes": 2})
    variables = perturb(jax_init(jax_build_model(cfg), nhwc_input(11)), seed=12, out_std=0.02)
    return cfg, _calibrated(cfg, variables)


def _plain(cfg, variables):
    cfg = {k: v for k, v in cfg.items() if k != "seg"}
    variables = {col: {k: v for k, v in tree.items() if not k.startswith("seg_")}
                 for col, tree in variables.items()}
    return cfg, variables


def _loader(predict, seg: bool, seed: int = 13):
    """3 Loader-style batches (4, 4, 3 images at 64x64) whose GT is built
    from the port's own kept detections (jittered, one in five difficult)
    plus a random box, so the mAP is far from 0 and from 1."""
    rng = np.random.default_rng(seed)
    batches = []
    for n in (4, 4, 3):
        images = rng.normal(0.0, 1.0, (n, 64, 64, 3)).astype(np.float32)
        dets, keep = predict(torch.from_numpy(images), torch.tensor(0.3))[:2]
        gt = np.zeros((n, 6, 5), np.float32)
        n_gt = np.zeros(n, np.int32)
        for i in range(n):
            kept = dets[i][keep[i]].numpy()[:5]
            rows = [[d[6] + 1, (d[0] + d[2]) / 2, (d[1] + d[3]) / 2, d[2] - d[0], d[3] - d[1]]
                    for d in kept]
            rows.append([rng.integers(1, len(CLASSES)), *rng.uniform(0.2, 0.8, 2),
                         *rng.uniform(0.1, 0.4, 2)])
            rows = np.asarray(rows, np.float32)
            rows[:, 1:] += rng.normal(0, 0.01, rows[:, 1:].shape)
            gt[i, :len(rows)] = rows
            n_gt[i] = len(rows)
        batch = {"images": images, "gt": gt, "n_gt": n_gt,
                 "gt_difficult": (rng.random((n, 6)) < 0.2).astype(np.float32)}
        if seg:
            batch["seg_maps"] = (rng.random((n, 4, 4, 2)) < 0.5).astype(np.float32)
        batches.append(batch)
    return batches


@pytest.mark.parametrize("seg", [False, True])
def test_evaluate_detection_matches_jax(seg, seg_setup):
    cfg, variables = seg_setup if seg else _plain(*seg_setup)
    predict = make_predict_fn(port_module(build_model(cfg, device="cpu"), variables), cfg,
                              top_k=TOP_K)
    jax_predict = jax_make_predict_fn(jax_build_model(cfg), cfg, top_k=TOP_K)
    loader = _loader(predict, seg)
    keeps, jax_keeps = [], []

    def recorded(images, val_conf):
        out = predict(images, val_conf)
        keeps.append(out[1].numpy())
        return out

    def jax_recorded(v, images, val_conf):
        out = jax_predict(v, images, val_conf)
        jax_keeps.append(np.asarray(out[1]))
        return out

    got = evaluate_detection(recorded, loader, CLASSES, 0.3, coco_ap=True, device="cpu")
    want = jax_evaluate_detection(jax_recorded, variables, loader, CLASSES, 0.3, coco_ap=True)
    assert [k.shape for k in keeps] == [(4, 60)] * 3  # the tail batch padded to 4
    for k, jk in zip(keeps, jax_keeps, strict=True):
        np.testing.assert_array_equal(k, jk)
    assert set(got) == set(want) == {"mAP", "aps", "new_conf", "seg_miou", "tp", "fp", "coco"}
    assert got["tp"] == want["tp"] and got["fp"] == want["fp"]
    assert got["new_conf"] == want["new_conf"]
    assert abs(got["mAP"] - want["mAP"]) <= MAP_TOL and 0.2 < got["mAP"] < 1.0
    for name, ap in want["aps"].items():
        assert abs(got["aps"][name] - ap) <= MAP_TOL, name
    for key in ("AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge"):
        assert abs(got["coco"][key] - want["coco"][key]) <= MAP_TOL, key
    if seg:
        assert 0.0 < got["seg_miou"] < 1.0
        assert abs(got["seg_miou"] - want["seg_miou"]) <= MIOU_TOL
    else:
        assert got["seg_miou"] is None and want["seg_miou"] is None
