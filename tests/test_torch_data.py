"""The port's input pipeline (``mobilenet_yolo_tpu_torch/data/``) against the
JAX package's, on the CPU.

Mirrors ``tests/test_data_pipeline.py`` on the port, then holds the port's
``Loader`` to the JAX ``Loader``: on one shard and seed both yield
bit-identical numpy batches (``array_equal``) for two epochs in every mode
(host float32, uint8 with the photometric programs, device geometry, the
seg route), after a ``set_epoch``/``set_skip`` resume and per rank of a
2-rank ``shard_by_process`` split. ``WorkerLoader`` (the counterpart of
``GrainLoader``) yields the ``Loader``'s batches in its order. Last, the
standalone device aug ops (``color_jitter``, ``additive_noise``,
``device_pixel_aug``) against JAX.

Inactive slots of a device-geometry batch hold whatever the slot ring's
buffer held before (``Loader._slot_buffer``): they are compared by their
mask, the active slots byte for byte.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.data import pipeline as j_pipeline
from mobilenet_yolo_tpu.data import records as j_records
from mobilenet_yolo_tpu.data import augment as j_augment
from mobilenet_yolo_tpu.data import mosaic as j_mosaic
from mobilenet_yolo_tpu.ops import device_augment as j_device_augment
from mobilenet_yolo_tpu_torch.data import augment
from mobilenet_yolo_tpu_torch.data.mosaic import generate_mosaic_mask, group_indices, mosaic
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader, batch_to_device
from mobilenet_yolo_tpu_torch.data.records import RecordReader, RecordWriter
from mobilenet_yolo_tpu_torch.data.workers import WorkerLoader
from mobilenet_yolo_tpu_torch.ops import device_augment

SIZES = [[32, 32], [48, 48], [64, 64]]


def _scene(rng, h=120, w=160):
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    boxes = np.asarray([[20, 30, 80, 90], [100, 10, 150, 60]], np.float32)
    labels = np.asarray([1.0, 2.0], np.float32)
    diffs = np.zeros(2, np.float32)
    return img, boxes, labels, diffs


def _jpeg(img) -> bytes:
    return cv2.imencode(".jpg", img)[1].tobytes()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """14 JPEG records of 50-120 px sides, 1-3 boxes each, some difficult."""
    rng = np.random.default_rng(0)
    d = str(tmp_path_factory.mktemp("data") / "shard")
    with RecordWriter(d) as w:
        for i in range(14):
            h, wd = (int(x) for x in rng.integers(50, 121, 2))
            n = 1 + i % 3
            cxy = rng.uniform(0.3, 0.7, (n, 2))
            wh = rng.uniform(0.1, 0.5, (n, 2))
            rows = np.concatenate([np.full((n, 1), 1 + i % 5), cxy, wh,
                                   (rng.random((n, 1)) < 0.2)], 1).astype(np.float32)
            w.append_record(_jpeg(rng.integers(0, 255, (h, wd, 3), np.uint8)), rows)
    return d


@pytest.fixture(scope="module")
def seg_shard(tmp_path_factory):
    """6 records with single-channel PNG class-id maps (classes 0-2)."""
    rng = np.random.default_rng(1)
    d = str(tmp_path_factory.mktemp("seg") / "shard")
    with RecordWriter(d) as w:
        for i in range(6):
            seg = np.zeros((40, 56), np.uint8)
            seg[10 + i:30] = 1
            seg[30:, 20:] = 2
            w.append_record(_jpeg(rng.integers(0, 255, (40, 56, 3), np.uint8)),
                            np.asarray([[1 + i % 2, 0.5, 0.5, 0.4, 0.5]], np.float32),
                            cv2.imencode(".png", seg)[1].tobytes())
    return d


# ----------------------------------------------- test_data_pipeline.py mirrors


def test_hflip_geometry(rng):
    img, boxes, *_ = _scene(rng)
    out, nb, _ = augment.hflip(img, boxes)
    np.testing.assert_array_equal(out, img[:, ::-1])
    np.testing.assert_allclose(nb[0], [79, 30, 139, 90])
    assert (nb[:, 0] <= nb[:, 2]).all()


def test_expand_contains_original(rng):
    img, boxes, *_ = _scene(rng)
    out, nb, _ = augment.expand(img, boxes, (0.5, 0.5, 0.5), 2.0, rng)
    assert out.shape[0] >= img.shape[0] and out.shape[1] >= img.shape[1]
    np.testing.assert_allclose(nb[:, 2] - nb[:, 0], boxes[:, 2] - boxes[:, 0])
    assert (nb >= 0).all()


def test_random_crop_keeps_centered_boxes(rng):
    img, boxes, labels, diffs = _scene(rng)
    out, nb, nl, nd, _ = augment.random_crop(img, boxes, labels, diffs, rng)
    assert out.ndim == 3 and nb.shape[0] == nl.shape[0] == nd.shape[0] >= 1
    assert (nb[:, :2] >= -1e-5).all()
    assert (nb[:, 2] <= out.shape[1] + 1e-5).all() and (nb[:, 3] <= out.shape[0] + 1e-5).all()


@pytest.mark.parametrize("op", ["photometric_distort", "pixel_noise"])
def test_pixel_ops_keep_shape_and_dtype(rng, op):
    img, *_ = _scene(rng)
    out = getattr(augment, op)(img, rng)
    assert out.shape == img.shape and out.dtype == np.uint8


def test_gaussian_blur_matches_dense_conv(rng):
    img = rng.integers(0, 255, (12, 14, 3), np.uint8)
    sigma = 0.8
    radius = max(1, int(round(3.0 * sigma)))
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k1 = np.exp(-0.5 * (t / sigma) ** 2)
    k2 = np.outer(k1 / k1.sum(), k1 / k1.sum())
    xp = np.pad(img.astype(np.float64), [(radius, radius), (radius, radius), (0, 0)], mode="edge")
    want = np.zeros(img.shape, np.float64)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            want += k2[dy, dx] * xp[dy:dy + 12, dx:dx + 14]
    np.testing.assert_allclose(augment.gaussian_blur(img, sigma), want, atol=1e-3)
    np.testing.assert_array_equal(augment.gaussian_blur(img, 0.0), img)


def test_median_blur_matches_naive(rng):
    img = rng.integers(0, 255, (10, 11, 3), np.uint8)
    for k in (3, 5):
        pad = k // 2
        xp = np.pad(img, [(pad, pad), (pad, pad), (0, 0)], mode="edge")
        want = np.empty(img.shape, np.float32)
        for y in range(10):
            for x in range(11):
                want[y, x] = np.median(xp[y:y + k, x:x + k].reshape(-1, 3), axis=0)
        np.testing.assert_allclose(augment.median_blur(img, k), want)


def test_sharpen_matches_dense_kernel(rng):
    img = rng.integers(0, 255, (9, 9, 3), np.uint8)
    alpha, light = 0.07, 1.05
    kern = np.full((3, 3), -1.0)
    kern[1, 1] = 8.0 + light
    ident = np.zeros((3, 3))
    ident[1, 1] = 1.0
    blended = (1 - alpha) * ident + alpha * kern
    xp = np.pad(img.astype(np.float64), [(1, 1), (1, 1), (0, 0)], mode="edge")
    want = np.zeros(img.shape, np.float64)
    for dy in range(3):
        for dx in range(3):
            want += blended[dy, dx] * xp[dy:dy + 9, dx:dx + 9]
    np.testing.assert_allclose(augment.sharpen(img, alpha, light), want, atol=1e-3)


def test_cv2_and_numpy_filter_paths_agree(rng, monkeypatch):
    """The cv2 filters match the numpy fallbacks ``_try_cv2`` keeps."""
    img = rng.integers(0, 255, (24, 30, 3), np.uint8)
    assert augment._try_cv2() is cv2

    def numpy_path(fn, *a):
        with monkeypatch.context() as m:
            m.setattr(augment, "_CV2", None)
            return fn(*a)

    for sigma in (0.4, 0.9):
        np.testing.assert_allclose(augment.gaussian_blur(img, sigma),
                                   numpy_path(augment.gaussian_blur, img, sigma), atol=2e-3)
    for k in (3, 5):
        np.testing.assert_allclose(augment.median_blur(img, k),
                                   numpy_path(augment.median_blur, img, k), atol=1e-5)
    np.testing.assert_allclose(augment.sharpen(img, 0.08, 1.05),
                               numpy_path(augment.sharpen, img, 0.08, 1.05), atol=2e-3)
    np.testing.assert_allclose(augment.adjust_hue(img.astype(np.float32), 0.07),
                               numpy_path(augment.adjust_hue, img.astype(np.float32), 0.07),
                               atol=0.05)


def test_mosaic_mask_partitions():
    rng = np.random.default_rng(0)
    for num in (1, 2, 3, 4):
        tiles = generate_mosaic_mask(num, (100, 100), rng)
        assert len(tiles) == num
        assert sum((t[2] - t[0]) * (t[3] - t[1]) for t in tiles) == 100 * 100


def test_mosaic_composes_labels(rng):
    group = [(rng.integers(0, 255, (100, 100, 3), np.uint8),
              np.asarray([[1 + i, 0.5, 0.5, 0.4, 0.4]], np.float32)) for i in range(4)]
    img, labels = mosaic(group, (200, 200), rng)
    assert img.shape == (200, 200, 3) and labels.shape == (4, 5)
    assert (labels[:, 1] - labels[:, 3] / 2 >= -1e-5).all()
    assert (labels[:, 2] - labels[:, 4] / 2 >= -1e-5).all()
    assert (labels[:, 1] + labels[:, 3] / 2 <= 1 + 1e-5).all()


def test_group_indices_covers_all():
    batches = list(group_indices(range(100), 8, [1, 4], np.random.default_rng(0)))
    seen = [i for b in batches for g in b for i in g]
    assert len(set(seen)) == len(seen) and sorted(seen) == list(range(len(seen)))
    assert len(seen) > 100 - 4
    assert all(len(b) == 8 for b in batches[:-1])
    assert all(len(g) in (1, 4) for b in batches for g in b)


@pytest.mark.parametrize("op", ["photometric_distort", "pixel_noise", "transform_od", "mosaic",
                                "group_indices"])
def test_host_augmentation_is_bit_identical_to_jax(op):
    """One seed, one stream: the copied ops give the JAX ops' arrays."""
    outs = []
    for mod, mos in ((augment, mosaic), (j_augment, j_mosaic.mosaic)):
        rng = np.random.default_rng(5)
        img, boxes, labels, diffs = _scene(np.random.default_rng(4))
        if op == "transform_od":
            out = mod.transform_od(img, boxes, labels, diffs, rng, phase="train")[:4]
        elif op == "mosaic":
            out = mos([(img, np.asarray([[1, 0.5, 0.5, 0.4, 0.4]], np.float32))] * 3,
                      (200, 160), rng)
        elif op == "group_indices":
            gi = group_indices if mod is augment else j_mosaic.group_indices
            out = [np.asarray([i for g in b for i in g]) for b in gi(range(50), 8, [1, 4], rng)]
        else:
            out = [getattr(mod, op)(img, rng)]
        outs.append(out)
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_record_pipeline_end_to_end(shard):
    ds = DetectionDataset(RecordReader(shard), phase="train", expand_scale=1.5)
    loader = Loader(ds, batch_size=4, transform_size=[[64, 64], [96, 96]], mean=[0.5] * 3,
                    std=[1.0] * 3, mosaic_num=[1, 4], max_gt=10, prefetch=0)
    batches = list(loader)
    assert len(batches) >= 1
    for b in batches:
        bsz, h, w_, c = b["images"].shape
        assert (h, w_) in ((64, 64), (96, 96)) and c == 3 and bsz == 4
        assert b["gt"].shape == (bsz, 10, 5) and (b["n_gt"] >= 0).all()
        assert np.isfinite(b["images"]).all()
    loader_t = Loader(DetectionDataset(RecordReader(shard), phase="test"), batch_size=4,
                      transform_size=[[64, 64]], mean=[0.5] * 3, std=[1.0] * 3,
                      shuffle=False, prefetch=0)
    bt = list(loader_t)
    assert sum(b["images"].shape[0] for b in bt) == 14
    assert max(b["n_gt"].max() for b in bt) == 3


def test_difficult_flag_end_to_end(tmp_path, rng):
    """Difficulty threads shard -> Loader -> the port's Evaluator: a match on
    a difficult GT is neither TP nor FP, and never a missed box."""
    from mobilenet_yolo_tpu_torch.eval.evaluator import Evaluator

    d = str(tmp_path / "shard")
    per_image = [np.asarray([[1, 0.3, 0.3, 0.2, 0.2, 0.0], [1, 0.7, 0.7, 0.2, 0.2, 1.0]],
                            np.float32),
                 np.asarray([[1, 0.5, 0.5, 0.4, 0.4, 0.0]], np.float32)]
    with RecordWriter(d) as w:
        for labels in per_image:
            w.append_record(_jpeg(rng.integers(0, 255, (80, 80, 3), np.uint8)), labels)
    loader = Loader(DetectionDataset(RecordReader(d), phase="test"), batch_size=2,
                    transform_size=[[64, 64]], mean=[0.5] * 3, std=[1.0] * 3, shuffle=False,
                    prefetch=0, max_gt=4)
    batch = next(iter(loader))
    np.testing.assert_allclose(batch["gt_difficult"][0, :2], [0.0, 1.0])
    np.testing.assert_allclose(batch["gt_difficult"][1, :1], [0.0])
    dets = np.zeros((2, 4, 7), np.float32)
    keep = np.zeros((2, 4), bool)
    for b, labels in enumerate(per_image):
        cx, cy, w, h = labels[:, 1], labels[:, 2], labels[:, 3], labels[:, 4]
        n = len(labels)
        dets[b, :n, :4] = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        dets[b, :n, 4:6] = 0.9
        keep[b, :n] = True
    ev = Evaluator(["background", "c1"])
    ev.add_batch(dets, keep, batch["gt"], batch["n_gt"], difficulties=batch["gt_difficult"])
    aps, mAP, tp, fp = ev.compute()
    assert mAP == pytest.approx(1.0) and tp["c1"] == 2 and fp["c1"] == 0


def test_uint8_loader_matches_float_loader(shard):
    mean, std = [0.45, 0.5, 0.55], [0.9, 1.0, 1.1]

    def batches(uint8):
        ld = Loader(DetectionDataset(RecordReader(shard), phase="test"), 3, [[64, 64]], mean,
                    std, shuffle=False, prefetch=0, output_uint8=uint8, shard_by_process=False)
        return list(ld)

    f_batches, u_batches = batches(False), batches(True)
    assert len(f_batches) == len(u_batches)
    m, s = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    for fb, ub in zip(f_batches, u_batches):
        assert ub["images"].dtype == np.uint8
        np.testing.assert_allclose(fb["images"], (ub["images"] / np.float32(255.0) - m) / s,
                                   atol=1e-5)
        np.testing.assert_allclose(fb["gt"], ub["gt"])


def test_seg_rasterization(tmp_path, rng):
    d = str(tmp_path / "shard")
    seg = np.zeros((80, 100), np.uint8)
    seg[:40] = 1
    seg[40:] = 2
    with RecordWriter(d) as w:
        w.append_record(_jpeg(rng.integers(0, 255, (80, 100, 3), np.uint8)),
                        np.asarray([[1, 0.5, 0.5, 0.5, 0.5]], np.float32),
                        cv2.imencode(".png", np.repeat(seg[..., None], 3, -1))[1].tobytes())
    ds = DetectionDataset(RecordReader(d), phase="test", has_seg=True, seg_num_classes=2)
    b = next(iter(Loader(ds, 1, [[64, 64]], [0.5] * 3, [1.0] * 3, prefetch=0)))
    assert b["seg_maps"].shape == (1, 4, 4, 2)
    assert b["seg_maps"][0, 0, 0, 0] > 0.9 and b["seg_maps"][0, 3, 0, 1] > 0.9


def test_multi_host_sharded_plan(shard):
    """Each rank yields its half of the SAME global batch: equal step
    counts, the same (H, W) per step."""
    def rank_loader(p_idx, n_proc):
        ds = DetectionDataset(RecordReader(shard), phase="train", apply_noise=False)
        loader = Loader(ds, batch_size=4, transform_size=[[32, 32], [64, 64]], mean=[0.5] * 3,
                        std=[1.0] * 3, mosaic_num=[1], max_gt=4, prefetch=0,
                        shard_by_process=True)
        loader._process_slice = lambda: (p_idx, n_proc)
        loader.epoch = 1
        return loader, list(loader._epoch_batches())

    l0, b0 = rank_loader(0, 2)
    _, b1 = rank_loader(1, 2)
    _, bfull = rank_loader(0, 1)
    assert len(b0) == len(b1) == len(bfull) > 0
    for a, b, f in zip(b0, b1, bfull):
        assert a["images"].shape == b["images"].shape
        assert a["images"].shape[0] == 2 and f["images"].shape[0] == 4
        assert a["images"].shape[1:] == f["images"].shape[1:]
    assert len(l0) == 7


def test_rank_seam_reads_torch_distributed(shard, monkeypatch):
    """``shard_by_process=None`` turns on under a multi-rank
    ``torch.distributed`` and takes its rank; off without one."""
    ds = DetectionDataset(RecordReader(shard), phase="train")
    assert Loader(ds, 4, SIZES, [0.5] * 3, [1.0] * 3)._process_slice() == (0, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    loader = Loader(ds, 4, SIZES, [0.5] * 3, [1.0] * 3)
    assert loader.shard_by_process and loader._process_slice() == (1, 2) and len(loader) == 7
    with pytest.raises(ValueError, match="not divisible"):
        Loader(ds, 3, SIZES, [0.5] * 3, [1.0] * 3)._sharded_plan()


# --------------------------------------------------- bit-identical to the JAX Loader


MODES = {
    # the host path: photometric, expand/crop/flip, mosaic, resize, normalize
    "host_f32": dict(),
    # raw uint8, the photometric programs planned for the device
    "uint8_programs": dict(output_uint8=True, apply_photometric=False),
    # staged slots and compose parameters, programs and noise planned
    "device_geometry": dict(device_geometry=True, apply_photometric=False),
    # device geometry with the photometric pass on the host
    "device_geometry_host_photometric": dict(device_geometry=True),
}
DATASET_KEYS = ("apply_noise", "apply_photometric", "has_seg", "seg_num_classes")


def _loader(pkg, shard, kw, seed=3, phase="train", loader_cls=None, **extra):
    """The same Loader on the port (``pkg="port"``) or the JAX package."""
    kw = {**kw, **extra}
    ds_kw = {k: kw.pop(k) for k in DATASET_KEYS if k in kw}
    if pkg == "port":
        ds = DetectionDataset(RecordReader(shard), phase=phase, **ds_kw)
        cls = loader_cls or Loader
    else:
        ds = j_pipeline.DetectionDataset(j_records.RecordReader(shard), phase=phase, **ds_kw)
        cls = j_pipeline.Loader
    kw.setdefault("prefetch", 2)
    return cls(ds, 4, SIZES, [0.45, 0.5, 0.55], [0.9, 1.0, 1.1], mosaic_num=[1, 4],
               max_gt=6, seed=seed, shard_by_process=False, **kw)


def _epochs(loader, n=2):
    return [b for _ in range(n) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in ("slots", "seg_slots"):
                mask = w["active"] if k == "slots" else w["seg_active"]
                np.testing.assert_array_equal(g[k].shape, w[k].shape)
                np.testing.assert_array_equal(g[k][mask], w[k][mask], err_msg=k)
            else:
                assert type(g[k]) is type(w[k]), k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("mode", MODES)
def test_loader_batches_bit_identical_to_jax(shard, mode):
    """Two epochs, three buckets, mosaic [1, 4]: every array equal."""
    got = _epochs(_loader("port", shard, MODES[mode]))
    want = _epochs(_loader("jax", shard, MODES[mode]))
    _assert_batches_equal(got, want)
    sizes = {b["images"].shape[1] if "images" in b else b["out_size"][0] for b in got}
    assert len(sizes) >= 2, sizes
    if "slots" in got[0]:
        assert any(b["active"].sum(1).max() == 4 for b in got)  # a mosaic group


@pytest.mark.parametrize("mode", ["host_f32", "device_geometry"])
def test_resume_is_bit_identical(shard, mode):
    """``set_epoch`` + ``set_skip`` on a fresh loader give the rest of the
    interrupted epoch: the uninterrupted run's batches, and the JAX
    loader's after the same calls."""
    full = _epochs(_loader("port", shard, MODES[mode]))
    per_epoch = len(full) // 2
    resumed, j_resumed = _loader("port", shard, MODES[mode]), _loader("jax", shard, MODES[mode])
    for ld in (resumed, j_resumed):
        ld.set_epoch(1)
        ld.set_skip(1)
    got = list(resumed)
    _assert_batches_equal(got, full[per_epoch + 1:])
    _assert_batches_equal(got, list(j_resumed))


@pytest.mark.parametrize("mode", ["host_f32", "device_geometry"])
def test_two_rank_split_bit_identical_to_jax(shard, mode):
    """Each rank of a 2-rank split (rank and world size through the
    ``_process_slice`` seam) yields the JAX rank's batches."""
    for rank in (0, 1):
        loaders = [_loader(pkg, shard, MODES[mode]) for pkg in ("port", "jax")]
        for ld in loaders:
            ld.shard_by_process = True
            ld._process_slice = lambda rank=rank: (rank, 2)
        got, want = (_epochs(ld, 1) for ld in loaders)
        assert all(len(b["gt"]) == 2 for b in got)
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("route", ["host_train", "host_test", "device_geometry"])
def test_seg_route_bit_identical_to_jax(seg_shard, route):
    kw = dict(has_seg=True, seg_num_classes=2, apply_photometric=route == "host_train")
    if route == "device_geometry":
        kw["device_geometry"] = True
    phase = "test" if route == "host_test" else "train"
    got = _epochs(_loader("port", seg_shard, kw, phase=phase))
    want = _epochs(_loader("jax", seg_shard, kw, phase=phase))
    _assert_batches_equal(got, want)
    key = "seg_slots" if route == "device_geometry" else "seg_maps"
    assert all(key in b for b in got)


@pytest.mark.parametrize("mode", ["host_f32", "device_geometry"])
def test_worker_loader_in_process_equals_loader(shard, mode):
    got = _epochs(_loader("port", shard, MODES[mode], loader_cls=WorkerLoader, num_workers=0))
    _assert_batches_equal(got, _epochs(_loader("port", shard, MODES[mode])))


def test_worker_loader_processes_keep_the_order(shard):
    """Two spawned workers (each reopening the shard) build the batches the
    in-process loader builds, in its order, with a resume skip."""
    kw = MODES["device_geometry"]
    workers = _loader("port", shard, kw, loader_cls=WorkerLoader, num_workers=2, prefetch=0)
    serial = _loader("port", shard, kw)
    workers.set_skip(1)
    serial.set_skip(1)
    _assert_batches_equal(list(workers), list(serial))


def test_prefetch_thread_raises_a_decode_error(tmp_path, shard):
    """A record that does not decode stops the epoch with its error on the
    consumer's side (the JAX loader's thread ends the epoch early
    instead)."""
    src = RecordReader(shard)
    d = str(tmp_path / "bad")
    with RecordWriter(d) as w:
        for i in range(8):
            rec = src[i]
            w.append_record(b"not a jpeg" if i == 5 else rec.image_bytes, rec.labels)
    ds = DetectionDataset(RecordReader(d), phase="test")
    loader = Loader(ds, 2, [[32, 32]], [0.5] * 3, [1.0] * 3, shuffle=False, prefetch=2)
    seen = []
    with pytest.raises(IOError, match="cannot decode image record"):
        for b in loader:
            seen.append(b)
    assert len(seen) == 2  # the batches before the bad record's


def test_batch_to_device_copies_out_of_the_ring(shard):
    """The tensors do not alias the loader's slot ring: refilling the
    buffer after the copy leaves them as they were."""
    batch = next(iter(_loader("port", shard, MODES["device_geometry"], prefetch=0)))
    on_device = batch_to_device(batch, "cpu")
    before = on_device["slots"].clone()
    batch["slots"][...] = 7
    assert torch.equal(on_device["slots"], before)
    assert on_device["out_size"] == batch["out_size"] and on_device["count"] == batch["count"]
    assert on_device["active"].dtype == torch.bool


# ------------------------------------------------ the standalone device aug ops


def _jax_jitter_draws(key, b):
    """``device_augment.py:72-101``'s gates and factors, recomputed from the
    key as the JAX op splits it."""
    keys = jax.random.split(key, 6)

    def gate_and_factor(k):
        ka, kb = jax.random.split(k)
        apply = jax.random.uniform(ka, (b, 1, 1, 1)) < 0.5
        f = jax.random.uniform(kb, (b, 1, 1, 1), minval=0.5, maxval=1.5)
        return np.array(jnp.where(apply, f, 1.0)).reshape(b)

    ka, kb = jax.random.split(keys[3])
    return {"brightness": gate_and_factor(keys[0]), "contrast": gate_and_factor(keys[1]),
            "saturation": gate_and_factor(keys[2]),
            "apply_hue": np.array(jax.random.uniform(ka, (b, 1, 1)) < 0.5).reshape(b),
            "hue": np.array(jax.random.uniform(kb, (b, 1, 1), minval=-18 / 255.0,
                                               maxval=18 / 255.0)).reshape(b),
            "gamma": gate_and_factor(keys[4])}


def test_color_jitter_matches_jax():
    """The JAX op's draws fed to the port's: the same fixed order and clip
    points (brightness up to 1.5x feeds the contrast mean unclipped). f32
    on both sides; the hue round trip sets the tolerance (1e-3 of 255)."""
    b = 16
    images = np.random.default_rng(0).integers(0, 256, (b, 12, 10, 3), np.uint8)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(j_device_augment.color_jitter)(jnp.asarray(images), key))
    draws = _jax_jitter_draws(key, b)
    assert draws["apply_hue"].any() and not draws["apply_hue"].all()
    got = device_augment.apply_color_jitter(torch.from_numpy(images),
                                            **{k: torch.from_numpy(v) for k, v in draws.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    # the port's own draws: a gate each, factors in range, a fixed stream
    g = torch.Generator().manual_seed(0)
    params = device_augment.jitter_params(4096, g)
    for name in ("brightness", "contrast", "saturation", "gamma"):
        on = params[name] != 1.0
        assert abs(float(on.float().mean()) - 0.5) < 0.05
        assert float(params[name][on].min()) >= 0.5 and float(params[name].max()) < 1.5
    assert float(params["hue"].abs().max()) <= 18 / 255.0
    torch.testing.assert_close(
        device_augment.color_jitter(torch.from_numpy(images), torch.Generator().manual_seed(1)),
        device_augment.color_jitter(torch.from_numpy(images), torch.Generator().manual_seed(1)))


def test_additive_noise_gate_scale_and_statistics():
    """Gate p=0.5, scale U(0, 0.03*255), per-channel p=0.3; the noise of a
    gated image is N(0, scale) on mid-grey, shared across channels unless
    per-channel. The JAX op's output has the same bulk statistics."""
    b, h, w = 512, 16, 16
    images = torch.full((b, h, w, 3), 128, dtype=torch.uint8)
    out = device_augment.additive_noise(images, torch.Generator().manual_seed(0))
    delta = out - 128.0
    noised = delta.abs().amax(dim=(1, 2, 3)) > 0
    assert abs(float(noised.float().mean()) - 0.5) < 0.07
    std = delta[noised].reshape(-1, h * w * 3).std(dim=1)
    assert float(std.max()) <= 0.03 * 255.0 * 1.3
    shared = (delta[noised][..., 0] == delta[noised][..., 1]).all(dim=(1, 2))
    assert abs(float((~shared).float().mean()) - 0.3) < 0.1
    mean_abs = float(delta[noised].abs().mean())
    j_out = np.asarray(jax.jit(j_device_augment.additive_noise)(
        jnp.asarray(images.numpy()), jax.random.PRNGKey(0))) - 128.0
    j_noised = np.abs(j_out).max(axis=(1, 2, 3)) > 0
    # mean |noise| of U(0, 7.65)-scaled normals: 7.65 / 2 * sqrt(2 / pi) = 3.05
    assert abs(mean_abs - 3.05) < 0.35 and abs(np.abs(j_out[j_noised]).mean() - 3.05) < 0.35
    assert abs(float(delta.mean())) < 0.05


def test_device_pixel_aug_is_jitter_then_noise():
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 10, 12, 3), np.uint8))
    got = device_augment.device_pixel_aug(images, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    want = device_augment.additive_noise(device_augment.color_jitter(images, g), g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.dtype == torch.float32 and 0.0 <= float(got.min()) and float(got.max()) <= 255.0
