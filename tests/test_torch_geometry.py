"""The port's device-geometry planner (``mobilenet_yolo_tpu_torch/data/geometry.py``)
and the slice it feeds, against the JAX package's, on the CPU.

Mirrors the planner tests of ``tests/test_device_geometry.py`` (label
parity with the host pixel path, mosaic groups, multi-rank lockstep, the
seg route, loader batches) on the port; holds ``GeometryPlanner.plan_group``
to the JAX planner draw for draw; and runs one port
``Loader(device_geometry=True)`` batch through the port's
``make_geometry_train_step`` (plain ops, float64) and the JAX geometry step,
to ``test_geometry_step_matches_jax``'s stages and tolerances.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.data import geometry as j_geometry
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu.train import step as j_step
from mobilenet_yolo_tpu_torch.data import augment
from mobilenet_yolo_tpu_torch.data.geometry import (MAX_TILES, GeometryPlanner,
                                                    plan_source_geometry)
from mobilenet_yolo_tpu_torch.data.mosaic import mosaic
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader
from mobilenet_yolo_tpu_torch.data.records import RecordReader, RecordWriter
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.ops.device_augment import geometric_compose
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step)

from _torch_parity import (SMALL_YOLO_CONFIG, assert_bn_stats_match, float64_pair,
                           jax_train_state, state_dict_of, width035_variables64)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _make_shard(tmp_path, rng, n=12, seg=False):
    d = str(tmp_path / "shard")
    with RecordWriter(d) as w:
        for i in range(n):
            img = rng.integers(0, 255, (80, 100, 3), np.uint8)
            seg_bytes = None
            if seg:
                ids = np.zeros((80, 100), np.uint8)
                ids[40:60] = 1
                ids[60:80] = 2
                seg_bytes = cv2.imencode(".png", ids)[1].tobytes()
            w.append_record(cv2.imencode(".jpg", img)[1].tobytes(),
                            np.asarray([[1 + i % 3, 0.5, 0.5, 0.4, 0.5]], np.float32),
                            seg_bytes)
    return d


def _host_single_labels(img, boxes, cls, diff, rng, allow_expand=True, photometric=False):
    """The host pixel path's label math (``DetectionDataset.get_single``)."""
    img2, nb, nl, nd, _ = augment.transform_od(img, boxes, cls, diff, rng, phase="train",
                                               allow_expand=allow_expand, expand_scale=1.5,
                                               photometric=photometric)
    nh, nw = img2.shape[:2]
    if not nb.shape[0]:
        return img2, np.zeros((0, 6), np.float32)
    bw = (nb[:, 2] - nb[:, 0]) / nw
    bh = (nb[:, 3] - nb[:, 1]) / nh
    rows = np.stack([nl, nb[:, 0] / nw + bw / 2, nb[:, 1] / nh + bh / 2, bw, bh, nd], -1)
    return img2, rows.astype(np.float32)


def _source(base, n_boxes=1):
    h, w = int(base.integers(60, 140)), int(base.integers(60, 140))
    img = base.integers(0, 255, (h, w, 3), np.uint8)
    x1, y1 = base.uniform(0, w * 0.5, n_boxes), base.uniform(0, h * 0.5, n_boxes)
    boxes = np.stack([x1, y1, x1 + w * 0.3, y1 + h * 0.3], -1).astype(np.float32)
    return (img, boxes, base.integers(1, 4, n_boxes).astype(np.float32),
            (base.random(n_boxes) < 0.3).astype(np.float32))


# ------------------------------------------------------ planner label parity


def test_single_labels_match_host_path():
    """Same rng stream -> the planner's labels are the host pipeline's."""
    base = np.random.default_rng(3)
    for _ in range(20):
        img, boxes, cls, diff = _source(base, int(base.integers(0, 5)))
        h, w = img.shape[:2]
        seed = int(base.integers(0, 2 ** 31))
        _, host_rows = _host_single_labels(img, boxes.copy(), cls, diff,
                                           np.random.default_rng(seed))
        src, _, _, _, rows = plan_source_geometry(h, w, boxes.copy(), cls, diff,
                                                  np.random.default_rng(seed),
                                                  expand_scale=1.5, allow_expand=True)
        np.testing.assert_allclose(rows, host_rows, rtol=0, atol=1e-6)
        assert (src <= 1.0 + 1e-6).all() and (src >= -1e-6).all()


def test_single_labels_match_host_path_with_photometric():
    """The planner's jitter draws sit where ``transform_od``'s do."""
    base = np.random.default_rng(29)
    planner = GeometryPlanner(stage_size=64, expand_scale=1.5, apply_noise=False)
    for _ in range(10):
        img, boxes, cls, diff = _source(base)
        seed = int(base.integers(0, 2 ** 31))
        _, host_rows = _host_single_labels(img, boxes.copy(), cls, diff,
                                           np.random.default_rng(seed), photometric=True)
        plan = planner.plan_group([(img, boxes.copy(), cls, diff)], np.random.default_rng(seed))
        np.testing.assert_allclose(plan.labels, host_rows, rtol=0, atol=1e-6)
        assert plan.jitter_op.shape == (MAX_TILES, 5)


def test_mosaic_labels_match_host_path():
    base = np.random.default_rng(11)
    planner = GeometryPlanner(stage_size=64, expand_scale=1.5, apply_noise=False)
    assert planner.apply_photometric
    for _ in range(8):
        num = int(base.integers(2, 5))
        sources = [_source(base) for _ in range(num)]
        seed = int(base.integers(0, 2 ** 31))
        hrng = np.random.default_rng(seed)
        group = [_host_single_labels(img, boxes.copy(), cls, diff, hrng, allow_expand=False,
                                     photometric=True) for img, boxes, cls, diff in sources]
        _, host_rows = mosaic(group, (1000, 1000), hrng)
        plan = planner.plan_group([(img, boxes.copy(), cls, diff)
                                   for img, boxes, cls, diff in sources],
                                  np.random.default_rng(seed))
        np.testing.assert_allclose(plan.labels, host_rows, rtol=0, atol=1e-6)
        assert plan.active[:num].all() and not plan.active[num:].any()
        assert plan.fill_from_mean[:num].all()


def test_planner_pixels_close_to_host_path():
    """With the stage at the native size, the port's compose of the plan
    matches the host crop + resize within the resampler's tolerance."""
    s = 96
    base = np.random.default_rng(5)
    img = cv2.GaussianBlur(base.integers(0, 255, (s, s, 3), np.uint8), (9, 9), 3.0)
    boxes = np.asarray([[20, 25, 70, 80]], np.float32)
    cls, diff = np.asarray([1.0], np.float32), np.asarray([0.0], np.float32)
    himg, _ = _host_single_labels(img, boxes.copy(), cls, diff, np.random.default_rng(123),
                                  photometric=True)
    host_out = cv2.resize(himg.astype(np.float32), (64, 64), interpolation=cv2.INTER_LINEAR)
    plan = GeometryPlanner(stage_size=s, expand_scale=1.5, apply_noise=False).plan_group(
        [(img, boxes.copy(), cls, diff)], np.random.default_rng(123))
    args = [torch.from_numpy(np.asarray(a)[None]) for a in (
        plan.slots, plan.src_rect, plan.dst_rect, plan.fill_rect, plan.fill_color,
        plan.fill_from_mean, plan.flip, plan.active)]
    out = geometric_compose(*args, (64, 64), jitter_op=torch.from_numpy(plan.jitter_op[None]),
                            jitter_factor=torch.from_numpy(plan.jitter_factor[None]))[0]
    assert np.abs(out.numpy() - host_out).mean() < 3.0


@pytest.mark.parametrize("tiles", [1, 2, 4])
@pytest.mark.parametrize("seg", [False, True])
def test_plan_group_bit_identical_to_jax(tiles, seg):
    """One seed through both planners, noise and photometric planning on:
    every field of the plan, the staged pixels included, equal."""
    base = np.random.default_rng(tiles + 10 * seg)
    for trial in range(4):
        sources = [_source(base, 2) for _ in range(tiles)]
        if seg:
            sources = [(*src, (base.random(src[0].shape[:2]) * 3).astype(np.uint8))
                       for src in sources]
        seed = int(base.integers(0, 2 ** 31))
        kw = dict(stage_size=48, expand_scale=1.5, apply_noise=True)
        got = GeometryPlanner(**kw).plan_group(sources, np.random.default_rng(seed))
        want = j_geometry.GeometryPlanner(**kw).plan_group(sources, np.random.default_rng(seed))
        for name in want.__dataclass_fields__:
            a, b = getattr(got, name), getattr(want, name)
            if isinstance(b, list):
                assert len(a) == len(b), name
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------------ the loader


def test_loader_geometry_batches(tmp_path, rng):
    d = _make_shard(tmp_path, rng)
    ds = DetectionDataset(RecordReader(d), phase="train", expand_scale=1.5, apply_noise=False,
                          apply_photometric=False)
    loader = Loader(ds, batch_size=4, transform_size=[[64, 64], [96, 96]], mean=[0.5] * 3,
                    std=[1.0] * 3, mosaic_num=[1, 4], max_gt=10, prefetch=0,
                    device_geometry=True, stage_size=72)
    batches = list(loader)
    assert len(batches) >= 1
    for b in batches:
        assert b["slots"].shape == (4, 4, 72, 72, 3) and b["slots"].dtype == np.uint8
        for k in ("src_rect", "dst_rect", "fill_rect"):
            assert b[k].shape == (4, 4, 4)
        assert b["out_size"] in ((64, 64), (96, 96))
        assert b["gt"].shape == (4, 10, 5) and (b["n_gt"] >= 0).all()
        assert b["active"].any(axis=1).all()


def test_multi_host_geometry_plan_lockstep(tmp_path, rng):
    """Per-rank batches are slices of the single-rank global batch."""
    d = _make_shard(tmp_path, rng)

    def batches(p_idx, n_proc):
        ds = DetectionDataset(RecordReader(d), phase="train", apply_noise=False,
                              apply_photometric=False)
        ld = Loader(ds, 4, [[64, 64], [96, 96]], [0.5] * 3, [1.0] * 3, mosaic_num=[1, 2],
                    max_gt=10, prefetch=0, device_geometry=True, stage_size=64, seed=3,
                    shard_by_process=True)
        ld._process_slice = lambda: (p_idx, n_proc)
        ld.epoch = 1
        return list(ld._epoch_batches())

    single, h0, h1 = batches(0, 1), batches(0, 2), batches(1, 2)
    assert len(single) == len(h0) == len(h1) > 0
    for sb, a, b in zip(single, h0, h1):
        assert a["out_size"] == b["out_size"] == sb["out_size"]
        assert a["slots"].shape[0] == b["slots"].shape[0] == 2 and sb["slots"].shape[0] == 4
        np.testing.assert_array_equal(a["gt"], sb["gt"][:2])
        np.testing.assert_array_equal(a["src_rect"], sb["src_rect"][:2])
        np.testing.assert_array_equal(a["slots"][a["active"]], sb["slots"][:2][sb["active"][:2]])


def test_geometry_seg_end_to_end(tmp_path, rng):
    """A seg shard through ``Loader(device_geometry=True)`` and the port's
    segmentation geometry step: the seg keys are there, one step runs and
    moves the parameters."""
    d = _make_shard(tmp_path, rng, n=8, seg=True)
    ds = DetectionDataset(RecordReader(d), phase="train", has_seg=True, seg_num_classes=2,
                          apply_noise=False, apply_photometric=False)
    loader = Loader(ds, batch_size=4, transform_size=[[64, 64]], mean=[0.5] * 3,
                    std=[1.0] * 3, mosaic_num=[1, 2], max_gt=10, prefetch=0,
                    device_geometry=True, stage_size=64)
    b = next(iter(loader))
    assert b["seg_slots"].shape == (4, 4, 64, 64) and b["seg_active"].shape == (4, 4)
    config = {**SMALL_YOLO_CONFIG, "seg": {"num_classes": 2}}
    torch.manual_seed(0)
    model = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, seg_num_classes=2)
    before = model.backbone.stem.conv.weight.detach().clone()
    step = make_geometry_train_step(model, config, segmentation=True)
    t = {k: torch.from_numpy(v) for k, v in b.items() if isinstance(v, np.ndarray)}
    _, metrics = step(create_train_state(model), *(t[k] for k in GEOMETRY_BATCH_KEYS),
                      t["seg_slots"], t["seg_active"], t["gt"], t["n_gt"], 5,
                      out_hw=b["out_size"])
    assert np.isfinite(float(metrics["loss"])) and "seg_obj" in metrics
    assert not torch.equal(before, model.backbone.stem.conv.weight)


def test_loader_fed_geometry_step_matches_jax(tmp_path):
    """One port ``Loader(device_geometry=True)`` batch (1-tile and 4-tile
    images, programs planned, noise off) through the port's plain geometry
    step and the JAX geometry step, float64 end to end, AdamW on both
    sides: the loss to rtol 1e-6, the params after the step to atol 1e-5,
    the BN statistics to 1e-9 (``test_geometry_step_matches_jax``'s
    tolerances). As there, the contrast steps, the hue steps and the mean
    fills are taken out of the batch (their float32 sums and the jitted hue
    round trip differ ~1e-4 of 255 between the packages; this tiny network
    turns that into 5% gradient differences)."""
    d = _make_shard(tmp_path, np.random.default_rng(1), n=10)
    ds = DetectionDataset(RecordReader(d), phase="train", apply_noise=False,
                          apply_photometric=False)
    loader = Loader(ds, batch_size=4, transform_size=[[32, 32]], mean=[0.5] * 3,
                    std=[1.0] * 3, mosaic_num=[1, 4], max_gt=8, prefetch=0,
                    device_geometry=True, seed=2)
    batch = next(iter(loader))
    tiles = batch["active"].sum(1)
    assert batch["out_size"] == (32, 32) and 1 in tiles and 4 in tiles
    assert (batch["jitter_op"] >= 0).any() and batch["n_gt"].min() > 0
    batch["jitter_op"][np.isin(batch["jitter_op"], (1, 3))] = -1
    batch["fill_from_mean"][:] = False
    variables = width035_variables64()
    with jax.enable_x64(True):
        jm, model = float64_pair(variables)
        tx = j_state.make_optimizer(7e-4, 4e-4)
        step = j_step.make_geometry_train_step(jm, SMALL_YOLO_CONFIG, tx, fused_aug=False)
        new_state, want_metrics = step(
            jax_train_state(variables, tx), *(jnp.asarray(batch[k]) for k in GEOMETRY_BATCH_KEYS),
            jnp.asarray(batch["gt"]), jnp.asarray(batch["n_gt"]), jax.random.PRNGKey(3),
            out_hw=(32, 32))
        want_loss = float(want_metrics["loss"])

    port_step = make_geometry_train_step(model, SMALL_YOLO_CONFIG, fused_aug=False,
                                         dtype=torch.float64)
    _, metrics = port_step(create_train_state(model),
                           *(torch.from_numpy(batch[k]) for k in GEOMETRY_BATCH_KEYS),
                           torch.from_numpy(batch["gt"]), torch.from_numpy(batch["n_gt"]), 3,
                           out_hw=batch["out_size"])
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-6)
    got = dict(model.named_parameters())
    for key, want in state_dict_of("params", new_state.params).items():
        np.testing.assert_allclose(got[key].detach().numpy(), want, atol=1e-5, err_msg=key)
    assert_bn_stats_match(model, new_state.batch_stats)
