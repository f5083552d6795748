"""Host-side geometry *planning* for device-side augmentation (port of
``mobilenet_yolo_tpu/data/geometry.py``, a copy).

Training-time image transforms run on the device. The split implemented
here: the host samples every random **parameter** and does all **label**
math (tiny — a few dozen boxes) with the exact distributions of the
reference pipeline (utils/image_augmentation.py:14-166 expand/crop/flip,
:199-278 mosaic, CustomBatchSampler.py group sizes), while all **pixel**
work — expand/crop resampling, flip, mosaic composition, color jitter,
normalization — runs on the card (train/step.py:augment_geometry: the
aug_compose or slot_aug kernel, or ops/device_augment.py's plain ops). The
host touches pixels only to JPEG-decode and to resize each source once
onto a fixed ``stage_size`` square staging canvas.

Parameter/label parity with the host pixel path is by construction: the
samplers (augment.sample_expand / sample_crop / flip_boxes,
mosaic.plan_mosaic_placement / remap_mosaic_labels) are the SAME functions
the host path calls, invoked in the same order, so identical rng streams
produce identical geometry and identical labels (tested in
tests/test_torch_geometry.py).

Documented fidelity deltas vs the host path (pixels only, never labels):
* sources are resampled from the ``stage_size`` staging copy instead of the
  native image — a slight extra blur for natives much larger than the
  staging canvas (VOC natives are ~500x375, staging default 448: ~none);
* pixel noise (blur/median/sharpen/noise, data/augment.py:pixel_noise) is
  applied to the staged copy, so kernel radii are relative to the staged
  resolution;
* tile edges are bilinear-resampled (edge-clamped) rather than hard
  integer slices — a sub-pixel boundary difference.

Each planned output image is described by up to 4 tiles. A tile is:
``slot`` (index into the group's staged sources), ``src_rect`` (normalized
window in the — possibly flipped — source), ``dst_rect`` (normalized
placement in the output canvas), ``fill_rect`` + fill color (painted before
the paste), ``flip``. Rect coordinates are [x1, y1, x2, y2] in [0, 1].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mobilenet_yolo_tpu_torch.data import augment
from mobilenet_yolo_tpu_torch.data.mosaic import (plan_mosaic_placement,
                                                  remap_mosaic_labels)

MAX_TILES = 4


def _mirror_x(rect: np.ndarray) -> np.ndarray:
    return np.asarray([1.0 - rect[2], rect[1], 1.0 - rect[0], rect[3]],
                      np.float32)


@dataclass
class GroupPlan:
    """Device-compose parameters for one output image (fixed MAX_TILES)."""
    staged: list             # n_active staged (S, S, 3) uint8 sources; the
    #                          collate writes them into slot 0..n-1 of the
    #                          batch array (unused slots stay uninitialized
    #                          — the compose masks them out)
    src_rect: np.ndarray     # (MAX_TILES, 4) f32
    dst_rect: np.ndarray     # (MAX_TILES, 4) f32
    fill_rect: np.ndarray    # (MAX_TILES, 4) f32
    fill_color: np.ndarray   # (MAX_TILES, 3) f32 raw [0,255]
    fill_from_mean: np.ndarray  # (MAX_TILES,) bool: device uses src-region mean
    flip: np.ndarray         # (MAX_TILES,) bool
    active: np.ndarray       # (MAX_TILES,) bool
    noise_gate: np.ndarray   # (MAX_TILES,) bool: device adds gaussian noise
    noise_scale: np.ndarray  # (MAX_TILES,) f32 noise stddev in [0, 255] units
    noise_per_channel: np.ndarray  # (MAX_TILES,) bool
    jitter_op: np.ndarray    # (MAX_TILES, 5) int32 photometric program
    #                          (op id per step, -1 = identity; device
    #                          applies in this host-shuffled order)
    jitter_factor: np.ndarray  # (MAX_TILES, 5) f32 factors (hue: delta)
    labels: np.ndarray       # (n, 6) normalized (cls, cx, cy, w, h, difficult)
    seg_staged: list | None = None  # staged (S, S) uint8 id maps (singles)
    seg_active: np.ndarray | None = None  # (MAX_TILES,) bool

    @property
    def slots(self) -> np.ndarray:
        """(MAX_TILES, S, S, 3) uint8 view for tests/standalone compose."""
        s = self.staged[0].shape[0]
        out = np.zeros((MAX_TILES, s, s, 3), np.uint8)
        for k, img in enumerate(self.staged):
            out[k] = img
        return out


def plan_source_geometry(h: int, w: int, boxes: np.ndarray, cls: np.ndarray,
                         diff: np.ndarray, rng: np.random.Generator,
                         expand_scale: float, allow_expand: bool):
    """Sample expand(p=.5) -> crop -> flip(p=.5) for one source — the
    transform_od chain (reference :279-334) without pixels.

    Returns ``(src_rect, dst_rect, flip, (crop_w, crop_h), rows)`` where
    rects are normalized (mirrored into flipped coordinates when flip) and
    ``rows`` are the surviving (cls, cx, cy, bw, bh, difficult) labels
    normalized to the cropped output."""
    # expand gate: rng.random() is drawn regardless of allow_expand, like
    # the host path's short-circuit `rng.random() < 0.5 and allow_expand`
    do_expand = rng.random() < 0.5 and allow_expand
    if do_expand:
        new_h, new_w, top, left = augment.sample_expand(h, w, expand_scale,
                                                        rng)
        boxes = boxes + np.asarray([left, top, left, top], np.float32)
    else:
        new_h, new_w, top, left = h, w, 0, 0

    crop, keep = augment.sample_crop(new_h, new_w, boxes, rng)
    if crop is None:
        crop = (0, 0, new_w, new_h)
        nb = boxes.copy()
        kcls, kdiff = cls, diff
    else:
        nb = augment.crop_boxes(boxes, crop, keep)
        kcls = cls[keep] if keep is not None else cls
        kdiff = diff[keep] if keep is not None else diff
    cl, ct, cr, cb = crop
    cw, ch = cr - cl, cb - ct

    flip = rng.random() < 0.5
    if flip and nb.shape[0]:
        nb = augment.flip_boxes(nb, cw)

    # visible part of the source inside the crop window (canvas coords)
    vx1, vy1 = max(cl, left), max(ct, top)
    vx2, vy2 = min(cr, left + w), min(cb, top + h)
    src = np.asarray([(vx1 - left) / w, (vy1 - top) / h,
                      (vx2 - left) / w, (vy2 - top) / h], np.float32)
    dst = np.asarray([(vx1 - cl) / cw, (vy1 - ct) / ch,
                      (vx2 - cl) / cw, (vy2 - ct) / ch], np.float32)
    if flip:
        src = _mirror_x(src)
        dst = _mirror_x(dst)

    if nb.shape[0]:
        bw = (nb[:, 2] - nb[:, 0]) / cw
        bh = (nb[:, 3] - nb[:, 1]) / ch
        cx = nb[:, 0] / cw + bw / 2
        cy = nb[:, 1] / ch + bh / 2
        rows = np.stack([kcls, cx, cy, bw, bh, kdiff], -1).astype(np.float32)
    else:
        rows = np.zeros((0, 6), np.float32)
    return src, dst, bool(flip), (cw, ch), rows


class GeometryPlanner:
    """Plans device-compose batches from decoded records.

    ``stage_size``: staging square for the sources. 0/None = adaptive —
    each batch stages at its output resolution, which matches the host
    path's effective source resolution (it crops the native image and
    resizes to the output anyway) while shipping ~40% fewer bytes to the
    device than a fixed 448 square.
    """

    def __init__(self, stage_size: int | None = 448,
                 expand_scale: float = 1.5,
                 mean=(0.5, 0.5, 0.5), apply_noise: bool = True,
                 apply_photometric: bool = True,
                 mosaic_canvas=(1000, 1000)):
        self.stage_size = int(stage_size or 0)
        self.expand_scale = float(expand_scale)
        self.mean = np.asarray(mean, np.float32)
        self.apply_noise = apply_noise
        # photometric planning: sample the per-source op ORDER + gates +
        # factors here (augment.sample_photometric — the host pixel path's
        # own sampler, drawn at the exact position transform_od draws them:
        # after pixel noise, before the expand gate) and apply them on
        # device (ops/device_augment.py:planned_color_jitter). This gives
        # the device path the reference's shuffled-order distribution,
        # not the fixed-order simplification of the standalone color_jitter.
        self.apply_photometric = apply_photometric
        self.mosaic_canvas = tuple(mosaic_canvas)

    def _stage(self, img: np.ndarray, rng: np.random.Generator, plan,
               k: int, s: int) -> None:
        """One host resize to the staging square, staged blur/sharpen and
        deferred additive-noise params (applied on device) into slot k."""
        import cv2
        staged = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        if self.apply_noise:
            staged, deferred = augment.pixel_noise(staged, rng,
                                                   defer_noise=True)
            if deferred is not None:
                plan.noise_gate[k] = True
                plan.noise_scale[k] = deferred[0]
                plan.noise_per_channel[k] = deferred[1]
        plan.staged.append(staged)

    def _empty(self) -> GroupPlan:
        t = MAX_TILES
        return GroupPlan(
            staged=[],
            src_rect=np.tile(np.asarray([0, 0, 1, 1], np.float32), (t, 1)),
            dst_rect=np.tile(np.asarray([0, 0, 1, 1], np.float32), (t, 1)),
            fill_rect=np.zeros((t, 4), np.float32),
            fill_color=np.zeros((t, 3), np.float32),
            fill_from_mean=np.zeros((t,), bool),
            flip=np.zeros((t,), bool),
            active=np.zeros((t,), bool),
            noise_gate=np.zeros((t,), bool),
            noise_scale=np.zeros((t,), np.float32),
            noise_per_channel=np.zeros((t,), bool),
            jitter_op=np.full((t, 5), -1, np.int32),
            jitter_factor=np.ones((t, 5), np.float32),
            labels=np.zeros((0, 6), np.float32),
            seg_staged=[],
            seg_active=np.zeros((t,), bool),
        )

    def plan_group(self, sources, rng: np.random.Generator,
                   stage: int | None = None) -> GroupPlan:
        """``sources``: list of ≤4 decoded records ``(image_u8, boxes_px,
        cls, difficult)`` with boxes as pixel corners in the native image.
        Group of 1 -> expand/crop/flip single; group of N -> per-source
        crop/flip + mosaic placement (folder2lmdb.py:155-177 semantics:
        expand only for singles). ``stage`` overrides the staging square
        (adaptive mode)."""
        assert 1 <= len(sources) <= MAX_TILES
        s = int(stage or self.stage_size)
        assert s > 0, "adaptive staging needs an explicit per-batch size"
        plan = self._empty()
        if len(sources) == 1:
            img, boxes, cls, diff = sources[0][:4]
            seg = sources[0][4] if len(sources[0]) > 4 else None
            h, w = img.shape[:2]
            # draw order matches DetectionDataset.get_single: noise first,
            # then transform_od's photometric, then the geometric gates
            self._stage(img, rng, plan, 0, s)
            if self.apply_photometric:
                plan.jitter_op[0], plan.jitter_factor[0] = \
                    augment.sample_photometric(rng)
            if seg is not None:
                import cv2
                # NEAREST keeps class ids intact; same tile rects apply
                plan.seg_staged.append(cv2.resize(
                    seg, (s, s), interpolation=cv2.INTER_NEAREST))
                plan.seg_active[0] = True
            src, dst, flip, _, rows = plan_source_geometry(
                h, w, boxes, cls, diff, rng, self.expand_scale,
                allow_expand=True)
            plan.src_rect[0] = src
            plan.dst_rect[0] = dst
            plan.fill_rect[0] = np.asarray([0, 0, 1, 1], np.float32)
            plan.fill_color[0] = self.mean * 255.0
            plan.flip[0] = flip
            plan.active[0] = True
            plan.labels = rows
            return plan

        per_source = []
        shapes = []
        # mosaic groups carry no segmentation, like the host path
        # (folder2lmdb.py:155-177: get_group returns seg None for groups)
        for k, src in enumerate(sources):
            img, boxes, cls, diff = src[:4]
            h, w = img.shape[:2]
            self._stage(img, rng, plan, k, s)
            if self.apply_photometric:
                plan.jitter_op[k], plan.jitter_factor[k] = \
                    augment.sample_photometric(rng)
            src, dst, flip, (cw, ch), rows = plan_source_geometry(
                h, w, boxes, cls, diff, rng, self.expand_scale,
                allow_expand=False)
            per_source.append((src, flip, rows))
            shapes.append((ch, cw))

        W, H = self.mosaic_canvas
        placements = plan_mosaic_placement(shapes, self.mosaic_canvas, rng)
        all_rows = [np.zeros((0, 6), np.float32)]
        for k, ((src, flip, rows), placement) in enumerate(
                zip(per_source, placements)):
            tile, offset_x, offset_y, width, height = placement
            x1 = tile[0] + offset_x
            y1 = tile[1] + offset_y
            x2 = min(tile[2], x1 + width)
            y2 = min(tile[3], y1 + height)
            # the paste never truncates (offsets are bounded by the ar
            # clamp), so the tile shows the whole cropped source; fx/fy
            # guard the general case anyway
            fx = (x2 - x1) / width
            fy = (y2 - y1) / height
            sw, sh = src[2] - src[0], src[3] - src[1]
            plan.src_rect[k] = np.asarray(
                [src[0], src[1], src[0] + fx * sw, src[1] + fy * sh],
                np.float32)
            plan.dst_rect[k] = np.asarray(
                [x1 / W, y1 / H, x2 / W, y2 / H], np.float32)
            plan.fill_rect[k] = np.asarray(
                [tile[0] / W, tile[1] / H, tile[2] / W, tile[3] / H],
                np.float32)
            # reference fills the tile with the mean of the (jittered)
            # resized source (:268): the device computes it from the
            # jittered slot's src region
            plan.fill_from_mean[k] = True
            plan.flip[k] = flip
            plan.active[k] = True
            if rows.shape[0]:
                all_rows.append(remap_mosaic_labels(rows, placement,
                                                    self.mosaic_canvas))
        plan.labels = np.concatenate(all_rows, 0)
        return plan
