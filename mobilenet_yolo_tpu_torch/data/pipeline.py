"""Online training input pipeline (port of ``mobilenet_yolo_tpu/data/pipeline.py``).

The counterpart of ``ImageFolderLMDB`` + ``GreedyBatchSampler`` + torch
DataLoader (reference folder2lmdb.py:56-265, CustomBatchSampler.py:9-85,
train.py:110-121): record decode, pixel noise + SSD augmentations, mosaic
group composition, per-batch multiscale resize, normalization, fixed-size
GT padding and /16 segmentation-map rasterization — all on host numpy with
a background prefetch thread (the card's step overlaps with it).

Batches are dicts of fixed-shape numpy arrays ready for the train step:
``images (B,H,W,3) f32``, ``gt (B,T,5)``, ``n_gt (B,)``,
``seg_maps (B,H/16,W/16,C)`` when segmentation is on.
:func:`batch_to_device` moves one to the card.

Where the port differs from the JAX module:
* the rank seam: ``shard_by_process`` reads ``torch.distributed``'s rank
  and world size (0 and 1 when it is not initialised), where JAX reads
  ``jax.process_index()`` / ``process_count()``;
* an exception while a batch is built on the prefetch thread is handed to
  the consumer and raised there; the JAX loader ends the epoch early
  without a word.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

import torch

from mobilenet_yolo_tpu_torch.data import augment
from mobilenet_yolo_tpu_torch.data.geometry import MAX_TILES, GeometryPlanner
from mobilenet_yolo_tpu_torch.data.mosaic import group_indices, mosaic
from mobilenet_yolo_tpu_torch.data.records import RecordReader

MOSAIC_CANVAS = (1000, 1000)  # reference folder2lmdb.py:172


def _decode_jpeg(buf: bytes) -> np.ndarray:
    """Decoded RGB uint8 HWC."""
    import cv2
    arr = np.frombuffer(buf, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError("cannot decode image record")
    return img[..., ::-1].copy()  # BGR -> RGB


def _decode_seg(buf: bytes) -> np.ndarray:
    """Decode a segmentation PNG to a 2-D class-id map.

    The reference reads class-id maps directly (folder2lmdb.py:106). A
    single-channel PNG is used as-is; a 3-channel PNG must carry the id
    replicated across channels (grayscale conversion of a palette-expanded
    id map would silently mangle ids, so that case asserts instead).
    """
    import cv2
    arr = np.frombuffer(buf, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError("cannot decode segmentation record")
    if img.ndim == 2:
        return img
    if not (img[..., :1] == img[..., 1:]).all():
        # data validation must survive python -O, so no assert here
        raise ValueError(
            "3-channel seg PNG is not a replicated class-id map; rebuild "
            "the dataset with single-channel id maps (palette PNGs are "
            "not ids)")
    return img[..., 0]


def _resize(img: np.ndarray, w: int, h: int, area: bool = False) -> np.ndarray:
    import cv2
    interp = cv2.INTER_AREA if area else cv2.INTER_LINEAR
    return cv2.resize(img, (w, h), interpolation=interp)


class DetectionDataset:
    """Decode + augment a single record (folder2lmdb.py:78-154)."""

    def __init__(self, reader: RecordReader, phase: str = "train",
                 expand_scale: float = 1.5, has_seg: bool = False,
                 seg_num_classes: int = 0, apply_noise: bool = True,
                 apply_photometric: bool = True):
        # apply_noise/apply_photometric=False move the pixelwise ops to the
        # device (ops/device_augment.py via make_train_step(pixel_aug=True))
        self.reader = reader
        self.phase = phase
        self.expand_scale = expand_scale
        self.has_seg = has_seg
        self.seg_num_classes = seg_num_classes
        self.apply_noise = apply_noise
        self.apply_photometric = apply_photometric

    def __len__(self):
        return len(self.reader)

    def decode_source(self, index: int):
        """Decode one record: (image uint8 HWC RGB, boxes px corners (n,4),
        cls (n,), difficulties (n,), seg id-map or None). No augmentation."""
        rec = self.reader[index]
        img = _decode_jpeg(rec.image_bytes)
        seg = _decode_seg(rec.seg_bytes) if (self.has_seg and rec.seg_bytes) else None

        h, w = img.shape[:2]
        labels = rec.labels
        if labels.shape[0]:
            cx, cy, bw, bh = (labels[:, 1], labels[:, 2], labels[:, 3], labels[:, 4])
            boxes = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                              (cx + bw / 2) * w, (cy + bh / 2) * h], -1)
        else:
            boxes = np.zeros((0, 4), np.float32)
        cls = labels[:, 0] if labels.shape[0] else np.zeros((0,), np.float32)
        difficulties = (labels[:, 5] if labels.shape[0]
                        else np.zeros((0,), np.float32))
        return img, boxes.astype(np.float32), cls, difficulties, seg

    def get_single(self, index: int, rng: np.random.Generator,
                   allow_expand: bool = True):
        """Returns (image uint8 HWC RGB, labels (n,6) normalized
        (cls,cx,cy,w,h,difficult), seg class-id map or None)."""
        img, boxes, cls, difficulties, seg = self.decode_source(index)

        if self.phase == "train" and self.apply_noise:
            img = augment.pixel_noise(img, rng)
        img, boxes, cls, difficulties, seg = augment.transform_od(
            img, boxes, cls, difficulties, rng,
            mean=(0.5, 0.5, 0.5), phase=self.phase,
            allow_expand=allow_expand, expand_scale=self.expand_scale,
            seg=seg, photometric=self.apply_photometric)

        nh, nw = img.shape[:2]
        if boxes.shape[0]:
            bw = (boxes[:, 2] - boxes[:, 0]) / nw
            bh = (boxes[:, 3] - boxes[:, 1]) / nh
            cx = boxes[:, 0] / nw + bw / 2
            cy = boxes[:, 1] / nh + bh / 2
            rows = np.stack([cls, cx, cy, bw, bh, difficulties],
                            -1).astype(np.float32)
        else:
            rows = np.zeros((0, 6), np.float32)
        return img, rows, seg

    def get_group(self, indices: list[int], rng: np.random.Generator):
        """Group of 1 -> plain sample; group of N -> mosaic composite
        (folder2lmdb.py:155-177; expand only for singles)."""
        if len(indices) == 1:
            img, rows, seg = self.get_single(indices[0], rng, allow_expand=True)
            return img, rows, seg, 1
        items = []
        for idx in indices:
            img, rows, _ = self.get_single(idx, rng, allow_expand=False)
            items.append((img, rows))
        img, rows = mosaic(items, MOSAIC_CANVAS, rng)
        return img, rows, None, len(indices)


class Loader:
    """Batched iterator with mosaic grouping, multiscale collate and
    optional background prefetch."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 transform_size, mean, std, mosaic_num=(1,),
                 max_gt: int = 90, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2,
                 pad_final: bool = True, shard_by_process: bool | None = None,
                 output_uint8: bool = False, device_geometry: bool = False,
                 stage_size: int | None = None,
                 process_slice: tuple[int, int] | None = None):
        # pad_final keeps every batch at exactly batch_size samples by
        # wrapping indices on the final partial batch, so the card's step
        # sees one batch shape per bucket (the JAX step compiles one
        # program per (batch, H, W)). Semantically a no-op for training
        # (an epoch sees a handful of duplicate samples).
        #
        # shard_by_process (auto-on when torch.distributed runs more than
        # one rank): every rank derives the identical deterministic epoch
        # plan (groups + per-batch image size) and takes its contiguous
        # slice of each global batch's groups — all ranks feed the same
        # step with the same (H, W), so their collectives stay in lockstep.
        # process_slice (index, count) names the slice where it is not the
        # rank's (under tensor parallelism the ranks of a model group load
        # the same rows: their data index of the data axis).
        self.ds = dataset
        self.batch_size = batch_size
        self.transform_size = [tuple(s) for s in transform_size]
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.mosaic_num = list(mosaic_num)
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_final = pad_final
        # output_uint8: emit raw [0,255] uint8 batches and let the jitted
        # step normalize on device (make_train_step(normalize=True) /
        # make_predict_fn(normalize=True)). Saves the two host float passes
        # per image (the single biggest collate cost on a 1-core host) and
        # 4x of the host->device transfer.
        self.output_uint8 = output_uint8
        # device_geometry: the host only decodes and stages each source on a
        # fixed square; ALL pixel augmentation (expand/crop/flip/mosaic
        # composition, color jitter, normalization) runs inside the jitted
        # train step (data/geometry.py + ops/device_augment.py). Batches
        # then carry staged source slots + compose parameters instead of
        # composed images; pair with train/step.py:make_geometry_train_step.
        self.device_geometry = device_geometry
        if device_geometry:
            assert dataset.phase == "train", \
                "device_geometry is a train-time path (test is identity)"
            # stage_size None = adaptive: stage each batch's sources at its
            # output resolution (same effective resolution as the host
            # path, ~40% fewer host->device bytes than a fixed 448)
            # fill color is the FIXED 0.5 gray of the host transform chain
            # (get_single -> transform_od(mean=(0.5, 0.5, 0.5)), mirroring
            # reference folder2lmdb.py:135) — NOT the config's normalize
            # mean, which may differ (e.g. ImageNet) and would silently
            # diverge the device path's expand filler from the host path
            # photometric runs on device whenever the host dataset is not
            # applying it (the normal geometry-mode config): the planner
            # samples each source's op order + factors host-side
            self.planner = GeometryPlanner(
                stage_size=stage_size, expand_scale=dataset.expand_scale,
                mean=(0.5, 0.5, 0.5), apply_noise=dataset.apply_noise,
                apply_photometric=not dataset.apply_photometric)
            # ring of reusable slot buffers: fresh 4*S^2*3-per-sample
            # allocations fault in new kernel pages every batch (~200 ms
            # at this host's 0.4 GB/s); recycling buffers makes the write
            # a plain ~20 ms memcpy. One ring of MAX-size flat byte
            # buffers serves every staged shape (reshaped views), so
            # multiscale does not multiply resident memory. Ring depth
            # covers the prefetch queue + the consumer's batch + one
            # async in-flight transfer (the trainer drains metrics one
            # batch late) + the buffer being filled; image and seg
            # buffers draw from the same ring (two entries per batch).
            # Subclasses whose batches outlive this accounting
            # (WorkerLoader's batches cross processes) must set
            # _use_slot_ring = False to get fresh arrays instead.
            self._use_slot_ring = True
            smax = stage_size or max(max(w, h)
                                     for w, h in self.transform_size)
            self._ring_cap = (batch_size * MAX_TILES * smax * smax * 3)
            self._ring: list = []
            self._ring_idx = 0
            self._ring_depth = (max(4, prefetch + 3)
                                * (2 if dataset.has_seg else 1))
        # fused host normalization: x*scale + bias == ((x/255) - mean)/std
        self._scale = (1.0 / (255.0 * self.std)).astype(np.float32)
        self._bias = (-self.mean / self.std).astype(np.float32)
        if shard_by_process is None:
            shard_by_process = _distributed_slice()[1] > 1
        self.shard_by_process = shard_by_process
        self.process_slice = process_slice
        self.epoch = 0
        self._skip_batches = 0

    # --------------------------------------------------- resume plumbing --
    # The epoch plan is a pure function of (seed, epoch) and each batch's
    # augmentation rng is keyed by its batch INDEX, so mid-epoch resume is
    # exact: set_epoch aligns the plan with the interrupted run and
    # set_skip drops the already-consumed plan entries without decoding
    # them — the remaining batches are bit-for-bit the ones the
    # uninterrupted run would have produced (tests/test_torch_data.py).

    def set_epoch(self, epoch: int) -> None:
        """Align the internal epoch counter so the NEXT iteration derives
        the plan the uninterrupted run would use for training epoch
        ``epoch`` (the Trainer calls this every epoch; __iter__ advances
        the counter first, so pass the 0-based training epoch)."""
        self.epoch = int(epoch)

    def set_skip(self, n_batches: int) -> None:
        """Skip the first ``n_batches`` plan entries of the NEXT iteration
        (one-shot). Skipped batches are never decoded."""
        self._skip_batches = int(n_batches)

    def _process_slice(self) -> tuple[int, int]:
        """(index, count) of this process's slice of each batch: its rank and
        the world size unless ``process_slice`` says otherwise."""
        if not self.shard_by_process:
            return 0, 1
        return self.process_slice if self.process_slice is not None else _distributed_slice()

    def __len__(self):
        # progress counted in raw images, like the reference sampler
        # (CustomBatchSampler.py:76-81) — this host's share of them
        _, n_proc = self._process_slice()
        return len(self.ds) // n_proc

    def _epoch_plan(self, rng: np.random.Generator) -> list:
        """Deterministic full-epoch plan: [(batch_groups, size_idx), ...].

        Derived identically on every host from the shared seed; sample
        decode/augmentation randomness is applied later per batch and does
        not need cross-host agreement."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        plan = []
        if self.ds.phase == "train":
            for batch_groups in group_indices(order, self.batch_size,
                                              self.mosaic_num, rng,
                                              self.drop_last):
                if self.pad_final and len(batch_groups) < self.batch_size:
                    n_pad = self.batch_size - len(batch_groups)
                    batch_groups = batch_groups + [
                        [int(order[int(rng.integers(0, len(order)))])]
                        for _ in range(n_pad)]
                size_idx = int(rng.integers(0, len(self.transform_size)))
                plan.append((batch_groups, size_idx))
        else:
            for i in range(0, len(order), self.batch_size):
                idx = order[i:i + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                plan.append(([[int(j)] for j in idx], 0))
        return plan

    def _collate(self, samples, size_idx: int,
                 rng: np.random.Generator | None = None) -> dict:
        """Resize to the planned size, normalize+stack, GT pad, seg
        rasterize (folder2lmdb.py:223-265).

        When the dataset skips host photometric (``--device-pixel-aug``),
        ``rng`` plans each image's photometric program here (op order +
        gates + factors via augment.sample_photometric — the host path's
        own sampler) and the batch carries ``jitter_op``/``jitter_factor``
        for the device to apply in planned order."""
        w, h = self.transform_size[size_idx]
        seg_w, seg_h = w // 16, h // 16
        images = np.empty((len(samples), h, w, 3),
                          np.uint8 if self.output_uint8 else np.float32)
        gt = np.zeros((len(samples), self.max_gt, 5), np.float32)
        gt_difficult = np.zeros((len(samples), self.max_gt), np.float32)
        n_gt = np.zeros((len(samples),), np.int32)
        seg_maps = None
        if self.ds.has_seg:
            seg_maps = np.zeros((len(samples), seg_h, seg_w,
                                 self.ds.seg_num_classes), np.float32)
        count = 0
        for i, (img, rows, seg, n_src) in enumerate(samples):
            resized = _resize(img, w, h)
            if self.output_uint8:
                images[i] = resized
            else:
                # fused two-pass normalize into the batch slot (no
                # intermediate temporaries; ~20x less host float traffic
                # than the naive ((x/255)-mean)/std chain)
                np.multiply(resized, self._scale, out=images[i],
                            casting="unsafe")
                images[i] += self._bias
            n = min(rows.shape[0], self.max_gt)
            gt[i, :n] = rows[:n, :5]
            gt_difficult[i, :n] = rows[:n, 5]
            n_gt[i] = n
            count += n_src
            if seg_maps is not None and seg is not None:
                for c in range(1, self.ds.seg_num_classes + 1):
                    mask = (seg == c).astype(np.float32) * 255.0
                    seg_maps[i, ..., c - 1] = _resize(mask, seg_w, seg_h,
                                                      area=True) / 255.0
        batch = {"images": images, "gt": gt, "n_gt": n_gt, "count": count,
                 "gt_difficult": gt_difficult}
        if seg_maps is not None:
            batch["seg_maps"] = seg_maps
        if (rng is not None and self.ds.phase == "train"
                and not self.ds.apply_photometric):
            jop = np.empty((len(samples), 5), np.int32)
            jfac = np.empty((len(samples), 5), np.float32)
            for i in range(len(samples)):
                jop[i], jfac[i] = augment.sample_photometric(rng)
            batch["jitter_op"] = jop
            batch["jitter_factor"] = jfac
        return batch

    def _collate_geometry(self, plans, size_idx: int) -> dict:
        """Stack GroupPlans into fixed-shape compose-parameter arrays."""
        w, h = self.transform_size[size_idx]
        s = plans[0].staged[0].shape[0]
        slots = self._slot_buffer((len(plans), MAX_TILES, s, s, 3))
        for i, p in enumerate(plans):
            for k, img in enumerate(p.staged):
                slots[i, k] = img
        seg_slots = None
        if self.ds.has_seg:
            seg_slots = self._slot_buffer((len(plans), MAX_TILES, s, s))
            for i, p in enumerate(plans):
                for k, seg in enumerate(p.seg_staged):
                    seg_slots[i, k] = seg
        batch = {
            "slots": slots,
            "src_rect": np.stack([p.src_rect for p in plans]),
            "dst_rect": np.stack([p.dst_rect for p in plans]),
            "fill_rect": np.stack([p.fill_rect for p in plans]),
            "fill_color": np.stack([p.fill_color for p in plans]),
            "fill_from_mean": np.stack([p.fill_from_mean for p in plans]),
            "flip": np.stack([p.flip for p in plans]),
            "active": np.stack([p.active for p in plans]),
            "noise_gate": np.stack([p.noise_gate for p in plans]),
            "noise_scale": np.stack([p.noise_scale for p in plans]),
            "noise_per_channel": np.stack([p.noise_per_channel
                                           for p in plans]),
            "jitter_op": np.stack([p.jitter_op for p in plans]),
            "jitter_factor": np.stack([p.jitter_factor for p in plans]),
            "out_size": (h, w),
        }
        if seg_slots is not None:
            batch["seg_slots"] = seg_slots
            batch["seg_active"] = np.stack([p.seg_active for p in plans])
        gt = np.zeros((len(plans), self.max_gt, 5), np.float32)
        gt_difficult = np.zeros((len(plans), self.max_gt), np.float32)
        n_gt = np.zeros((len(plans),), np.int32)
        count = 0
        for i, p in enumerate(plans):
            n = min(p.labels.shape[0], self.max_gt)
            gt[i, :n] = p.labels[:n, :5]
            gt_difficult[i, :n] = p.labels[:n, 5]
            n_gt[i] = n
            count += int(p.active.sum())
        batch.update(gt=gt, gt_difficult=gt_difficult, n_gt=n_gt,
                     count=count)
        return batch

    def _slot_buffer(self, shape) -> np.ndarray:
        """Uninitialized uint8 buffer of ``shape`` (unused slots are
        masked out on device) — a reshaped view of a recycled max-size
        flat buffer, or a fresh array when ring reuse is unsafe."""
        n = int(np.prod(shape))
        if not self._use_slot_ring:
            return np.empty(shape, np.uint8)
        assert n <= self._ring_cap, (shape, self._ring_cap)
        if len(self._ring) < self._ring_depth:
            self._ring.append(np.empty(self._ring_cap, np.uint8))
        self._ring_idx = (self._ring_idx + 1) % len(self._ring)
        return self._ring[self._ring_idx][:n].reshape(shape)

    def _sharded_plan(self) -> tuple[list, int]:
        """This rank's slice of the epoch plan; returns (plan, rank).

        Data parallelism feeds each step ONE global batch sharded across
        ranks, so every rank takes its contiguous slice of the groups of
        the SAME plan entry — step counts and per-step (H, W) sizes agree
        by construction. Training only; evaluation loaders read the full
        set on every rank, so every rank sees identical metrics.
        """
        rng = np.random.default_rng(self.seed + self.epoch)
        plan = self._epoch_plan(rng)
        p_idx, n_proc = self._process_slice()
        if n_proc > 1 and self.ds.phase == "train":
            if self.batch_size % n_proc:
                raise ValueError(f"global batch {self.batch_size} not "
                                 f"divisible by {n_proc} ranks")
            local = self.batch_size // n_proc
            plan = [(groups[p_idx * local:(p_idx + 1) * local], size_idx)
                    for groups, size_idx in plan]
        return plan, p_idx

    def _remaining_plan(self) -> tuple[list, int]:
        """This epoch's ``[(batch_idx, (groups, size_idx)), ...]`` past the
        one-shot skip, and the rank."""
        plan, p_idx = self._sharded_plan()
        skip, self._skip_batches = self._skip_batches, 0
        return list(enumerate(plan))[skip:], p_idx

    def _build_batch(self, batch_idx: int, batch_groups, size_idx: int,
                     p_idx: int, epoch: int) -> dict:
        """Decode, augment and collate one plan entry."""
        # per-batch rng: independent of how many batches other ranks or
        # earlier batches consumed
        b_rng = np.random.default_rng((self.seed, epoch, p_idx, batch_idx))
        if self.device_geometry:
            w, h = self.transform_size[size_idx]
            stage = self.planner.stage_size or max(w, h)
            plans = [self.planner.plan_group(
                [self.ds.decode_source(i)[:5 if self.ds.has_seg else 4]
                 for i in g], b_rng,
                stage=stage)
                for g in batch_groups]
            return self._collate_geometry(plans, size_idx)
        samples = [self.ds.get_group(g, b_rng) for g in batch_groups]
        return self._collate(samples, size_idx, rng=b_rng)

    def _epoch_batches(self) -> Iterator[dict]:
        entries, p_idx = self._remaining_plan()
        for batch_idx, (batch_groups, size_idx) in entries:
            yield self._build_batch(batch_idx, batch_groups, size_idx, p_idx,
                                    self.epoch)

    def __iter__(self) -> Iterator[dict]:
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._epoch_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()

        def producer():
            try:
                for b in self._epoch_batches():
                    q.put(b)
            except Exception as exc:  # raised again on the consumer's side
                q.put(exc)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, Exception):
                t.join()
                raise item
            yield item
        t.join()


def _distributed_slice() -> tuple[int, int]:
    """(rank, world size) from ``torch.distributed``; (0, 1) when it is
    not initialised."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def batch_to_device(batch: dict, device) -> dict:
    """A loader batch's arrays as tensors on ``device``, copied out of the
    loader's buffers (other entries, such as ``out_size`` and ``count``,
    as they are).

    On a CUDA device each array is first copied into fresh page-locked
    memory, and the copy to the card is queued from there without waiting
    for it. The loader's buffers are free again once this returns: the
    slot ring (``Loader._slot_buffer``) may refill them while the copies
    run, and PyTorch's pinned-memory cache keeps each page-locked block
    until the copy out of it has finished.
    """
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(v)
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device, copy=True)
    return out
