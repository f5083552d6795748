"""Train and eval steps: forward, two-head YOLO loss, backward, AdamW, EMA.

Port of ``mobilenet_yolo_tpu/train/step.py`` without ``jit``: a step runs
eagerly and updates the state's model, BatchNorm statistics, optimizer
and EMA in place. ``make_geometry_train_step`` runs the whole
augmentation on the device first (noise, photometric programs, the
geometric compose), through the hand-written kernels or their plain ops.

bf16 (``dtype=torch.bfloat16``) is ``torch.autocast`` around the forward;
the heads are cast to f32 and the loss is computed in f32, as the JAX step
does under a bf16 model (``step.py:145-146``).

Under a ``mesh`` (``parallel/mesh.py``) each rank steps its rows of the
global batch: the step builders give the mesh's data group to every
BatchNorm (``layers.set_process_group``) and to the loss, so BatchNorm's
statistics and the loss's normalisers are the global batch's and each rank's loss is its share of the global
loss; the gradients are then summed over the group in one all-reduce, and
AdamW, the prox and the EMA run identically on every rank. The first call
broadcasts the state from the group's first rank. The metrics are the
global ones, equal on every rank. Under a model axis above 1 the large
output channels are split over the model group (``parallel/sharding.py``).

Network Slimming (``slim_l1`` in the config, ``step.py:32-62``):
``slim_mode: loss`` adds ``slim_l1 * prune.slim_penalty`` to the train-mode
loss and to ``metrics["loss"]``; ``slim_mode: prox`` (the default) applies
``prune.slim_prox_update`` after the optimizer step and before the EMA
update, in the plain and the geometry step alike. Under a model axis
above 1 the penalty is the whole model's on every rank of a model group,
as JAX's GSPMD sum is (``prune.slim_penalty``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.kernels.aug_compose import aug_compose
from mobilenet_yolo_tpu_torch.kernels.slot_aug import slot_aug
from mobilenet_yolo_tpu_torch.ops.anchors import scaled_anchors
from mobilenet_yolo_tpu_torch.ops.device_augment import (
    geometric_compose,
    planned_color_jitter,
    seg_compose,
    shard_seed,
    slot_noise,
)
from mobilenet_yolo_tpu_torch.models.layers import set_process_group
from mobilenet_yolo_tpu_torch.ops.losses import seg_loss, yolo_head_loss
from mobilenet_yolo_tpu_torch.parallel.mesh import all_reduce_, global_sum, group_size
from mobilenet_yolo_tpu_torch.parallel.sharding import agree_replicated_gradients, replicate
from mobilenet_yolo_tpu_torch.prune import slim_penalty, slim_prox_update
from mobilenet_yolo_tpu_torch.train.state import TrainState
from mobilenet_yolo_tpu_torch.utils.profiling import span

HEAD_KEYS = ("out0", "out1")
GEOMETRY_BATCH_KEYS = ("slots", "src_rect", "dst_rect", "fill_rect", "fill_color",
                       "fill_from_mean", "flip", "active", "noise_gate", "noise_scale",
                       "noise_per_channel", "jitter_op", "jitter_factor")
FUSED_AUG_MODES = (None, True, "split", False)


def _slim_cfg(config: dict) -> tuple[float, str]:
    """(lambda, mode) of the Network Slimming config (``step.py:32-41``):
    mode "prox" (the default) or "loss"; any other mode raises."""
    lam = float(config.get("slim_l1") or 0.0)
    mode = str(config.get("slim_mode") or "prox")
    if mode not in ("prox", "loss"):
        raise ValueError(f"slim_mode must be 'prox' or 'loss', got {mode!r}")
    return lam, mode


def _to_device(arr: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    # a pageable non_blocking copy is staged at once and does not wait for
    # the work already queued on the device
    return torch.from_numpy(arr).to(device=device, dtype=dtype, non_blocking=True)


def make_loss_fn(model: torch.nn.Module, config: dict, segmentation: bool = False,
                 normalize: bool = False, dtype: torch.dtype | None = None,
                 group=None) -> Callable:
    """``loss_fn(images, gt, n_gt, seg_maps=None, train=True) -> (loss,
    metrics)`` (``step.py:84-168``).

    images (B, H, W, 3) NHWC; with ``normalize=True`` raw [0, 255] (uint8
    or float), normalized on the device with the config's mean/std. A
    float input keeps its dtype for that only when the model computes in
    it (``dtype``), and a float64 model normalizes any input in float64;
    otherwise the normalize runs in f32 (``step.py:117-130``).
    ``dtype`` bf16 or fp16 runs the forward under ``torch.autocast``.
    ``train=True`` puts the model in train mode, so the forward uses batch
    statistics and updates the running ones; ``train=False`` in eval mode.
    The loss is f32; the metrics carry no gradient. With ``slim_mode:
    loss`` the train-mode loss carries ``slim_l1 * slim_penalty(model)``.
    ``group`` (a data-parallel step's data group, set on every BatchNorm
    of ``model`` too): each rank's loss is its share of the group's global
    loss, and the metrics are the group's, equal on every rank.
    """
    set_process_group(model, group)
    slim_l1, slim_mode = _slim_cfg(config)
    if slim_mode != "loss":
        slim_l1 = 0.0
    yolo_cfg = config["yolo"]
    anchors_px = np.asarray(yolo_cfg["anchors"], np.float32)
    masks = [list(m) for m in yolo_cfg["mask"]]
    ignore_threshs = [float(t) for t in yolo_cfg["ignore_thresh"]]
    iou_thresh = float(yolo_cfg["iou_thresh"])
    iou_weighting = float(config.get("iou_weighting", 0.01))
    num_classes = int(yolo_cfg["num_classes"])
    norm_cfg = config.get("normalize", {"mean": [0.5] * 3, "std": [1.0] * 3})
    norm_mean = np.asarray(norm_cfg["mean"], np.float32)
    norm_std = np.asarray(norm_cfg["std"], np.float32)
    # bf16 / fp16 run through autocast over f32 parameters; any other
    # dtype must be the parameters' own (e.g. float64 for exact checks)
    autocast = dtype in (torch.bfloat16, torch.float16)

    def loss_fn(images, gt, n_gt, seg_maps=None, train=True):
        device = images.device
        if normalize:
            dt = (dtype if dtype == torch.float64
                  or images.is_floating_point() and images.dtype == dtype else torch.float32)
            images = ((images.to(dt) / 255.0 - _to_device(norm_mean, device, dt))
                      / _to_device(norm_std, device, dt))
        model.train(train)
        with torch.autocast(device.type, dtype=dtype, enabled=autocast):
            outputs = model(images.permute(0, 3, 1, 2))
        # loss numerics stay f32 under bf16 compute
        outputs = {k: v.float().permute(0, 2, 3, 1) for k, v in outputs.items()}
        h, w = images.shape[1], images.shape[2]
        anchors_norm = _to_device(scaled_anchors(anchors_px, w, h), device)

        total = torch.zeros((), dtype=torch.float32, device=device)
        metrics = {}
        for i, (key, mask, ig) in enumerate(zip(HEAD_KEYS, masks, ignore_threshs)):
            hl = yolo_head_loss(outputs[key], gt, n_gt, anchors_norm, mask, num_classes,
                                ignore_thresh=ig, iou_thresh=iou_thresh,
                                iou_weighting=iou_weighting, group=group)
            total = total + hl.loss
            for mk, mv in hl.metrics.items():
                metrics[f"{mk}{i}"] = mv
        if segmentation:
            sl, s_obj, s_no_obj = seg_loss(outputs["seg"], seg_maps, group)
            total = total + sl
            metrics["seg_obj"] = s_obj
            metrics["seg_no_obj"] = s_no_obj
        if slim_l1 and train:
            # the whole model's penalty (summed over a model group's split
            # gammas); each rank of the data group carries its share, so the
            # shares sum to one penalty
            total = total + slim_l1 * slim_penalty(model) / group_size(group)
        metrics["loss"] = total.detach()
        if group is not None:
            # the losses are each rank's share of a global ratio; the other
            # metrics are global already
            keys = ["loss"] + [k for k in metrics if k.startswith(("conf_cls_loss", "iou_loss"))]
            metrics.update(zip(keys, global_sum(torch.stack([metrics[k] for k in keys]),
                                                group).unbind()))
        return total, metrics

    return loss_fn


def _ema_update(state: TrainState, ema_decay: float | None, ema_ramp: float = 2000.0) -> None:
    """EMA of the parameters after an optimizer step (``step.py:171-202``):
    ``ema = d_t * ema + (1 - d_t) * params`` with ``d_t = decay * (1 -
    exp(-t / ramp))`` over Adam's step count t (``ema_ramp=0``: constant
    decay). No-op when ``ema_decay`` is None."""
    if ema_decay is None:
        return
    if state.ema is None:
        raise ValueError("ema_decay set but state.ema is None: build the state "
                         "with create_train_state(ema=True)")
    d = float(ema_decay)
    if ema_ramp:
        d *= 1.0 - math.exp(-state.optimizer_steps() / float(ema_ramp))
    names, params = zip(*state.model.named_parameters())
    ema = [state.ema[name] for name in names]
    with torch.no_grad():
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - d)


def _data_group(mesh):
    return None if mesh is None else mesh.data_group


def _replicating(mesh) -> Callable:
    """``ensure(state)``: broadcast each new state over the mesh's data
    group once, from the group's first rank (``sharding.replicate``)."""
    seen: set = set()

    def ensure(state: TrainState) -> None:
        if mesh is not None and id(state) not in seen:
            replicate(state, mesh)
            seen.add(id(state))

    return ensure


def _reduce_gradients(model: torch.nn.Module, group) -> None:
    """Sum every parameter's gradient over ``group``, in one all-reduce."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = all_reduce_(torch._utils._flatten_dense_tensors(grads), group)
    for g, total in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(total)


def _update(state: TrainState, model: torch.nn.Module, loss_fn: Callable, images, gt, n_gt,
            seg_maps, ema_decay, ema_ramp, slim_prox: float, mesh=None):
    """One optimizer step on ``loss_fn``, then the prox shrink with strength
    ``slim_prox`` (0 = off), then the EMA, which sees the shrunk
    parameters; the gradients stay on the parameters until the next step.
    Under ``mesh`` the gradients are summed over its data group, and the
    replicated ones taken from the model group's first rank, before the
    optimizer step. Spans (``utils.profiling.span``): ``myt:loss`` (the
    forward, with the model's own spans, and the loss), ``myt:backward``
    (with the gradients' reduction) and ``myt:optimizer`` (the step, the
    prox shrink and the EMA)."""
    if state.model is not model:
        raise ValueError("the state holds another model than the step was built for")
    state.optimizer.zero_grad(set_to_none=True)
    group = _data_group(mesh)
    with span("myt:loss"):
        loss, metrics = loss_fn(images, gt, n_gt, seg_maps)
    with span("myt:backward"):
        loss.backward()
        if group is not None:
            _reduce_gradients(model, group)
        agree_replicated_gradients(model, mesh)
    with span("myt:optimizer"):
        state.optimizer.step()
        if slim_prox:
            slim_prox_update(model, state.optimizer, slim_prox)
        _ema_update(state, ema_decay, ema_ramp)
    return state, metrics


def make_train_step(model: torch.nn.Module, config: dict, segmentation: bool = False,
                    normalize: bool = False, pixel_aug: bool = False,
                    ema_decay: float | None = None, ema_ramp: float = 2000.0,
                    dtype: torch.dtype | None = None, mesh=None) -> Callable:
    """``train_step(state, images, gt, n_gt[, seg_maps][, jitter_op,
    jitter_factor]) -> (state, metrics)`` (``step.py:205-284``).

    ``pixel_aug=True`` (needs ``normalize=True``, raw images) applies the
    host-planned photometric programs ``jitter_op`` / ``jitter_factor``
    (B, 5) on the device before the forward, in ``dtype`` (default f32).
    Under ``mesh`` the arguments are this rank's rows of the global batch.
    """
    if pixel_aug and not normalize:
        raise ValueError("pixel_aug requires normalize=True (raw images)")
    loss_fn = make_loss_fn(model, config, segmentation, normalize=normalize, dtype=dtype,
                           group=_data_group(mesh))
    slim_prox = _prox_lambda(config)
    n_extra = int(segmentation) + 2 * int(pixel_aug)
    ensure_replicated = _replicating(mesh)

    def step(state: TrainState, images, gt, n_gt, *extra):
        if len(extra) != n_extra:
            raise TypeError(f"train_step takes {4 + n_extra} arguments "
                            f"(segmentation={segmentation}, pixel_aug={pixel_aug}), "
                            f"got {4 + len(extra)}")
        ensure_replicated(state)
        seg_maps = extra[0] if segmentation else None
        if pixel_aug:
            jitter_op, jitter_factor = extra[-2:]
            with span("myt:augment"):
                images = planned_color_jitter(images, jitter_op, jitter_factor,
                                              dtype=dtype or torch.float32)
        return _update(state, model, loss_fn, images, gt, n_gt, seg_maps, ema_decay, ema_ramp,
                       slim_prox, mesh)

    return step


def _prox_lambda(config: dict) -> float:
    """The prox shrink's strength: ``slim_l1`` under ``slim_mode: prox``, else 0."""
    lam, mode = _slim_cfg(config)
    return lam if mode == "prox" else 0.0


def make_eval_step(model: torch.nn.Module, config: dict, segmentation: bool = False,
                   dtype: torch.dtype | None = None, mesh=None) -> Callable:
    """``eval_step(state, images, gt, n_gt[, seg_maps]) -> metrics`` with
    the running BatchNorm statistics and no update (``step.py:424-437``);
    under ``mesh``, of this rank's rows, with the global batch's metrics."""
    loss_fn = make_loss_fn(model, config, segmentation, dtype=dtype, group=_data_group(mesh))

    @torch.no_grad()
    def step(state: TrainState, images, gt, n_gt, seg_maps=None):
        return loss_fn(images, gt, n_gt, seg_maps, train=False)[1]

    return step


def augment_geometry(geom, aug_seed: int, out_hw, mode: bool | str,
                     dtype: torch.dtype = torch.float32, mesh=None) -> torch.Tensor:
    """(B, H, W, 3) training images in [0, 255] from the ``GEOMETRY_BATCH_KEYS``
    tensors ``geom`` (``step.py:337-378``, ``device_augment.py:389-468``):
    noise, then the photometric programs, then the geometric compose.

    ``mode`` True: all three in the ``aug_compose`` kernel; ``"split"``: the
    per-slot ``slot_aug`` kernel, then the plain planar compose; False: the
    plain ops in ``dtype``. The kernel modes emit bf16 whatever ``dtype``:
    bf16 resolves [0, 255] at 0.25-1 intensity, finer than the uint8
    staging the slots come from. ``aug_seed`` keys one noise stream for
    every mode.

    Under ``mesh`` ``geom`` holds this rank's rows. The kernel modes then
    take the seed of this rank's data shard, ``shard_seed(aug_seed,
    data_index)``, on their local slots, as the JAX kernels do inside
    ``shard_map`` (``device_augment.py:445-456``); the plain mode, which
    GSPMD runs on the global batch in JAX, draws the global slots' noise
    (the slots after every lower shard's).
    """
    (slots, src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip, active,
     noise_gate, noise_scale, noise_per_channel, jitter_op, jitter_factor) = geom
    place = (src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip, active)
    shard = 0 if mesh is None else mesh.data_index
    if mode is not False:
        aug_seed = shard_seed(aug_seed, shard)
    if mode is True:
        return aug_compose(slots, aug_seed, noise_gate, noise_scale, noise_per_channel,
                           jitter_op, jitter_factor, *place, out_hw)
    if mode == "split":
        b, t, s = slots.shape[:3]
        n = b * t
        planar = slot_aug(slots.reshape(n, s, s, 3), aug_seed, noise_gate.reshape(n),
                          noise_scale.reshape(n), noise_per_channel.reshape(n),
                          jitter_op.reshape(n, -1), jitter_factor.reshape(n, -1),
                          dtype=torch.bfloat16)
        return geometric_compose(planar.reshape(b, t, 3, s, s), *place, out_hw,
                                 dtype=torch.bfloat16, planar=True)
    # noise before the programs, as the reference applies its imgaug
    # sequence before the photometric distortion (folder2lmdb.py:131-135)
    noised = slot_noise(slots, aug_seed, noise_gate, noise_scale, noise_per_channel, dtype=dtype,
                        first_slot=shard * slots.shape[0] * slots.shape[1])
    return geometric_compose(noised, *place, out_hw, jitter_op=jitter_op,
                             jitter_factor=jitter_factor, dtype=dtype)


def make_geometry_train_step(model: torch.nn.Module, config: dict, segmentation: bool = False,
                             fused_aug: bool | str | None = None,
                             ema_decay: float | None = None, ema_ramp: float = 2000.0,
                             dtype: torch.dtype | None = None, mesh=None) -> Callable:
    """Train step with the whole augmentation on the device
    (``step.py:293-421``).

    Returns ``step(state, *geom_arrays, gt, n_gt, aug_seed, out_hw=(H, W))
    -> (state, metrics)``, where ``geom_arrays`` are the
    ``GEOMETRY_BATCH_KEYS`` tensors of a ``Loader(device_geometry=True)``
    batch, followed by ``(seg_slots, seg_active)`` when ``segmentation``
    is on, and ``aug_seed`` is an int in int32 range that keys the noise
    (the counterpart of the trainer's ``fold_in`` key chain).

    ``fused_aug`` is the ``augment_geometry`` mode: ``True`` the
    ``aug_compose`` kernel, ``"split"`` the ``slot_aug`` kernel and the
    plain compose, ``False`` the plain ops, which the kernels are held
    against; ``None`` is ``True`` for CUDA tensors and ``False``
    otherwise. The kernel paths emit bf16 whatever ``dtype``
    (``step.py:346-359``); the plain path runs in ``dtype`` (default f32).
    Under ``mesh`` the arrays are this rank's rows of the global batch
    (``augment_geometry`` says which noise each mode draws).
    """
    if fused_aug not in FUSED_AUG_MODES:
        raise ValueError(f"fused_aug must be one of {FUSED_AUG_MODES}, got {fused_aug!r}")
    ensure_replicated = _replicating(mesh)
    loss_fn = make_loss_fn(model, config, segmentation=segmentation, normalize=True,
                           dtype=dtype, group=_data_group(mesh))
    slim_prox = _prox_lambda(config)
    seg_classes = int(config.get("seg", {}).get("num_classes", 0))
    aug_dtype = dtype or torch.float32
    n_geom = len(GEOMETRY_BATCH_KEYS) + 2 * int(segmentation)

    def step(state: TrainState, *args, out_hw):
        if len(args) != n_geom + 3:
            raise TypeError(f"geometry step takes the state, {n_geom} geometry arrays, "
                            f"gt, n_gt and aug_seed; got {len(args)} arrays after the state")
        geom = args[:len(GEOMETRY_BATCH_KEYS)]
        gt, n_gt, aug_seed = args[n_geom:]
        out_hw = (int(out_hw[0]), int(out_hw[1]))
        ensure_replicated(state)
        mode = geom[0].is_cuda if fused_aug is None else fused_aug
        with span("myt:augment"):
            images = augment_geometry(geom, aug_seed, out_hw, mode, dtype=aug_dtype, mesh=mesh)
            seg_maps = None
            if segmentation:
                seg_slots, seg_active = args[len(GEOMETRY_BATCH_KEYS):n_geom]
                src_rect, dst_rect, flip = geom[1], geom[2], geom[6]
                seg_maps = seg_compose(seg_slots, src_rect, dst_rect, flip, seg_active,
                                       (out_hw[0] // 16, out_hw[1] // 16), seg_classes)
        return _update(state, model, loss_fn, images, gt, n_gt, seg_maps, ema_decay, ema_ramp,
                       slim_prox, mesh)

    return step
